"""The ``classify`` kind: whole passes of ``Classifier.process_dataset``
over a pool of reads, a closed loop of one stream.

Set-up: the deployment, its database on the device (from the probe
image that the first run in a checkout builds with the program's device
build and saves under the cache), the pool from ``--seed`` as an
in-memory FASTA file, and two warm-up passes over the whole pool, more
until one leaves the classifier's ``max_runs`` as it found it.  The window runs
whole passes until ``--seconds`` have gone by; each pass's text goes to
an in-memory sink and, as the pass ends, is held against the first
pass's: only the judged records of a pass that differs are kept.  The
traffic mix's run keys: ``chunk`` (the reads a batch, ``-c``), ``pool``
and ``judged`` (reads drawn from the seed whose records are checked).

The check, once the window has closed and the classifier is freed,
compares one number, ``lines_differ``: over every pass of the window,
the judged reads whose record is not the reference's (or is missing, or
should not be there).  A pass whose text equals the first pass's counts
what the first counts.
"""

from __future__ import annotations

import gc
import json
import os
import threading
import time

import numpy as np

from .. import deploy, harness, reference, trace, traffic
from ..harness import Check, Record

WARMUP_PASSES = 2


class Sink:
    """The output file of a pass: the text as written, held in memory."""

    def __init__(self):
        self.parts = []

    def write(self, s: str) -> int:
        self.parts.append(s)
        return len(s)


class Drop:
    """An output file that keeps nothing (the warm-up's)."""

    def write(self, s: str) -> int:
        return len(s)


def _image(dep, cache_dir: str, device: str, log) -> str:
    """The probe image of the deployment's database: built by the
    program's device build on the first run in a checkout and saved under
    the cache, loaded by every later run."""
    from bonsai_tpu_torch.core.spacer import Spacer
    from bonsai_tpu_torch.db.build_device import device_lca_map
    from bonsai_tpu_torch.db.formats import Database, save_probe_image
    from bonsai_tpu_torch.taxonomy.tree import TaxTree

    img = os.path.join(cache_dir, "image")
    done = os.path.join(cache_dir, "database.json")
    if os.path.exists(done):
        return img
    t0 = time.perf_counter()
    tree = TaxTree.from_nodes_dmp(dep.nodes_path)
    sp = Spacer(dep.k, dep.k)
    table = device_lca_map(dep.genome_paths, tree, dep.nameidmap_path, sp,
                           dep.canonical, device=device)
    save_probe_image(img, Database(table, dep.k, dep.k, sp.gaps,
                                   dep.canonical, "lex"), tree)
    meta = {"kmers": int(table.n), "lgnb": int(table.lgnb),
            "slot_bytes": int((1 << table.lgnb) * 4 * 8),
            "total_s": time.perf_counter() - t0}
    with open(done, "w") as fh:
        json.dump(meta, fh)
    log(f"# built the {dep.name} database: {json.dumps(meta)}")
    return img


def _classifier(dep, cache_dir: str, device: str, log):
    from bonsai_tpu_torch.classify.pipeline import Classifier
    from bonsai_tpu_torch.taxonomy.tree import TaxTree

    img = _image(dep, cache_dir, device, log)
    harness.free(device)
    harness.reset_peak(device)
    return Classifier.from_probe_image(
        img, TaxTree.from_nodes_dmp(dep.nodes_path), device=device)


def judged_reads(pool, traffic_: dict, seed: int) -> np.ndarray:
    """The reads whose records the check compares: ``judged`` drawn from
    the seed."""
    rng = traffic.rng_of(seed, 2)
    return np.sort(rng.choice(pool.n, min(int(traffic_["judged"]), pool.n),
                              replace=False))


def program_lines(parts, names) -> dict:
    """{name: record} of the records in a pass's text for ``names``."""
    want = set(names)
    out = {}
    for line in "".join(parts).splitlines(keepends=True):
        name = line.split("\t", 2)[1]
        if name in want:
            out[name] = line
    return out


def run(ctx: harness.Context) -> Record:
    import torch

    tr = ctx.traffic
    marks = [("start", ctx.t_start), ("imports", time.perf_counter())]
    dep = deploy.load(ctx.config_path, ctx.root)
    marks.append(("deployment", time.perf_counter()))
    harness.reset_peak(ctx.device)
    clf = _classifier(dep, ctx.cache_dir, ctx.device, ctx.log)
    marks.append(("database", time.perf_counter()))
    pool = traffic.make_pool(tr, dep, ctx.seed, ctx.root)
    chunk = int(tr["chunk"])
    fd, path = harness.memfile(pool.fasta(), "pool")
    judged = judged_reads(pool, tr, ctx.seed)
    names = [pool.name(int(i)) for i in judged]
    marks.append(("pool", time.perf_counter()))
    rec = Record("classify", ctx.cell, dep.config, tr, pool=pool, k=dep.k,
                 batch=chunk, bases=pool.bases)
    try:
        # two whole passes, then more until one leaves the compact
        # output's run capacity (``max_runs``, doubled after a few
        # full-matrix fallbacks, which it counts across passes) as it
        # found it
        runs = [clf.max_runs]
        while len(runs) <= WARMUP_PASSES or runs[-1] != runs[-2]:
            clf.process_dataset(path, Drop(), batch_size=chunk)
            runs.append(clf.max_runs)
        harness.sync(ctx.device)
        gc.collect()
        marks.append(("warm-up", time.perf_counter()))
        counted0 = clf.n_classified + clf.n_unclassified
        stages = dict.fromkeys(("parse", "dispatch", "materialize", "format"),
                               0.0)
        # the first pass's text, and the judged records of each pass
        # whose text differs from it, taken as the pass ends
        first, first_text, unlike = None, None, []
        prof = harness.profiler(ctx.device) if ctx.trace else None
        if prof is not None:
            prof.__enter__()
        try:
            t0 = time.perf_counter()
            rec.setup_s = t0 - ctx.t_start
            ends, cpu = [], [time.process_time()]
            while True:
                sink = Sink()
                clf.process_dataset(path, sink, batch_size=chunk)
                if first is None:
                    first = sink.parts
                elif sink.parts != first:
                    text = "".join(sink.parts)
                    first_text = first_text or "".join(first)
                    if text != first_text:
                        unlike.append(program_lines([text], names))
                del sink
                for s, v in clf.stage_seconds.items():
                    stages[s] += v
                ends.append(time.perf_counter() - t0)
                cpu.append(time.process_time())
                if ends[-1] >= ctx.seconds:
                    break
            harness.sync(ctx.device)
            rec.window_s = time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        if prof is not None:
            rec.trace = trace.record(prof)
        rec.peak_bytes = harness.cuda_peak(ctx.device)
        harness.no_forbidden_modules()
        rec.units = len(ends)
        rec.stage_seconds = stages
        rec.attempted = rec.units * pool.n
        counted = clf.n_classified + clf.n_unclassified - counted0
        ctx.log("# passes end at " + " ".join(f"{e:.3f}" for e in ends))
        ctx.log("# passes' process CPU s: " + " ".join(
            f"{b - a:.2f}" for a, b in zip(cpu, cpu[1:])))
        ctx.log(harness.phases(marks) + "; max_runs " + " -> ".join(
            map(str, runs)) + f" (window: {clf.max_runs}); threads "
            f"{threading.active_count()}, torch threads "
            f"{torch.get_num_threads()}")
    finally:
        os.close(fd)
    del clf
    harness.free(ctx.device)
    t_check = time.perf_counter()
    ref = reference.kraken_lines(dep, pool, judged, torch.device(ctx.device))

    def differ(prog):
        return sum(ref[n] != prog.get(n) for n in ref)

    per = [differ(program_lines(first, names))] * (rec.units - len(unlike))
    per += [differ(p) for p in unlike]
    rec.failed = sum(per)
    rec.text = first
    rec.checks = [Check("lines_differ", sum(per), 0)]
    ctx.log(f"# {ctx.cell['name']}: the classifier counted {counted} reads "
            f"of {rec.attempted}; passes unlike the first {len(unlike)}")
    ctx.log(f"# {ctx.cell['name']}: {rec.units} passes of {pool.n} reads "
            f"({rec.bases} bases) in {rec.window_s:.3f} s; judged "
            f"{len(ref)} reads, {sum(v is not None for v in ref.values())} "
            f"with a record, in {time.perf_counter() - t_check:.3f} s")
    return rec
