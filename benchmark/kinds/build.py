"""The ``build`` kind: a deployment's database built on the device and
placed into the slot image a classifier uploads, repeated through the
window with nothing saved.

Set-up: the deployment and one build.  The window runs whole builds
until ``--seconds`` have gone by: ``db/build_device.py``
``device_lca_map`` (the genome stream, the fold on the card, the host
cuckoo placement of ``KmerTable``), then the table's slot image of the
classifier's values (``KmerTable.arrays_np`` of ``formats.packed_values``,
what ``probe-image`` saves and ``Classifier`` uploads).  Each build's
image is held against the first build's as the build ends, and kept only
where it differs.

The check, once the window has closed, compares one number,
``kmers_differ``: over every build of the window, the reference map's
k-mers that the image does not give back under their LCA taxon (read
through the table's format by ``reference.image_taxa``: missing, held
twice or under another taxon), and the keys the image holds beyond the
map's.  A build equal to the first counts what the first counts.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from .. import deploy, harness, reference, trace
from ..harness import Check, Record


def same(a, b) -> bool:
    return (a[0] == b[0] and a[2] == b[2] and np.array_equal(a[1], b[1])
            and np.array_equal(a[3], b[3]))


def run(ctx: harness.Context) -> Record:
    import torch
    from bonsai_tpu_torch.core.spacer import Spacer
    from bonsai_tpu_torch.db.build_device import device_lca_map
    from bonsai_tpu_torch.db.formats import packed_values
    from bonsai_tpu_torch.taxonomy.tree import TaxTree

    marks = [("start", ctx.t_start), ("imports", time.perf_counter())]
    dep = deploy.load(ctx.config_path, ctx.root)
    marks.append(("deployment", time.perf_counter()))
    tree = TaxTree.from_nodes_dmp(dep.nodes_path)
    sp = Spacer(dep.k, dep.k)

    def build():
        """(k-mers, slots, inline, values): one build's image."""
        t = device_lca_map(dep.genome_paths, tree, dep.nameidmap_path, sp,
                           dep.canonical, device=ctx.device)
        slots, vals, inline = t.arrays_np(packed_values(t, tree))
        return t.n, slots, bool(inline), np.asarray(vals)

    harness.reset_peak(ctx.device)
    build()
    harness.sync(ctx.device)
    gc.collect()
    marks.append(("warm-up", time.perf_counter()))
    ctx.log(harness.phases(marks))
    rec = Record("build", ctx.cell, dep.config, ctx.traffic, k=dep.k)
    first, others, units = None, [], 0
    prof = harness.profiler(ctx.device) if ctx.trace else None
    if prof is not None:
        prof.__enter__()
    try:
        t0 = time.perf_counter()
        rec.setup_s = t0 - ctx.t_start
        ends = []
        while True:
            got = build()
            if first is None:
                first = got
            elif not same(got, first):
                others.append(got)
            units += 1
            ends.append(time.perf_counter() - t0)
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
    ctx.log("# builds end at " + " ".join(f"{e:.3f}" for e in ends))
    rec.units = units
    rec.attempted = units
    harness.free(ctx.device)
    t_check = time.perf_counter()
    ref_k, ref_v = reference.lca_map(dep, torch.device(ctx.device))
    # the k-mers a build places, counted by the reference
    rec.kmers = int(ref_k.size)

    def differ(b):
        held, taxa = reference.image_taxa(b[1], b[3], b[2], ref_k)
        return reference.map_differ(ref_v, taxa, held)

    per = [differ(first)] * (units - len(others)) + [differ(b)
                                                     for b in others]
    rec.failed = sum(bool(d) for d in per)
    rec.checks = [Check("kmers_differ", sum(per), 0)]
    ctx.log(f"# {ctx.cell['name']}: {rec.units} builds of {rec.kmers} "
            f"k-mers in {rec.window_s:.3f} s ({first[0]} by the program), "
            f"{len(others)} unlike the first; checked in "
            f"{time.perf_counter() - t_check:.3f} s")
    return rec
