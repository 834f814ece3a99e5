"""The port's spans (``util.span``, ``util.SPANS``) on the CPU.

* ``Classifier.process_dataset`` under ``torch.profiler`` with every
  thread traced: each span in the thread that opens it, one ``parse`` and
  one ``format`` a batch in input order, one ``full_fetch`` a batch that
  fetched the full matrix, ``stage_seconds`` the four stages of
  ``span_seconds``, and the text the golden's;
* the device build (``device_lca_map``) and the slot image of the
  classifier's values: all six build spans;
* ``util.span`` alone, and ``tools/trace_summary.py``'s idle attribution
  and thread shares on a hand-made trace.
"""

import gzip
import io
import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bonsai_tpu_torch import util
from bonsai_tpu_torch.classify.pipeline import Classifier
from bonsai_tpu_torch.core.alphabet import InputType, alphabet_of
from bonsai_tpu_torch.core.spacer import Spacer
from bonsai_tpu_torch.db import build as tbuild
from bonsai_tpu_torch.db.build_device import device_lca_map
from bonsai_tpu_torch.db.formats import Database, packed_values
from bonsai_tpu_torch.io import fastx
from bonsai_tpu_torch.taxonomy.tree import TaxTree
from bonsai_tpu_torch.tools import trace_summary as ts

torch.set_num_threads(1)
GOLD = os.path.join(os.path.dirname(__file__), "data", "golden")
MANIFEST = json.load(open(os.path.join(GOLD, "manifest.json")))
GENOMES = [os.path.join(GOLD, f) for f in ("g_phix.fa", "g_phixmut.fa",
                                           "g_rand.fa")]
NODES = os.path.join(GOLD, "nodes.dmp")
READS = os.path.join(GOLD, "reads.fa")
BATCH = 64
# the thread each classify span runs in
THREAD = {"read": "producer", "parse": "producer",
          "producer_blocked": "producer", "pass": "main",
          "dispatch_starved": "main", "dispatch": "main",
          "dispatch_blocked": "main", "writer_starved": "writer",
          "materialize": "writer", "device_wait": "writer",
          "full_fetch": "writer", "format": "writer"}


def traced(fn, tmp_path):
    """(fn's result, the spans [(name, thread id, start, end)] of a CPU
    trace of every thread while it ran)."""
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=cfg) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return out, [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"])
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]


def names(spans, name):
    return sorted((s for s in spans if s[0] == name), key=lambda s: s[2])


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(tree, table, the build's spans) of the classify goldens' lex k=25
    database by the device build, with the classifier's slot image."""
    tree = TaxTree.from_nodes_dmp(NODES)

    def build():
        table = device_lca_map(GENOMES, tree,
                               os.path.join(GOLD, "nameidmap.txt"),
                               Spacer(25, 25), True, device="cpu")
        table.arrays_np(packed_values(table, tree))
        return table

    table, spans = traced(build, tmp_path_factory.mktemp("build"))
    return tree, table, spans


def _classifier(built, **kw):
    tree, table, _ = built
    return Classifier(Database(table, 25, 25, [0] * 24), tree, emit_all=True,
                      device="cpu", trim_table=False, **kw)


def _batches():
    lut = alphabet_of(InputType.DNA).lut
    return sum(1 for _ in fastx.batch_reads(READS, lut, batch_size=BATCH))


def test_the_build_opens_its_six_spans(built):
    tree, table, spans = built
    cfg = next(c for c in MANIFEST["configs"] if c["name"] == "lex_k25")
    assert tbuild.content_digest(table) == cfg["db_digest"]
    got = {s[0] for s in spans}
    assert set(util.BUILD_SPANS) <= got
    assert got <= set(util.SPANS)
    assert len(names(spans, "fold_fetch")) == 1
    assert len(names(spans, "placement")) == 1
    # one read a record and one a chunk, one fold a chunk and one a genome
    assert len(names(spans, "genome_read")) >= len(GENOMES) * 2
    assert len(names(spans, "fold")) >= len(GENOMES) * 2


def test_process_dataset_opens_each_span_in_its_thread(built, tmp_path):
    clf = _classifier(built)
    out = io.StringIO()
    _, spans = traced(lambda: clf.process_dataset(READS, out,
                                                  batch_size=BATCH), tmp_path)
    with gzip.open(os.path.join(GOLD, "classify_se.tsv.gz"), "rt") as fh:
        assert out.getvalue() == fh.read()
    assert {s[0] for s in spans} <= set(util.SPANS)
    assert set(clf.span_seconds) <= set(util.SPANS)
    tids = {}
    for name, tid, _, _ in spans:
        tids.setdefault(name, set()).add(tid)
    assert set(THREAD) - {"full_fetch"} <= set(tids)
    assert all(len(t) == 1 for t in tids.values()), tids
    thread = {}
    for name, t in tids.items():
        thread.setdefault(THREAD[name], set()).update(t)
    assert all(len(t) == 1 for t in thread.values()), thread
    assert len(set.union(*thread.values())) == 3
    n = _batches()
    assert n > 2
    parse, fmt = names(spans, "parse"), names(spans, "format")
    assert len(parse) == len(fmt) == n
    # the last read finds the file's end
    assert len(names(spans, "read")) == n + 1
    assert len(names(spans, "pass")) == 1
    assert all(p[2] < f[3] for p, f in zip(parse, fmt))
    # the accumulator counts what the trace holds
    for name in ("read", "parse", "format", "dispatch", "materialize",
                 "device_wait", "writer_starved", "pass"):
        assert clf.span_seconds[name][2] == len(names(spans, name)), name


def test_full_fetch_once_a_batch_that_fetched_the_full_matrix(built,
                                                              tmp_path):
    """max_runs=1: each batch with a read of more hit runs fetches the full
    matrix (one ``full_fetch``), until the run capacity grows; a forced
    full batch fetches it too."""
    clf = _classifier(built, max_runs=1)
    full = []
    orig = clf._finish_arrays

    def finish(*a, **kw):
        res = orig(*a, **kw)
        full.append(res.run_vals is None)
        return res

    clf._finish_arrays = finish
    out = io.StringIO()
    _, spans = traced(lambda: clf.process_dataset(READS, out,
                                                  batch_size=BATCH), tmp_path)
    with gzip.open(os.path.join(GOLD, "classify_se.tsv.gz"), "rt") as fh:
        assert out.getvalue() == fh.read()
    assert len(full) == _batches() and sum(full) > 0
    assert len(names(spans, "full_fetch")) == sum(full)
    assert clf.span_seconds["full_fetch"][2] == sum(full)
    inside = names(spans, "materialize")
    assert all(any(m[2] <= f[2] and f[3] <= m[3] for m in inside)
               for f in names(spans, "full_fetch"))
    batch = next(iter(fastx.batch_reads(READS, clf.lut, batch_size=BATCH)))
    _, spans = traced(lambda: clf.classify_batch(batch, full=True), tmp_path)
    assert len(names(spans, "full_fetch")) == 1


@pytest.mark.parametrize("paired", [False, True])
def test_stage_seconds_keeps_the_four_stages(built, paired):
    clf = _classifier(built)
    assert clf.stage_seconds is None
    mate = os.path.join(GOLD, "mate2.fa") if paired else None
    reads = os.path.join(GOLD, "mate1.fa") if paired else READS
    for _ in range(2):
        clf.process_dataset(reads, io.StringIO(), mate_path=mate,
                            batch_size=BATCH)
        assert list(clf.stage_seconds) == list(util.STAGES)
        assert clf.stage_seconds == {
            s: clf.span_seconds[s][0] for s in util.STAGES}
        assert all(v > 0 for v in clf.stage_seconds.values())


def test_profile_prints_each_span(built, capsys):
    clf = _classifier(built)
    clf.process_dataset(READS, io.StringIO(), batch_size=BATCH, profile=True)
    err = capsys.readouterr().err
    assert "# profile: " in err
    for name in ("read", "parse", "writer_starved", "device_wait"):
        line = next(ln for ln in err.splitlines()
                    if ln.startswith(f"# span {name}: "))
        assert f"count {clf.span_seconds[name][2]}" in line


def test_span_accumulates_wall_cpu_and_count():
    acc = {}
    with util.span("read", acc):
        time.sleep(0.02)
    wall, cpu, n = acc["read"]
    assert n == 1 and wall >= 0.02 and cpu < wall
    with util.span("read", acc):
        t = time.thread_time()
        while time.thread_time() - t < 0.01:
            pass
    assert acc["read"][2] == 2 and acc["read"][1] >= cpu + 0.01
    with pytest.raises(KeyError):
        with util.span("parse", acc):
            raise KeyError("x")
    assert acc["parse"][2] == 1
    with util.span("parse"):  # no accumulator, no profiler
        pass
    assert acc["parse"][2] == 1


def _ev(cat, name, ts, dur, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid}


def test_trace_summary_attributes_idle_time_to_working_spans():
    events = [
        _ev("Trace", "PyTorch Profiler (0)", 0, 100),
        _ev("user_annotation", "pass", 10, 80, tid=1),
        _ev("user_annotation", "dispatch_starved", 10, 30, tid=1),
        _ev("user_annotation", "dispatch", 40, 20, tid=1),
        _ev("user_annotation", "dispatch_blocked", 60, 20, tid=1),
        _ev("user_annotation", "read", 10, 20, tid=2),
        _ev("user_annotation", "parse", 30, 10, tid=2),
        _ev("user_annotation", "producer_blocked", 40, 10, tid=2),
        _ev("user_annotation", "writer_starved", 20, 40, tid=3),
        _ev("user_annotation", "materialize", 60, 30, tid=3),
        _ev("user_annotation", "device_wait", 60, 10, tid=3),
        _ev("kernel", "void k()", 45, 20),
    ]
    s = ts.summary(events)
    # idle: [0, 45) and [65, 100)
    assert s["idle_us"] == 80
    # working over idle: read 10-30, parse 30-40, dispatch 40-45,
    # materialize 65-90; the waits are not work
    assert s["idle_under"] == {"read": 20, "parse": 10, "dispatch": 5,
                               "materialize": 25, "any": 60}
    assert s["idle_under_share"] == pytest.approx(60 / 80)
    assert s["idle_gaps"][0]["host"] == {"read@2": 20, "parse@2": 10,
                                         "dispatch@1": 5}
    th = s["threads"]
    # the main thread lives through the pass, 10-90, covered 10-80
    assert th["1"]["life_us"] == 80 and th["1"]["covered_us"] == 70
    assert th["2"]["share"] == 1.0 and th["3"]["life_us"] == 70
    assert th["3"]["covered_us"] == 70
    assert s["stages"]["device_wait"] == {"3": [1, 10]}
    assert "thread 1: spans cover 87.50%" in ts.report(s)


def test_trace_summary_prints_the_report_of_a_trace_dir(tmp_path, capsys):
    events = [_ev("Trace", "PyTorch Profiler (0)", 0, 100),
              _ev("user_annotation", "placement", 0, 90, tid=1),
              _ev("kernel", "void k()", 90, 10)]
    with open(tmp_path / "run.pt.trace.json", "w") as fh:
        json.dump({"traceEvents": events}, fh)
    assert ts.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "100.00% of it under a working span" in out
    assert "thread 1: spans cover 100.00%" in out
    assert ts.main([]) == 2
