"""The readers of the program's spans (``spans.py`` and the per-layer
metrics that use it) on hand-made traces, and in traced runs of the tiny
cells."""

import ast
import os

import pytest

from benchmark import harness, spans, trace

CLASSIFY = ("read_ms_per_mbase", "producer_blocked_ms_per_mbase",
            "dispatch_starved_ms_per_mbase", "dispatch_blocked_ms_per_mbase",
            "writer_starved_ms_per_mbase", "device_wait_ms_per_mbase",
            "full_fetch_pct", "batch_latency_ms")
BUILD = ("genome_read_ms_per_mkmer", "fold_ms_per_mkmer",
         "fold_fetch_ms_per_mkmer", "placement_ms_per_mkmer",
         "image_ms_per_mkmer")


def _ev(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


# a window of [100, 1100) us: two batches of a classify pass, the first
# span cut by the window's start and one span past its end
CLASSIFY_EVENTS = [
    _ev("PyTorch Profiler (0)", 100, 1000, cat="Trace"),
    _ev("read", 50, 100, tid=1),          # 50 us of it inside
    _ev("parse", 150, 50, tid=1),
    _ev("producer_blocked", 200, 30, tid=1),
    _ev("read", 230, 20, tid=1),
    _ev("parse", 250, 50, tid=1),
    _ev("producer_blocked", 300, 200, tid=1),
    _ev("dispatch_starved", 100, 100, tid=2),
    _ev("dispatch", 200, 40, tid=2),
    _ev("dispatch_blocked", 240, 10, tid=2),
    _ev("dispatch", 300, 40, tid=2),
    _ev("dispatch_blocked", 340, 60, tid=2),
    _ev("writer_starved", 100, 150, tid=3),
    _ev("materialize", 250, 100, tid=3),
    _ev("device_wait", 250, 20, tid=3),
    _ev("format", 350, 50, tid=3),
    _ev("materialize", 400, 200, tid=3),
    _ev("device_wait", 400, 30, tid=3),
    _ev("full_fetch", 430, 100, tid=3),
    _ev("format", 600, 100, tid=3),
    _ev("read", 1150, 10, tid=1),         # past the window: not read
    _ev("parse", 90, 5, tid=1, cat="gpu_user_annotation"),  # not a span
]


def _classify_rec(events=CLASSIFY_EVENTS, traced=True):
    # 2 passes of 250,000 bases: 0.5 Mbases
    return harness.Record("classify", {}, {}, {}, units=2, bases=250_000,
                          window_s=0.5,
                          trace=trace.Trace(events) if traced else None)


def test_ranges_are_clipped_to_the_window_in_start_order():
    rec = _classify_rec()
    assert spans.ranges(rec, "read") == [(100, 150), (230, 250)]
    assert spans.seconds(rec, "read") == pytest.approx(70e-6)
    assert spans.seconds(rec, "read", "parse") == pytest.approx(170e-6)
    assert spans.seconds(rec, "no_such_span") is None
    assert spans.ranges(_classify_rec(traced=False), "read") == []


@pytest.mark.parametrize("name,us", [
    ("read_ms_per_mbase", 70), ("producer_blocked_ms_per_mbase", 230),
    ("dispatch_starved_ms_per_mbase", 100),
    ("dispatch_blocked_ms_per_mbase", 70),
    ("writer_starved_ms_per_mbase", 150), ("device_wait_ms_per_mbase", 50)])
def test_classify_span_readers(name, us):
    got = harness.reader(name).read(_classify_rec())
    assert got == pytest.approx(1e3 * us * 1e-6 / 0.5)


def test_full_fetch_share_and_batch_latency():
    rec = _classify_rec()
    assert harness.reader("full_fetch_pct").read(rec) == pytest.approx(50.0)
    # batch 1: parse 150 -> format end 400; batch 2: 250 -> 700
    assert spans.batch_latencies(rec) == pytest.approx([250e-6, 450e-6])
    assert harness.reader("batch_latency_ms").read(rec) == \
        pytest.approx(0.35)


def test_no_full_fetch_reads_zero_and_a_program_without_the_spans_nothing():
    no_fetch = [e for e in CLASSIFY_EVENTS if e["name"] != "full_fetch"]
    assert harness.reader("full_fetch_pct").read(
        _classify_rec(no_fetch)) == 0.0
    # the four stages alone (a program before these spans)
    stages = [e for e in CLASSIFY_EVENTS
              if e["name"] in trace.STAGES + ("PyTorch Profiler (0)",)]
    rec = _classify_rec(stages)
    for name in CLASSIFY[:7]:
        assert harness.reader(name).read(rec) is None, name
    assert harness.reader("batch_latency_ms").read(rec) is not None


def test_batch_latency_needs_a_format_for_each_parse():
    cut = [e for e in CLASSIFY_EVENTS
           if not (e["name"] == "format" and e["ts"] == 600)]
    assert spans.batch_latencies(_classify_rec(cut)) is None
    assert harness.reader("batch_latency_ms").read(_classify_rec(cut)) is None


@pytest.mark.parametrize("name", CLASSIFY + BUILD)
def test_no_trace_or_another_kind_reads_nothing(name):
    mod = harness.reader(name)
    assert mod.read(_classify_rec(traced=False)) is None
    assert mod.read(_build_rec(traced=False)) is None
    other = _build_rec() if name in CLASSIFY else _classify_rec()
    assert mod.read(other) is None


BUILD_EVENTS = [
    _ev("PyTorch Profiler (0)", 0, 10_000, cat="Trace"),
    _ev("genome_read", 0, 100), _ev("fold", 100, 900),
    _ev("genome_read", 1000, 100), _ev("fold", 1100, 900),
    _ev("fold_fetch", 2000, 500), _ev("placement", 2500, 1500),
    _ev("payload", 4000, 200), _ev("image", 4200, 800),
    _ev("genome_read", 9900, 300),        # cut at the window's end
]


def _build_rec(traced=True):
    # 2 builds of 5,000,000 k-mers: 10 Mk-mers
    return harness.Record("build", {}, {}, {}, units=2, kmers=5_000_000,
                          window_s=0.01,
                          trace=trace.Trace(BUILD_EVENTS) if traced else None)


@pytest.mark.parametrize("name,us", [
    ("genome_read_ms_per_mkmer", 300), ("fold_ms_per_mkmer", 1800),
    ("fold_fetch_ms_per_mkmer", 500), ("placement_ms_per_mkmer", 1500),
    ("image_ms_per_mkmer", 1000)])
def test_build_span_readers(name, us):
    got = harness.reader(name).read(_build_rec())
    assert got == pytest.approx(1e3 * us * 1e-6 / 10)


def test_the_span_reader_imports_nothing_of_the_program():
    tree = ast.parse(open(os.path.join(harness.HERE, "spans.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert not any(n.split(".")[0] == "bonsai_tpu_torch"
                           for n in names), names


def test_a_traced_classify_run_reports_every_span_metric(run_tiny):
    out = run_tiny("phix.hiseq", 2**31 + 5, traced=True)
    assert out["correct"]
    assert set(CLASSIFY) <= set(out["metrics"]), out["metrics"]
    assert {"producer_ms_per_mbase", "dispatch_ms_per_mbase",
            "writer_ms_per_mbase"} <= set(out["metrics"])


def test_a_traced_build_run_reports_every_span_metric(run_tiny):
    out = run_tiny("phix.build", 2**31 + 6, traced=True)
    assert out["correct"]
    assert set(BUILD) <= set(out["metrics"]), out["metrics"]
