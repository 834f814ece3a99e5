"""The device-trace and roofline arithmetic on a canned trace."""

import pytest

from benchmark import harness, roofline, trace

from .conftest import pool_of

EVENTS = [
    {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler", "ts": 0,
     "dur": 1000},
    {"ph": "X", "cat": "kernel", "ts": 100, "dur": 50,
     "name": "void (anonymous namespace)::encode_probe_kernel<false, 3>("
             "unsigned int const*, long)"},
    {"ph": "X", "cat": "kernel", "name": "void resolve_warp(int const*)",
     "ts": 120, "dur": 50},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
     "ts": 400, "dur": 100},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "dispatch", "ts": 0,
     "dur": 1000},
    {"ph": "X", "cat": "user_annotation", "name": "parse", "ts": 500,
     "dur": 300, "tid": 1},
    {"ph": "X", "cat": "user_annotation", "name": "format", "ts": 600,
     "dur": 100, "tid": 2},
    {"ph": "X", "cat": "kernel", "name": "void tail_kernel()", "ts": 990,
     "dur": 50},
]


def test_busy_is_the_union_and_annotations_are_not_work():
    t = trace.Trace(EVENTS)
    # 100-170 (two kernels overlapping), 400-500, 990-1000 (clipped)
    assert t.busy_us == pytest.approx(180)
    assert t.window_s == pytest.approx(1e-3)
    assert [(a, b) for a, b in t.gaps] == [(500, 990), (170, 400), (0, 100)]
    gaps = t.idle_gaps(2)
    assert gaps[0][0] == "parse+format"
    assert gaps[0][1] == pytest.approx(490e-6)
    assert gaps[1][0] == "no stage"


def test_kernel_times_and_names():
    t = trace.Trace(EVENTS)
    assert t.kernel_seconds([r"encode_probe_kernel<"]) == (1, pytest.approx(50e-6))
    assert t.kernel_seconds([r"resolve_warp", r"resolve_block"])[0] == 1
    ops = t.device_ops()
    assert ops["encode_probe_kernel<false, 3>"] == pytest.approx(50e-6)
    assert "Memcpy HtoD (Pinned -> Device)" in ops


def test_roofline_arithmetic():
    import numpy as np

    ln = np.array([101, 101])
    got = roofline.k1_bound_s(ln, np.array([71, 0]), 31, 1)
    want = ((101 / 4 + 32 * 71 + 4 * 71) + (101 / 4 + 4 * 71)) / 3.35e12
    assert got == pytest.approx(want)
    # two reads in one batch: one bound of their sums
    assert roofline.k1_bound_s(ln, np.array([71, 0]), 31, 2) == \
        pytest.approx(want)
    k2 = roofline.k2_bound_s(np.array([101]), np.array([1000]), 31, 1)
    assert k2 == pytest.approx(3e6 / (132 * 64 * 1.98e9))


def test_metric_readers_on_a_record():
    import numpy as np

    pool = pool_of([np.frombuffer(b"A" * 101, np.uint8)] * 2)
    rec = harness.Record("classify", {}, {}, {}, units=2, bases=202,
                         window_s=0.5, pool=pool, k=31, batch=2,
                         trace=trace.Trace(EVENTS),
                         stage_seconds={"parse": 1e-4, "dispatch": 2e-4,
                                        "materialize": 3e-4,
                                        "format": 1e-4})
    rec.text = ["C\tr0\t5\t101\t5:3\t6:60\t5:8\n"]
    got = {n: harness.reader(n).read(rec) for n in (
        "device_idle_pct.classify", "device_idle_pct.build",
        "mbases_per_s", "writer_ms_per_mbase", "k1_roofline_pct",
        "k2_roofline_pct", "build_mkmers_per_s")}
    assert got["device_idle_pct.classify"] == pytest.approx(82.0)
    assert got["device_idle_pct.build"] is None
    assert got["build_mkmers_per_s"] is None
    assert got["mbases_per_s"] == pytest.approx(2 * 202e-6 / 0.5)
    assert got["writer_ms_per_mbase"] == pytest.approx(0.4 / 404e-6)
    assert list(rec.distinct_hit_taxa()) == [2, 0]
    k1 = 2 * roofline.k1_bound_s(pool.lengths, np.array([71, 71]), 31, 2)
    assert got["k1_roofline_pct"] == pytest.approx(100 * k1 / 50e-6)
    k2 = 2 * roofline.k2_bound_s(pool.lengths, np.array([2, 0]), 31, 2)
    assert got["k2_roofline_pct"] == pytest.approx(100 * k2 / 50e-6)


def test_every_benchmark_metric_has_a_reader_that_agrees():
    bench = harness.load_bench(harness.ROOT)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert harness.reader(m["name"]).MOVES == m.get("moves", m["name"])
