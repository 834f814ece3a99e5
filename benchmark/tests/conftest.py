"""Fixtures of the benchmark's own tests: a tiny bench directory (the
phiX deployment of ``tests/data/golden``, a small copy of the HiSeq mix,
the build mix, the real metric readers) that the harness runs on the CPU
with the program's plain torch versions."""

import hashlib
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips with a reason where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the test runs the program's kernels")
    return "cuda"


def pool_of(reads):
    """A pool holding ``reads`` (uint8 ASCII arrays) as they are."""
    import numpy as np

    from benchmark import traffic

    pool = traffic.Pool.empty([r.size for r in reads],
                              np.zeros(len(reads), np.int8))
    for s, r in zip(pool.start, reads):
        pool.buf[s:s + r.size] = r
    return pool


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(bench dict, bench dir, cache dir) of the tiny cells ``phix.hiseq``
    and ``phix.build`` over the phiX deployment of ``tests/data/golden``."""
    d = tmp_path_factory.mktemp("bench")
    for sub in ("configs", "traffic"):
        (d / sub).mkdir()
    os.symlink(os.path.join(BENCH, "metrics"), d / "metrics")
    gold = os.path.join(ROOT, "tests", "data", "golden")

    def pin(name):
        p = os.path.join(gold, name)
        return {"path": p, "sha256": _sha(p)}

    phix = {"name": "phix", "k": 31, "w": 31, "spacing": None,
            "canonical": True, "scheme": "lex",
            "genomes": [pin(f"g_{g}.fa") for g in ("phix", "phixmut", "rand")],
            "nodes_dmp": pin("nodes.dmp"), "nameidmap": pin("nameidmap.txt")}
    (d / "configs" / "phix.json").write_text(json.dumps(phix))
    with open(os.path.join(BENCH, "traffic", "hiseq.json")) as fh:
        h = json.load(fh)
    h.update(pool=3000, chunk=512, judged=300)
    (d / "traffic" / "hiseq.json").write_text(json.dumps(h))
    with open(os.path.join(BENCH, "traffic", "build.json")) as fh:
        (d / "traffic" / "build.json").write_text(fh.read())
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"] = [
        {"name": "phix", "source": "x",
         "file": str(d / "configs" / "phix.json"), "reduced": [],
         "why": "x"}]
    bench["workloads"] = [
        {"name": "phix.hiseq", "config": "phix", "traffic": "hiseq",
         "chips": 1, "why": "x"},
        {"name": "phix.build", "config": "phix", "traffic": "build",
         "chips": 1, "why": "x"}]
    tiny_of = {"ec5-k31.hiseq": "phix.hiseq", "ec5-k31.build": "phix.build"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny_of[w] for w in m["workloads"]]
    return bench, str(d), str(tmp_path_factory.mktemp("cache"))


@pytest.fixture(scope="session")
def run_tiny(tiny):
    """run(cell, seed, traced=False, device="cpu") of a tiny cell."""
    from benchmark import harness

    bench, bdir, cache = tiny

    def run(cell, seed, traced=False, device="cpu", seconds=0.2):
        return harness.run(cell, seed, seconds, traced, device=device,
                           root=ROOT, bench=bench, bench_dir=bdir,
                           cache_root=cache)
    return run
