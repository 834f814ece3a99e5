"""The read generator: deterministic by seed, and true to its files."""

import json
import os

import numpy as np
import pytest

from benchmark import deploy, traffic

from .conftest import BENCH, ROOT, pool_of


def _traffic(**kw):
    with open(os.path.join(BENCH, "traffic", "hiseq.json")) as fh:
        t = json.load(fh)
    t.update(kw)
    return t


@pytest.fixture(scope="module")
def dep(tiny):
    bench, _, _ = tiny
    return deploy.load(bench["configs"][0]["file"], ROOT)


@pytest.fixture(scope="module")
def file_reads():
    return traffic.reads_file(_traffic(), ROOT)


def test_pool_is_deterministic_and_seeds_share_the_work(dep):
    t = _traffic(pool=20000)
    a, b = (traffic.make_pool(t, dep, 2**31 + 17, ROOT),
            traffic.make_pool(t, dep, 2**31 + 17, ROOT))
    assert np.array_equal(a.buf, b.buf)
    c = traffic.make_pool(t, dep, 5, ROOT)
    assert not np.array_equal(a.buf[:1000], c.buf[:1000])
    assert np.array_equal(np.sort(a.lengths), np.sort(c.lengths))
    assert np.array_equal(np.bincount(a.origin), np.bincount(c.origin))


def test_lengths_and_origins_follow_the_file(dep, file_reads):
    p = traffic.make_pool(_traffic(pool=50000), dep, 3, ROOT)
    assert list(np.bincount(p.origin)) == [40000, 10000]
    # the database reads take the file's length histogram, which holds
    # 10,000 reads: four times its counts
    want = np.unique([r.size for r in file_reads], return_counts=True)
    got = np.unique(p.lengths[p.origin == 0], return_counts=True)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], 4 * want[1])
    # the file's reads, each once, as they are
    fr = sorted(p.read(int(i)).tobytes() for i in np.flatnonzero(p.origin))
    assert fr == sorted(r.tobytes() for r in file_reads)


def test_database_reads_come_from_the_genomes(dep):
    p = traffic.make_pool(_traffic(pool=2000, errors={}), dep, 4, ROOT)
    genomes = [r.tobytes() for g in dep.genomes for r in g.records]
    rc = traffic.COMPLEMENT
    for i in np.flatnonzero(p.origin == 0)[:200]:
        s = p.read(int(i))
        back = rc[s][::-1].tobytes()
        assert any(s.tobytes() in g or back in g for g in genomes)


def test_error_rates_follow_the_file():
    rng = np.random.default_rng(0)
    flat = deploy.BASES[rng.integers(0, 4, 1 << 20)]
    n = 5000
    start = rng.integers(0, flat.size - 200, n)
    src = flat[(start[:, None] + np.arange(200))]
    err = {"substitution": 0.005, "n": 0.001}
    mutate = np.arange(n) % 2 == 0
    pool = traffic.Pool.empty(np.full(n, 200), np.zeros(n, np.int8))
    traffic._fill(rng, pool, flat, start, np.zeros(n, bool), mutate, err, 0,
                  n)
    out = np.stack([pool.read(i) for i in range(n)])
    assert np.array_equal(out[~mutate], src[~mutate])
    is_n = out[mutate] == ord("N")
    sub = (out[mutate] != src[mutate]) & ~is_n
    assert abs(sub.mean() / 0.005 - 1) < 0.1
    assert abs(is_n.mean() / 0.001 - 1) < 0.15
    rc = np.ones(n, bool)
    traffic._fill(rng, pool, flat, start, rc, ~rc, {}, 0, n)
    out2 = np.stack([pool.read(i) for i in range(n)])
    assert np.array_equal(out2, traffic.COMPLEMENT[src][:, ::-1])


def test_fasta_holds_the_pool(dep):
    p = traffic.make_pool(_traffic(pool=500), dep, 9, ROOT)
    recs = deploy.read_fasta_bytes(p.fasta().tobytes())
    assert [r[0] for r in recs] == [p.name(i) for i in range(p.n)]
    assert all(np.array_equal(r[1], p.read(i)) for i, r in enumerate(recs))


def test_valid_kmers_counts_windows_without_an_n():
    p = pool_of([np.frombuffer(b"ACGTNACGTACGT", np.uint8),
                               np.frombuffer(b"AC", np.uint8)])
    # windows of 4 in ACGTNACGTACGT: ACGT, then 5 after the N; AC has none
    assert list(p.valid_kmers(4)) == [1 + 5, 0]


def test_a_changed_reads_file_fails(dep):
    t = _traffic(pool=100)
    t["reads_file"] = dict(t["reads_file"], sha256="0" * 64)
    with pytest.raises(ValueError, match="sha256"):
        traffic.make_pool(t, dep, 1, ROOT)
