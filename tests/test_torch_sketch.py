"""The port's sketches against the JAX package's, on the CPU (the plain
torch versions of KS1-KS3 and KR1): ``HyperLogLog``, ``CSetSketch``,
``count_hashes`` / ``MultiKCounter`` with their .shs / .bin files, and
``compare``, on the same inputs, made from a numpy seed or read from
phiX and the golden genomes.

Tolerance: exact equality, except the CSetSketch registers, which are
held within 2 ulp (``assert_array_max_ulp``): on the card their ``log``
is CUDA's; here, torch's and numpy's agree, and the test states the
tolerance the port keeps.  ids, idcounts and n_updates are exact.

Three faults of the JAX package that the port does not copy have a test
each that the port passes and the JAX package fails: its
``MultiKCounter`` counts the windows of a chunk overlap again for the
smaller ks (``test_counts_sum_to_the_windows_across_chunks``) and raises
on a contig shorter than the largest k
(``test_a_contig_shorter_than_the_largest_k_counts_the_ks_that_fit``);
the distmat one is in ``test_torch_sketch_cli.py``.
"""

import functools
import gzip
import os

import numpy as np
import pytest
import torch

from bonsai_tpu.sketch import compare as jcompare
from bonsai_tpu.sketch import hll as jhll
from bonsai_tpu.sketch import setsketch as jss
from bonsai_tpu.sketch import shs as jshs
from bonsai_tpu_torch.sketch import compare, hll, setsketch as ss, shs

SEED = 20261017
DATA = os.path.join(os.path.dirname(__file__), "data")
PHIX = os.path.join(DATA, "phix.fa")
GOLDEN = [os.path.join(DATA, "golden", f)
          for f in ("g_phix.fa", "g_phixmut.fa", "g_rand.fa")]


def _rng(i=0):
    return np.random.default_rng(SEED + i)


def _u64(rng, n):
    return rng.integers(0, 2**64, size=n, dtype=np.uint64)


# -- HyperLogLog (KS1) ---------------------------------------------------------

@pytest.mark.parametrize("p", [4, 12, 17])
def test_hll_registers_and_report_match_jax(p):
    rng = _rng(p)
    v = _u64(rng, 30000)
    v[:2] = [0, 2**64 - 1]
    # hashed keys whose h << p is 0: only their top p bits set
    top = (rng.integers(0, 1 << p, size=50).astype(np.uint64)
           << np.uint64(64 - p))
    ours, theirs = hll.HyperLogLog(p, "cpu"), jhll.HyperLogLog(p)
    ours.addh(v)
    theirs.addh(v)
    ours.add_hashes(np.concatenate([top, v[:1000]]))
    theirs.add_hashes(np.concatenate([top, v[:1000]]))
    assert ours.registers.dtype == np.uint8
    np.testing.assert_array_equal(ours.registers, theirs.registers)
    np.testing.assert_array_equal(ours.counts(), theirs.counts())
    assert ours.report() == theirs.report()
    assert ours.est_err() == theirs.est_err()
    # the rho of a key whose h << p is 0 is q + 1
    assert ours.registers.max() == 64 - p + 1


def test_hll_union_merge_and_jaccard_match_jax():
    rng = _rng(1)
    a, b = _u64(rng, 20000), _u64(rng, 15000)
    b[:5000] = a[:5000]
    ours = [hll.HyperLogLog(12, "cpu") for _ in range(2)]
    theirs = [jhll.HyperLogLog(12) for _ in range(2)]
    for o, t, v in zip(ours, theirs, (a, b)):
        o.addh(torch.from_numpy(v.view(np.int64)))
        t.addh(v)
    assert ours[0].union_estimate(ours[1]) == theirs[0].union_estimate(
        theirs[1])
    assert ours[0].jaccard(ours[1]) == theirs[0].jaccard(theirs[1])
    # union_estimate leaves both alone; merge raises in place, as JAX's
    np.testing.assert_array_equal(ours[0].registers, theirs[0].registers)
    c = ours[0].clone()
    assert c.merge(ours[1]) is c
    theirs[0].merge(theirs[1])
    np.testing.assert_array_equal(c.registers, theirs[0].registers)
    with pytest.raises(ValueError, match="incompatible"):
        ours[0].merge(hll.HyperLogLog(13, "cpu"))
    with pytest.raises(ValueError, match="out of range"):
        hll.HyperLogLog(31, "cpu")


def test_estimate_and_count_cardinality_match_jax():
    rng = _rng(2)
    arrays = [_u64(rng, 5000), _u64(rng, 100)]
    assert (hll.estimate_cardinality(arrays, 10, device="cpu")
            == jhll.estimate_cardinality(arrays, 10))
    assert (hll.count_cardinality([PHIX] + GOLDEN[2:], k=21)
            == jhll.count_cardinality([PHIX] + GOLDEN[2:], k=21))


# -- CSetSketch (KS2) ------------------------------------------------------------

def _repeats(rng, n_distinct, n_rep):
    """Distinct values, then copies of a few of them, so that copies of one
    k-mer fall in other 2^16 chunks of one update."""
    v = _u64(rng, n_distinct)
    return np.concatenate([v, np.repeat(v[:3], n_rep), v[: n_distinct // 2]])


def _same_sketch(ours, theirs):
    np.testing.assert_array_max_ulp(ours.registers, theirs.registers,
                                    maxulp=2)
    assert ours.n_updates == theirs.n_updates
    if theirs.save_kmers:
        np.testing.assert_array_equal(ours.ids(), theirs.ids())
    if theirs.save_kmer_counts:
        np.testing.assert_array_equal(ours.idcounts(), theirs.idcounts())


@pytest.mark.parametrize("m", [1, 64, 4096])
@pytest.mark.parametrize("mode", ["default", "-S", "-S -s"])
def test_csetsketch_matches_jax(m, mode):
    rng = _rng(m)
    save, counts = "-S" in mode, "-s" in mode
    ours = ss.CSetSketch(m, save, counts, device="cpu")
    theirs = jss.CSetSketch(m, save, counts)
    for v in (_repeats(rng, 3000, 70000), _u64(rng, 1), np.zeros(0, np.uint64),
              _repeats(rng, 1000, 10)):
        ours.update(v)
        theirs.update(v)
    _same_sketch(ours, theirs)
    if counts:  # copies in later chunks count, but not at the max register:
        # an arrival at the threshold is cut (m = 1: every register is it)
        assert (ours.idcounts().max() > 1) == (m > 1)
    assert ours.cardinality() == theirs.cardinality()
    assert (ours.max(), ours.min()) == (theirs.max(), theirs.min())
    assert ours.optimal_parameters() == theirs.optimal_parameters()


def test_csetsketch_all_copies_of_one_kmer():
    """One value in every slot of a chunk of 2^16 + 1: the registers it wins
    (the max of them all at m = 1) count it once."""
    for m in (1, 4):
        v = np.full((1 << 16) + 1, 0x1234567890ABCDEF, dtype=np.uint64)
        ours = ss.CSetSketch(m, True, True, device="cpu")
        theirs = jss.CSetSketch(m, True, True)
        for _ in range(2):
            ours.update(v)
            theirs.update(v)
        _same_sketch(ours, theirs)


def test_csetsketch_merge_jaccard_and_packing_match_jax():
    rng = _rng(3)
    a, b = _u64(rng, 4000), _u64(rng, 3000)
    b[:1500] = a[:1500]
    ours = [ss.CSetSketch(256, True, True, device="cpu") for _ in range(2)]
    theirs = [jss.CSetSketch(256, True, True) for _ in range(2)]
    for o, t, v in zip(ours, theirs, (a, b)):
        o.update(v)
        t.update(v)
    assert ours[0].jaccard(ours[1]) == theirs[0].jaccard(theirs[1])
    ours[0].merge(ours[1])
    theirs[0].merge(theirs[1])
    _same_sketch(ours[0], theirs[0])
    b_, a_ = ours[0].optimal_parameters()
    po, pt = ours[0].to_packed(b_, a_, 16), theirs[0].to_packed(b_, a_, 16)
    np.testing.assert_array_equal(po.registers, pt.registers)
    assert po.cardinality() == pt.cardinality()
    with pytest.raises(ValueError, match="incompatible"):
        ours[0].merge(ss.CSetSketch(128, device="cpu"))


@pytest.mark.parametrize("name", ["x.ss", "x.ss.gz"])
def test_ss_files_cross_between_packages(tmp_path, name):
    rng = _rng(4)
    v = _repeats(rng, 2000, 5)
    ours = ss.CSetSketch(128, True, True, device="cpu")
    theirs = jss.CSetSketch(128, True, True)
    ours.update(v)
    theirs.update(v)
    po, pt = str(tmp_path / f"o{name}"), str(tmp_path / f"t{name}")
    ours.write(po)
    theirs.write(pt)
    read = (gzip.open if name.endswith(".gz") else open)
    with read(po, "rb") as f1, read(pt, "rb") as f2:
        assert f1.read() == f2.read()
    _same_sketch(ss.CSetSketch.read(pt, device="cpu"), jss.CSetSketch.read(po))
    packed = ours.to_packed(*ours.optimal_parameters(), bits=8)
    packed.write(str(tmp_path / "p.pss"))
    back = jss.SetSketch.read(str(tmp_path / "p.pss"))
    np.testing.assert_array_equal(back.registers, packed.registers)
    assert ss.SetSketch.read(str(tmp_path / "p.pss")).b == packed.b


# -- count_hashes (KS3), MultiKCounter (KR1 + KS3), .shs / .bin ------------------

@pytest.mark.parametrize("case", ["random", "saturated", "bit63", "empty",
                                  "one"])
def test_count_hashes_matches_jax(case):
    rng = _rng(5)
    v = {
        "random": np.concatenate([_u64(rng, 5000)] * 3)[:12000],
        "saturated": np.concatenate([np.full(70000, 7, np.uint64),
                                     np.full(65535, 2**64 - 1, np.uint64),
                                     _u64(rng, 100)]),
        "bit63": (_u64(rng, 3000) | np.uint64(1 << 63)).repeat(2),
        "empty": np.zeros(0, np.uint64),
        "one": np.array([2**63], np.uint64),
    }[case]
    keys, counts = shs.count_hashes(v)
    want_k, want_c = jshs.count_hashes(v)
    assert keys.dtype == np.uint64 and counts.dtype == np.uint16
    np.testing.assert_array_equal(keys, want_k)
    np.testing.assert_array_equal(counts, want_c)


@pytest.mark.parametrize("canon", [False, True])
@pytest.mark.parametrize("nthash", [False, True])
def test_multik_counter_matches_jax_on_phix(canon, nthash):
    ks = [17, 21, 25, 29, 31]
    ours = shs.MultiKCounter(ks, canon=canon, nthash=nthash, device="cpu")
    theirs = jshs.MultiKCounter(ks, canon=canon, nthash=nthash)
    ours.add_file(PHIX)
    theirs.add_file(PHIX)
    for (k1, c1), (k2, c2) in zip(ours.counts(), theirs.counts()):
        np.testing.assert_array_equal(k1, k2)
        np.testing.assert_array_equal(c1, c2)


@pytest.mark.parametrize("canon", [False, True])
def test_multik_counter_sets_match_jax_on_phix(canon):
    """``key_sets`` (KB2, left on the device) and ``sets`` against the JAX
    package's ``sets``, with a contig boundary at a small chunk size."""
    ks = [17, 21, 31]
    ours = shs.MultiKCounter(ks, canon=canon, device="cpu", max_chunk=2000)
    theirs = jshs.MultiKCounter(ks, canon=canon)
    ours.add_file(PHIX)
    theirs.add_file(PHIX)
    want = theirs.sets()
    got = ours.key_sets()
    assert all(t.dtype == torch.int64 and t.device.type == "cpu" for t in got)
    for g, s, w in zip(got, ours.sets(), want):
        np.testing.assert_array_equal(g.numpy().view(np.uint64), w)
        np.testing.assert_array_equal(s, w)


def _windows(path, k):
    """Windows of k bases without an N, over every contig."""
    from bonsai_tpu_torch.core.alphabet import DNA4
    from bonsai_tpu_torch.io import fastx

    n = 0
    for _, seq, _ in fastx.read_fastx(path):
        bad = fastx.encode_contig(seq, DNA4.lut) < 0
        if bad.size >= k:
            run = np.convolve(bad, np.ones(k, dtype=int), "valid")
            n += int((run == 0).sum())
    return n


def test_counts_sum_to_the_windows_across_chunks(monkeypatch):
    """A 20,000-base contig in chunks of 3,000 bases: every window counts
    once for every k; the JAX package counts max(ks) - k windows of each
    chunk boundary again for the smaller ks (its counts exceed the
    windows), while its sets stay the same."""
    ks = [17, 21, 31]
    path = GOLDEN[2]
    ours = shs.MultiKCounter(ks, device="cpu", max_chunk=3000)
    ours.add_file(path)
    monkeypatch.setattr(jshs, "_contig_code_batches", functools.partial(
        jshs._contig_code_batches, max_chunk=3000))
    theirs = jshs.MultiKCounter(ks)
    theirs.add_file(path)
    whole = jshs.MultiKCounter(ks)  # one chunk: the reference's counts
    monkeypatch.undo()
    whole.add_file(path)
    for k, (k1, c1), (k2, c2), (k3, c3) in zip(ks, ours.counts(),
                                               theirs.counts(),
                                               whole.counts()):
        np.testing.assert_array_equal(k1, k2)
        assert int(c1.sum()) == _windows(path, k)
        np.testing.assert_array_equal(c1, c3)
        boundaries = (20000 - 1) // 3000
        assert int(c2.sum()) == _windows(path, k) + boundaries * (31 - k)


def test_a_contig_shorter_than_the_largest_k_counts_the_ks_that_fit(
        tmp_path):
    """A 7-base contig among longer ones: the port counts its windows for
    k = 5 and skips it for k = 21 and 40 ("still emit for the k's that
    fit", bonsai_tpu/sketch/shs.py:76-78); the JAX package raises on it
    (buzhash's ValueError, bonsai_tpu/core/rolling.py:100-101)."""
    ks = [5, 21, 40]
    recs = open(GOLDEN[2]).read()
    without = tmp_path / "without.fa"
    without.write_text(recs)
    with_short = tmp_path / "with.fa"
    with_short.write_text(recs + ">short\nACGTACG\n" + open(GOLDEN[0]).read())
    ours = shs.MultiKCounter(ks, device="cpu")
    ours.add_file(str(with_short))
    for k, (_, c) in zip(ks, ours.counts()):
        assert int(c.sum()) == _windows(str(with_short), k)
    assert _windows(str(with_short), 5) == _windows(str(without), 5) + 3 + \
        _windows(GOLDEN[0], 5)
    both = shs.MultiKCounter(ks, device="cpu")
    both.add_file(str(without))
    both.add_file(GOLDEN[0])
    for k, (k1, c1), (k2, c2) in zip(ks[1:], ours.counts()[1:],
                                     both.counts()[1:]):
        np.testing.assert_array_equal(k1, k2)
        np.testing.assert_array_equal(c1, c2)
    theirs = jshs.MultiKCounter(ks)
    theirs.add_file(str(without))  # no short contig: the JAX counts agree
    for (k1, c1), (k2, c2) in zip(_counts(ks, without), theirs.counts()):
        np.testing.assert_array_equal(k1, k2)
        np.testing.assert_array_equal(c1, c2)
    with pytest.raises(ValueError, match="k=21 > length 7"):
        jshs.MultiKCounter(ks).add_file(str(with_short))


def _counts(ks, path):
    ctr = shs.MultiKCounter(ks, device="cpu")
    ctr.add_file(str(path))
    return ctr.counts()


def test_shs_and_bin_files_cross_between_packages(tmp_path):
    ks = [21, 31]
    ours = shs.dump_maps(str(tmp_path / "o"), ks, PHIX, canon=True,
                         device="cpu")
    theirs = jshs.dump_maps(str(tmp_path / "t"), ks, PHIX, canon=True)
    assert [os.path.basename(f)[1:] for f in ours] == [
        os.path.basename(f)[1:] for f in theirs]
    for fo, ft in zip(ours, theirs):
        with gzip.open(fo, "rb") as a, gzip.open(ft, "rb") as b:
            assert a.read() == b.read()
    for k in ks:
        np.testing.assert_array_equal(
            shs.read_shs(str(tmp_path / f"t.{k}.shs")),
            jshs.read_shs(str(tmp_path / f"o.{k}.shs")))
        for a, b in zip(shs.read_bin(str(tmp_path / f"t.{k}.bin")),
                        jshs.read_bin(str(tmp_path / f"o.{k}.bin"))):
            np.testing.assert_array_equal(a, b)


# -- compare -------------------------------------------------------------------

def _sets():
    rng = _rng(6)
    base = np.unique(_u64(rng, 4000))
    other = np.unique(np.concatenate([base[:1500], _u64(rng, 2000)]))
    hi = np.unique(base | np.uint64(1 << 63))
    return [base, other, hi, np.zeros(0, np.uint64)]


@pytest.mark.parametrize("metric", ["jaccard", "intersection", "union",
                                    "containment"])
def test_pairwise_matrix_matches_jax(metric):
    sets = _sets()
    got = compare.pairwise_matrix(sets, metric)
    np.testing.assert_array_equal(got, jcompare.pairwise_matrix(sets, metric))
    tensors = [torch.from_numpy(s.view(np.int64)) for s in sets]
    np.testing.assert_array_equal(compare.pairwise_matrix(tensors, metric),
                                  got)


def test_counter_defaults_to_the_card(monkeypatch):
    """With no card and no device argument the Counter raises; it never
    runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compare.Counter()
    assert compare.Counter(device="cpu").device.type == "cpu"


def test_set_functions_and_counter_match_jax():
    a, b, c, e = _sets()
    for x, y in ((a, b), (b, c), (a, e), (c, a)):
        assert compare.intersection_size(x, y) == jcompare.intersection_size(
            x, y)
        assert compare.union_size(x, y) == jcompare.union_size(x, y)
        assert compare.jaccard_index(x, y) == jcompare.jaccard_index(x, y)
        assert compare.containment(x, y) == jcompare.containment(x, y)
    ours, theirs = compare.Counter(device="cpu"), jcompare.Counter()
    rng = _rng(7)
    for v in (_u64(rng, 50).repeat(3), a[:40], a[:40] | np.uint64(1 << 63)):
        ours.add(v)
        theirs.add(v)
    for x, y in zip(ours.items(), theirs.items()):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(ours.histogram(), theirs.histogram()):
        np.testing.assert_array_equal(x, y)
