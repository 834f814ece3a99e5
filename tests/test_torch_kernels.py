"""The port's CUDA kernels against their plain torch versions, on the card.

Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false.  The file imports neither jax nor ``bonsai_tpu``, so it runs on
a machine that has only the port's dependencies; the suite's conftest
imports jax, hence:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Inputs come from a numpy seed, at small shapes that still reach each
kernel's edge cases: for the classify kernels k = 32, in-read Ns, reads
shorter than k, flat-mode tables, P > 1024, run overflow, every compact
layout, and K1's sparse-N channel (contiguous and spaced) against both
its plain version and the mask channel, with Ns at column 0, at len - 1
and at word edges, lists exactly as long as their Ns, padded, empty, with
entries past the batch, and a block's list past what it stages; for the build kernels windows of 1 to 32 k-mers, P < W, keys
with bit 63 set and real U64_MAX keys, Ns at the ends of KB1's thread
runs and tiles, all-pad chunks, KB3 pairs across tile edges and whole
tiles of pairs, empty states, every lca() corner case and both
``sum_counts``; for the seed disciplines of ``-S``, ``-e`` and ``-C -w``
(KB1's spaced and entropy-file instantiations, KB4 and K1's spaced one)
spaced seeds of spans 25 to 63, windows of 1, 2, 13 and 16, rows of
every length from under the span to several tiles, all-N rows,
0 < n_valid < W tails, k = 32 k-mers with bit 63 set and real U64_MAX
k-mers; for the hash-scored phase 2 (KB5 and the score::Hash
instantiations of KB1 and KB4) inline and flat phase-1 images, stored
and missing k-mers, the poly-A k-mer 0 and U64_MAX stored, rows none of
whose k-mers phase 1 holds, P < W; for the gather microbenchmarks the
four ``take_along_axis`` shapes and 32-B and 128-B rows; for the Python
API's disciplines (the Shannon score of KB1 spaced and KB4, canonical
after selection or not, every other alphabet's fold in KB1 and KB4 under
every score, KR1) the same rows with codes of each alphabet, DNA seeds of
k = 1 and 32, of one code, of spans past 32, and palindromic and
complement-heavy rows, bytes past 127, a fold of 66 bits to a real
U64_MAX, and for KR1 k = 1 to 3 x its tile + 5 on rows of two tiles
(P at the tile's edges, Ns at run, tile and halo edges), an all-N row, N
runs longer than k, P = 1, 20 characters and kmercnt's 2^20-base row;
for KB5 also 64 MiB images (inline and flat), every k-mer's first bucket
in a quarter of the rows and the misses' second buckets outside it, and
a CUDA-graph replay; for the sketches, KS4's mixes, inverse mixes and rotates on 0,
U64_MAX and bit 63 and nuccount at k = 1, 31, 32 on 1-5 k-mers and
slices at an 8-B offset, KS1 at p = 4 to 15 (a u32 copy a block in
shared memory, past its size switch) and 16, 17, 20 (global atomics)
with keys whose h << p is 0 and U64_MAX, n = 0 to 2^20 and at its size
switch, keys aimed at the edges of every 32nd of the registers, every
key to one register, slices at an 8-B offset and registers off 16 B, KS3 with
runs past 65,535, keys with bit 63 set, E = 0 and 1, every key in one
bucket, a bucket past shared memory and one of exactly its capacity,
copies that overflow a bucket's split, keys below 2^20 and lex-like
62-bit keys, sizes at the tile edges, and its plan against
``sort_count_plan``, KS2 at m = 1, 5, 64, 4096 and 2^16 in each mode on
empty and one-element updates, all copies of one k-mer over a chunk of
2^16 + 1, copies across chunks and a full sketch fed 10 x 2^16 + 3
values, and KS2 on a
scratch of its stated size with a guard after it; for the formats and the
encoders' tail, KS5 at ndb = 1 to 2^31 - 1 on keys with bit 63 set, K128's
pack at k = 33 to 64 (canonical or not) on rows of two tiles, an all-N
row, Ns at run and tile edges, codes past 3 and P = 1, its rc and
canonical on pairs with bit 63 in either lane, and KB4's stream source at
W = 1 to 8192 on rows shorter than the window, an all-invalid row and
0 < n_valid < W; for the sharded classifier, KD1's frame at 1 to 1024
owners, Q < ndb, Q one past a tile, rounds with every query done or
only the last pending, and calls on one scratch that is never cleared;
KD1's probe on frames with U64_MAX pad runs (against a table that
stores U64_MAX and one that does not), n of 1, 3, 5 and a block's keys
+- 1, and pads only; KD1's collect at a thread's and a block's queries
+- 1, on views at an odd offset, and calls and graph replays on one
pending word that is never cleared; for the index tools, KmerIdx at k =
32 (KB1 and the stable sort on the card) whole and in chunks of 97
windows, with a second add_seq after finalize and its file, and
bitmap_patterns and pairwise_veccmp at T = 3 and 70, each against the
CPU; for K1's radix kernel, every mode at 200 reads, at the stream's
8192 reads, at P = 1 (a contiguous run over two reads),
on three reads of 70,000 codes (int32 lengths) and on reads of one
position under a spaced span of 63; and the CLI's classify --trace-dir,
whose trace must hold as many K1-K3 events as the wrappers counted.
Tolerance: exact equality, since all of it is
integer work (the entropy-file score's one double divide is IEEE-rounded
on both sides; the Shannon score's doubles are the same table's terms
added in the same order, then one add and one divide), but for KS2's
registers: within 2 ulp, as CUDA's double log is not numpy's (its ids,
idcounts and n_updates are exact).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bonsai_tpu_torch import kernels
from bonsai_tpu_torch.classify import pipeline as pl
from bonsai_tpu_torch.classify import resolve as res
from bonsai_tpu_torch.core import bitops, hashes
from bonsai_tpu_torch.core import encoder as enc
from bonsai_tpu_torch.core import rolling
from bonsai_tpu_torch.core.alphabet import InputType, nper64, radix_of
from bonsai_tpu_torch.db import build_device as bd
from bonsai_tpu_torch.db.table import (KmerTable, ProbeArrays, ScoreMap,
                                       lookup_scores)
from bonsai_tpu_torch.sketch import hll
from bonsai_tpu_torch.sketch import setsketch as ss
from bonsai_tpu_torch.sketch import shs
from bonsai_tpu_torch.taxonomy.tree import TaxTree
from bonsai_tpu_torch.tools import gather_bench as gb

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w)


# -- K1 encode_probe ---------------------------------------------------------

def _pack(codes):
    """(B, L) int8 codes (-1 = N or padding) -> 2-bit words (code c at bits
    2*(c % 16)) and the N bitmask, as int32 tensors."""
    B, L = codes.shape
    L32 = -(-L // 32) * 32
    c = np.full((B, L32), -1, dtype=np.int8)
    c[:, :L] = codes
    two = np.where(c < 0, 0, c).astype(np.uint32).reshape(B, -1, 16)
    words = (two << (2 * np.arange(16, dtype=np.uint32))).sum(-1, dtype=np.uint32)
    nbit = (c < 0).astype(np.uint32).reshape(B, -1, 32)
    nmask = (nbit << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32)
    return _i32(words), _i32(nmask)


def _reads(rng, B, L, k):
    lengths = rng.integers(k, L + 1, size=B).astype(np.int32)
    lengths[rng.choice(B, B // 8, replace=False)] = rng.integers(0, k, B // 8)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.01] = -1
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return codes, lengths


def _kmers(codes, lengths, k):
    """Every k-mer of the reads (first base in the high bits), as u64."""
    keys = []
    for row, n in zip(codes, lengths):
        for p in range(max(int(n) - k + 1, 0)):
            w = row[p : p + k]
            if (w >= 0).all():
                keys.append(int("".join(map(str, w)), 4))
    return np.unique(np.array(keys, dtype=np.uint64))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 31, 32])
@pytest.mark.parametrize("mode", ["dict", "inline-taxid", "flat"])
def test_encode_probe_kernel_matches_plain(cuda, k, mode):
    rng = np.random.default_rng(k)
    codes, lengths = _reads(rng, 256, 150, k)
    kmers = _kmers(codes, lengths, k)
    # stored keys: half the reads' k-mers (forward strand: with canon some
    # canonical forms hit, some miss) and keys with bit 63 set
    extra = rng.integers(0, 2**64, 3000, dtype=np.uint64) | np.uint64(1 << 63)
    keys = np.unique(np.concatenate([rng.choice(kmers, kmers.size // 2), extra]))
    if mode == "flat":  # all distinct: more values than the index field holds
        v = np.arange(keys.size, dtype=np.uint64)
    else:
        v = rng.integers(0, 6, keys.size).astype(np.uint64)
    table = KmerTable(keys, ((v + np.uint64(7)) << np.uint64(32)) | v)
    slots, vals, inline = table.arrays_np()
    assert inline == (mode != "flat")
    want_idx = mode == "dict"
    cpu_arr = ProbeArrays.from_numpy(slots, vals, inline, table.lgnb,
                                     table.vbits, "cpu")
    dev_arr = ProbeArrays.from_numpy(slots, vals, inline, table.lgnb,
                                     table.vbits, cuda)
    pc, nm = _pack(codes)
    ln = torch.from_numpy(lengths)
    for canon in (True, False):
        for lproc, with_n in ((160, True), (144, False)):
            m = nm if with_n else None
            args = (lproc, k, canon)
            want = pl.encode_probe(pc, m, ln, *args, cpu_arr, want_idx)
            before = pl.encode_probe.launches
            got = pl.encode_probe(pc.to(cuda), None if m is None else m.to(cuda),
                                  ln.to(cuda), *args, dev_arr, want_idx)
            assert pl.encode_probe.launches == before + 1
            _same(got, want)
            assert want[0].any() and (~want[0] & want[1]).any()


def _inline_arrays(keys, rng, device):
    """An inline table of ``keys`` with 6 distinct values, on ``device``."""
    v = rng.integers(0, 6, keys.size).astype(np.uint64)
    table = KmerTable(keys, ((v + np.uint64(7)) << np.uint64(32)) | v)
    slots, vals, inline = table.arrays_np()
    return ProbeArrays.from_numpy(slots, vals, inline, table.lgnb, table.vbits,
                                  device)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 21, 31, 32])
@pytest.mark.parametrize("lproc", [37, 100, 150])
def test_encode_probe_kernel_word_edges(cuda, k, lproc):
    """k-mer and N-mask windows across 16-base and 32-base word edges, an
    N at the first and at the last base of a window, reads shorter than
    k, and an lproc that is not a multiple of 16."""
    rng = np.random.default_rng(1000 * k + lproc)
    B, L = 96, 160
    codes, lengths = _reads(rng, B, L, k)
    lengths[:8] = lproc  # full-width reads, Ns only where set below
    codes[:8, :lproc] = rng.integers(0, 4, (8, lproc))
    for row, p in enumerate((15, 16, 31, 32, 47, 63, 64, lproc - 1)):
        if p < lproc:
            codes[row, p] = -1  # first base of window p, last of p - k + 1
    lengths[8:16] = rng.integers(0, k, 8)  # shorter than k
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    kmers = _kmers(codes, lengths, k)
    keys = np.unique(np.concatenate([
        rng.choice(kmers, max(kmers.size // 2, 1)),
        rng.integers(0, 4 ** k if k < 32 else 2**64, 500, dtype=np.uint64)]))
    pc, nm = _pack(codes)
    ln = torch.from_numpy(lengths)
    cpu_arr = _inline_arrays(keys, rng, "cpu")
    dev_arr = ProbeArrays(cpu_arr.slots.to(cuda), cpu_arr.vals.to(cuda),
                          cpu_arr.inline, cpu_arr.lgnb, cpu_arr.vbits)
    for canon in (True, False):
        for m in (nm, None):
            args = (lproc, k, canon)
            want = pl.encode_probe(pc, m, ln, *args, cpu_arr, True)
            got = pl.encode_probe(pc.to(cuda), None if m is None else m.to(cuda),
                                  ln.to(cuda), *args, dev_arr, True)
            _same(got, want)
            assert want[1][:8].sum() < 8 * (lproc - k + 1) or m is None
            assert not want[1][8:16].any()


@pytest.mark.cuda
def test_encode_probe_kernel_flat_table_of_2_31_slots(cuda):
    """Flat mode over 2^29 buckets (2^31 slots, 16 GiB of slots and 16 GiB
    of values) where the card has room, else 2^27: slot and value offsets
    past 2^32 bytes, keys in their first and in their second bucket.  The
    plain version runs on the same card tensors."""
    from bonsai_tpu_torch.db.table import BSALT, splitmix64_np

    free, _ = torch.cuda.mem_get_info(cuda)
    lgnb = 29 if free >= 40 * 2**30 else 27
    nb, vbits = 1 << lgnb, lgnb - 2
    rng = np.random.default_rng(lgnb)
    k = 31
    codes, lengths = _reads(rng, 64, 120, k)
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    em = enc.minimizers(c, ln, k, 1, True)
    kmers = np.unique(em.values[em.mask].numpy().view(np.uint64))
    keys = rng.choice(kmers, kmers.size * 2 // 3, replace=False)
    u = np.uint64
    h = splitmix64_np(keys)
    b1 = h & u(nb - 1)
    q = h >> u(lgnb)
    b2 = b1 ^ (splitmix64_np(q ^ u(BSALT)) & u(nb - 1))
    second = rng.random(keys.size) < 0.4
    bucket = np.where(second, b2, b1).astype(np.int64)
    _, first = np.unique(bucket, return_index=True)  # one key a bucket
    bucket, second, q = bucket[first], second[first], q[first]
    lane = rng.integers(0, 4, bucket.size)
    words = (u(1) << u(63)) | (second.astype(np.uint64) << u(62)) | (q << u(vbits))
    slots = torch.zeros((nb, 4), dtype=torch.int64, device=cuda)
    vals = torch.zeros((nb, 4), dtype=torch.int64, device=cuda)
    pos = torch.from_numpy(bucket * 4 + lane).to(cuda)
    slots.view(-1)[pos] = torch.from_numpy(words.view(np.int64)).to(cuda)
    vals.view(-1)[pos] = torch.from_numpy(
        rng.integers(-2**63, 2**63 - 1, bucket.size, dtype=np.int64)).to(cuda)
    arr = ProbeArrays(slots, vals, False, lgnb, vbits)
    pc, nm = _pack(codes)
    args = (pc.to(cuda), nm.to(cuda), ln.to(cuda), 128, k, True, arr)
    for want_idx in (True, False):
        got = pl.encode_probe(*args, want_idx)
        want = pl.encode_probe_plain(*args, want_idx)
        _same([g.cpu() for g in got], [w.cpu() for w in want])
        assert want[0].any() and (~want[0] & want[1]).any()
    del slots, vals, arr
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_encode_probe_refuses_what_the_kernel_does_not_take(cuda):
    table = KmerTable(np.arange(1, 100, dtype=np.uint64),
                      np.ones(99, dtype=np.uint64))
    arr = ProbeArrays.from_numpy(*table.arrays_np(), table.lgnb, table.vbits, cuda)
    pc = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    ln = torch.full((4,), 100, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        pl.encode_probe(pc.to(torch.int64), None, ln, 128, 31, True, arr, True)
    with pytest.raises(ValueError):
        pl.encode_probe(pc, None, ln, 129, 31, True, arr, True)
    with pytest.raises(ValueError):
        pl.encode_probe(pc, None, ln, 128, 33, True, arr, True)


# -- K2 resolve ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    rng = np.random.default_rng(5)
    pm = {1: 0}
    ids = [1]
    for t in range(2, 82):
        tid = int(t * 7 + rng.integers(0, 5))  # sparse, unsorted taxids
        pm[tid] = int(ids[rng.integers(0, len(ids))])
        ids.append(tid)
    return TaxTree(pm)


@pytest.mark.cuda
@pytest.mark.parametrize("P,n_distinct", [(74, 12), (148, None), (300, 12),
                                          (1500, 12), (1500, None)])
def test_resolve_kernel_matches_plain(cuda, tree, P, n_distinct):
    rng = np.random.default_rng(P + 1)
    n = tree.tin.shape[0]
    # hits from a fixed pool that includes compact index 0 (a DB taxid
    # absent from the tree); the first rows miss everywhere
    pool = np.concatenate([[0], rng.choice(np.arange(1, n), 11, replace=False)])
    cidx = rng.choice(pool, size=(64, P)).astype(np.int32)
    hit = rng.random((64, P)) < 0.6
    hit[:4] = False
    cidx = np.where(hit, cidx, 0).astype(np.int32)
    tax = tree.device_arrays("cpu")
    want = res.resolve(torch.from_numpy(cidx), torch.from_numpy(hit), tax,
                       n_distinct)
    before = res.resolve.launches
    got = res.resolve(torch.from_numpy(cidx).to(cuda),
                      torch.from_numpy(hit).to(cuda),
                      tree.device_arrays(cuda), n_distinct)
    assert res.resolve.launches == before + 1
    _same([got], [want])
    assert (want[:4] == 0).all()


def _k2_same(cuda, tree, cidx, hit, n_distinct, tax=None):
    """K2 on the card against resolve_plain on the CPU; one launch."""
    tax = tree.device_arrays("cpu") if tax is None else tax
    want = res.resolve_plain(torch.from_numpy(cidx), torch.from_numpy(hit),
                             tax, n_distinct)
    before = res.resolve.launches
    got = res.resolve(torch.from_numpy(cidx).to(cuda),
                      torch.from_numpy(hit).to(cuda),
                      {k: v.to(cuda) for k, v in tax.items()}, n_distinct)
    assert res.resolve.launches == before + 1
    _same([got], [want])
    return want.numpy().view(np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [74, 148, 1000, 1500])
@pytest.mark.parametrize("n_distinct", [12, None])
def test_resolve_kernel_hit_counts(cuda, tree, W, n_distinct):
    """Rows of 0, 1 and 2 hits, rows whose hits all fall on one taxon, and
    rows hit at every position; W = 1000 is the warp-per-read path with
    more than 48 KB of shared memory a block, 1500 the block-per-read
    path."""
    rng = np.random.default_rng(W)
    n = tree.tin.shape[0]
    pool = rng.choice(np.arange(n), 12, replace=False)
    cidx, hit = np.zeros((80, W), np.int32), np.zeros((80, W), bool)
    for r in range(16, 48):
        pos = rng.choice(W, 1 + (r >= 32), replace=False)
        hit[r, pos], cidx[r, pos] = True, rng.choice(pool, pos.size)
    hit[48:] = True
    cidx[48:64] = rng.choice(pool, (16, 1))
    cidx[64:] = rng.choice(pool, (16, W))
    want = _k2_same(cuda, tree, cidx, hit, n_distinct)
    assert (want[:16] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("P", [300, 74])
@pytest.mark.parametrize("n_distinct", [3, None])
def test_resolve_kernel_parent_cycle(cuda, P, n_distinct):
    """Nodes on a parent cycle keep the root's tin: the tie goes to the
    first position in the dense branch (taxid 6) and to the smaller
    compact index in the dedup branch (taxid 1), as in the JAX package."""
    cyc = TaxTree({1: 0, 2: 1, 3: 1, 5: 6, 6: 5})
    rng = np.random.default_rng(P)
    hit = rng.random((64, P)) < 0.6
    cidx = np.where(hit, rng.choice(cyc.compact([1, 5, 6]), (64, P)), 0)
    cidx, hit[0] = cidx.astype(np.int32), False
    cidx[0] = 0
    cidx[0, 0], hit[0, 0] = cyc.compact([6])[0], True
    cidx[0, 1:150], hit[0, 1:150] = cyc.compact([1])[0], True
    want = _k2_same(cuda, cyc, cidx, hit, n_distinct)
    assert want[0] == (1 if res.dedup_rule(n_distinct, P) else 6)


@pytest.fixture(scope="module")
def deep():
    from bonsai_tpu_torch.tools.synthetic import deep_tree

    t = deep_tree(np.random.default_rng(7), 1 << 16)
    return t, t.device_arrays("cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("n_distinct", ["given", None])
def test_resolve_kernel_deep_tree(cuda, deep, n_distinct):
    """A 2^16-node tree with lineages 25-40 deep (6 lift levels); every
    read ties two deep taxa, so the LCA is walked."""
    from bonsai_tpu_torch.tools.synthetic import deep_rows

    tree, tax = deep
    assert tree.lift.shape[0] == 6
    cidx, hit = deep_rows(np.random.default_rng(8), tree, R=512, split=12)
    nd = int(np.unique(cidx[hit]).size) if n_distinct else None
    _k2_same(cuda, tree, cidx, hit, nd, tax)


@pytest.mark.cuda
@pytest.mark.parametrize("R,W", [(256, 300), (32, 1500)])
def test_resolve_kernel_deep_tree_dedup(cuda, deep, R, W):
    """The dedup branch on the deep tree: 100 taxa, n_distinct = 100."""
    tree, tax = deep
    rng = np.random.default_rng(W)
    pool = rng.choice(np.arange(1, tree.tin.size), 100, replace=False)
    hit = rng.random((R, W)) < 0.6
    cidx = np.where(hit, rng.choice(pool, (R, W)), 0).astype(np.int32)
    assert res.dedup_rule(100, W)
    _k2_same(cuda, tree, cidx, hit, 100, tax)


@pytest.mark.cuda
@pytest.mark.parametrize("n_distinct", [12, None])
def test_resolve_kernel_paired_rows(cuda, tree, n_distinct):
    """Mates (2i, 2i+1) of width P = 150 as rows of width 2P = 300."""
    rng = np.random.default_rng(11)
    pool = rng.choice(np.arange(tree.tin.shape[0]), 12, replace=False)
    hit = rng.random((128, 150)) < 0.6
    cidx = np.where(hit, rng.choice(pool, (128, 150)), 0).astype(np.int32)
    _k2_same(cuda, tree, cidx.reshape(64, 300), hit.reshape(64, 300),
             n_distinct)


@pytest.mark.cuda
@pytest.mark.parametrize("R,W", [(16, 1500), (4, 1 << 15)])
@pytest.mark.parametrize("n_distinct", [82, None])
def test_resolve_kernel_long_rows(cuda, tree, R, W, n_distinct):
    """The block-per-read kernel: hits on every taxon of the tree, so that
    few hits share a taxon within 32 positions."""
    rng = np.random.default_rng(W + 2)
    hit = rng.random((R, W)) < 0.6
    hit[0] = False
    cidx = np.where(hit, rng.integers(0, tree.tin.shape[0], (R, W)), 0)
    _k2_same(cuda, tree, cidx.astype(np.int32), hit, n_distinct)


# -- K3 step_outputs -----------------------------------------------------------

def _rows(rng, R, W, dict_size):
    hit = rng.random((R, W)) < 0.6
    valid = hit | (rng.random((R, W)) < 0.5)
    valid[:, -3:] = False  # length padding
    hit &= valid
    hit[: R // 8] = False  # all-miss rows
    if dict_size is None:
        vals = rng.integers(0, 2**32, size=5, dtype=np.uint64).astype(np.uint32)
        vals[0] = 0xFFFFFFFF
        taxa = vals[rng.integers(0, 5, (R, W))]
    else:
        taxa = rng.integers(0, dict_size, (R, W)).astype(np.uint32)
    taxa[R // 2 :] = taxa[R // 2 :, :1]  # long runs in half the rows
    taxa = np.where(hit, taxa, 0).astype(np.uint32)
    taxon = rng.integers(0, 2**32, R, dtype=np.uint64).astype(np.uint32)
    valid1 = valid[:, : W // 2].sum(-1).astype(np.uint32)
    return [_i32(taxon), _i32(taxa), torch.from_numpy(hit),
            torch.from_numpy(valid), _i32(valid1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dict_size", [6, 200, 4000, None])
@pytest.mark.parametrize("W", [74, 300, 1 << 15])
@pytest.mark.parametrize("maxr", [8, 3])
def test_step_outputs_kernel_matches_plain(cuda, dict_size, W, maxr):
    rng = np.random.default_rng(W + maxr)
    args = _rows(rng, 16, W, dict_size)
    want = pl.step_outputs(*args, maxr, dict_size)
    before = pl.step_outputs.launches
    got = pl.step_outputs(*[a.to(cuda) for a in args], maxr, dict_size)
    assert pl.step_outputs.launches == before + 1
    _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 31, 32, 33, 148])
@pytest.mark.parametrize("dict_size", [6, None])
@pytest.mark.parametrize("maxr", [1, 8, 4096])
def test_step_outputs_kernel_chunk_edges(cuda, W, dict_size, maxr):
    """Widths around one 32-lane chunk and a paired row (W = 2 x 74); runs
    that cross chunk edges, a run carried over an all-miss chunk, rows
    with more runs than maxr, all-miss rows, and maxr up to 4096 (one
    read a block)."""
    rng = np.random.default_rng(10 * W + maxr)
    taxon, taxa, hit, valid, valid1 = _rows(rng, 40, W, dict_size)
    t = taxa.numpy().view(np.uint32)
    h = hit.numpy()
    h[5:, 0] = True  # _rows leaves the last 3 columns invalid: W = 1 hits
    if W > 64:  # row 30: one value at 10 and 100, nothing between
        h[30] = False
        h[30, [10, 100]] = True
        t[30] = 0
        t[30, [10, 100]] = 3
        # row 31: a new run at every hit, across every chunk edge
        h[31] = True
        t[31] = np.arange(W) % 2 + 1
    valid.numpy()[:] |= h
    args = [taxon, torch.from_numpy(t.view(np.int32)), torch.from_numpy(h),
            valid, valid1]
    want = pl.step_outputs(*args, maxr, dict_size)
    got = pl.step_outputs(*[a.to(cuda) for a in args], maxr, dict_size)
    _same(got, want)


# -- KB1 minimizers ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 31, 32])
@pytest.mark.parametrize("W,canon", [(1, True), (1, False), (2, True),
                                     (10, True), (32, True)])
def test_minimizers_kernel_matches_plain(cuda, k, W, canon):
    rng = np.random.default_rng(k * 100 + W)
    codes, lengths = _reads(rng, 64, 300, k)
    codes[3, 40:60] = -1  # an N run longer than the window
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    want = enc.minimizers(c, ln, k, W, canon)
    before = enc.minimizers.launches
    got = enc.minimizers(c.to(cuda), ln.to(cuda), k, W, canon)
    assert enc.minimizers.launches == before + 1
    _same(got, want)
    assert want.mask.any()


@pytest.mark.cuda
def test_minimizers_kernel_short_rows_and_wide_windows(cuda):
    codes = np.random.default_rng(3).integers(0, 4, (4, 40)).astype(np.int8)
    ln = torch.tensor([40, 35, 0, 20], dtype=torch.int32)
    c = torch.from_numpy(codes)
    # P = W, P < W (no slot), one slot per position at k = 32, L < k
    for k, W, L in ((31, 10, 40), (31, 11, 40), (32, 1, 40), (21, 1, 20)):
        want = enc.minimizers(c[:, :L].contiguous(), ln, k, W, True)
        got = enc.minimizers(c[:, :L].contiguous().to(cuda), ln.to(cuda), k,
                             W, True)
        _same(got, want)
    # uncanonical contiguous windows are KB4's discipline
    with pytest.raises(ValueError, match="compacted_minimizers"):
        enc.minimizers(c.to(cuda), ln.to(cuda), 21, 5, False)


KB1_RUN, KB1_TILE = 16, 4096  # csrc/minimizers.cu: slots a thread, a block


def _kb1_edge_rows(rng, k, W):
    """Rows that put Ns at the first and last slot of a thread's run and at
    tile edges, a run of Ns longer than k across a tile edge, a row of T
    (k = 32 uncanonical: U64_MAX) and of G/T bases (bit 63 set), and a row
    shorter than k; L is not a multiple of the run and E is odd."""
    L = 2 * KB1_TILE + 37 + k + W
    codes = rng.integers(0, 4, (5, L)).astype(np.int8)
    for p in (0, KB1_RUN - 1, KB1_RUN, 2 * KB1_RUN - 1, KB1_TILE - 1, KB1_TILE,
              KB1_TILE + KB1_RUN - 1, 2 * KB1_TILE + 5):
        codes[0, p] = -1
    codes[1, KB1_TILE - 20 : KB1_TILE + k + 20] = -1
    codes[2] = 3
    codes[2, 1000:1003] = 0
    codes[3] = rng.integers(2, 4, L)
    lengths = np.array([L, L - 3, L, L - KB1_TILE, k - 1], dtype=np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return codes, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("k,W,canon", [(32, 1, False), (32, 1, True),
                                       (31, 1, True), (31, 2, True),
                                       (31, 10, True), (21, 17, True),
                                       (32, 17, True)])
def test_minimizers_kernel_run_and_tile_edges(cuda, k, W, canon):
    codes, lengths = _kb1_edge_rows(np.random.default_rng(k + W), k, W)
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    want = enc.minimizers(c, ln, k, W, canon)
    assert want.values.shape[1] % 2 == 1
    got = enc.minimizers(c.to(cuda), ln.to(cuda), k, W, canon)
    _same(got, want)
    if (k, canon) == (32, False):
        assert (want.values[2][want.mask[2]] == -1).any()


# -- KB2 sort_unique -----------------------------------------------------------

def _i64(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def _kb2_input(E, kind):
    """(keys, emitted) CPU tensors of one KB2 edge case: duplicates, real
    U64_MAX keys, keys below 2^50 (the top digit's pass is skipped), every
    key equal, keys that differ in one middle digit only (every pass but
    that one and pass 0 skipped), one emitted key, no emitted key."""
    rng = np.random.default_rng(E + len(kind))
    keys = rng.integers(0, 2**64, size=E, dtype=np.uint64)
    if E:
        keys[rng.integers(0, E, E // 2)] = keys[rng.integers(0, E, E // 2)]
    if kind == "u64max":  # k = 32 uncanonical: real U64_MAX keys
        keys[rng.integers(0, E, 50)] = np.uint64(2**64 - 1)
        keys[:: 3] &= np.uint64(2**63 - 1)
    elif kind == "below2^50":
        keys >>= np.uint64(14)
    elif kind == "allequal":
        keys[:] = keys[0]
    elif kind == "middledigit":
        digit = np.uint64(0xFF << 24)
        keys = (keys[0] & ~digit) | ((keys & np.uint64(0xFF)) << np.uint64(24))
    emitted = rng.random(E) < (0.0 if kind == "allpad" else 0.8)
    if kind == "oneemitted":
        emitted[:] = False
        emitted[E // 2] = True
    return _i64(keys), torch.from_numpy(emitted)


@pytest.mark.cuda
@pytest.mark.parametrize("E,kind", [(0, "dups"), (7, "dups"), (5000, "dups"),
                                    (300_000, "dups"), (70_000, "u64max"),
                                    (9000, "allpad"), (3 * 4096 + 1, "dups"),
                                    (3 * 4096 + 1, "below2^50"),
                                    (5000, "allequal"), (70_000, "middledigit"),
                                    (5000, "oneemitted"), (1 << 22, "dups")])
def test_sort_unique_kernel_matches_plain(cuda, E, kind):
    k, e = _kb2_input(E, kind)
    want = bd.sort_unique(k, e)
    before = bd.sort_unique.launches
    got = bd.sort_unique(k.to(cuda), e.to(cuda))
    assert bd.sort_unique.launches == before + 1
    _same(got, want)
    if kind == "u64max":
        n = int(want[2])
        assert want[0][n - 1] == -1 and want[1][n - 1] == 0


@pytest.mark.cuda
def test_sort_unique_kernel_twice_on_one_stream(cuda):
    """Two calls queued back to back: the second reuses the first's
    scratch, so its counters and status words must be cleared again."""
    cases = [_kb2_input(1 << 18, kind) for kind in ("dups", "below2^50")]
    got = [bd.sort_unique(k.to(cuda), e.to(cuda)) for k, e in cases]
    for g, (k, e) in zip(got, cases):
        _same(g, bd.sort_unique(k, e))


# -- KB3 merge_fold ------------------------------------------------------------

@pytest.fixture(scope="module")
def small_tree():
    # 1 -> {2, 3}; 2 -> {11, 12}; 3 -> {13}; a second root 5 -> {51}
    return TaxTree({1: 0, 2: 1, 3: 1, 11: 2, 12: 2, 13: 3, 5: 0, 51: 5})


def _random_state(rng, tree, n, cap, pool):
    keys = np.sort(rng.choice(pool, n, replace=False).astype(np.uint64))
    taxa = rng.choice(np.array([0, 999, 2**32 - 2, *tree.tax_ids[:6]],
                               dtype=np.uint64), n).astype(np.uint32)
    node = tree.compact(taxa, missing_ok=True)
    st = [np.full(cap, 2**64 - 1, np.uint64), np.ones(cap, np.uint8),
          np.zeros(cap, np.int32), np.zeros(cap, np.uint32),
          np.zeros(cap, np.uint32)]
    for a, v in zip(st, (keys, 0, node, taxa, rng.integers(1, 4, n))):
        a[:n] = v
    return st, n


@pytest.mark.cuda
@pytest.mark.parametrize("sum_counts", [False, True])
@pytest.mark.parametrize("na,ca,nb,cb", [(0, 8, 0, 8), (5, 8, 9, 16),
                                         (3000, 4096, 2500, 8192),
                                         (40_000, 65536, 50_000, 65536)])
def test_merge_fold_kernel_matches_plain(cuda, tree, sum_counts, na, ca, nb, cb):
    rng = np.random.default_rng(na + nb + sum_counts)
    pool = rng.integers(0, 2**64, 2 * (na + nb) + 4, dtype=np.uint64)
    pool[:2] = [2**64 - 1, 2**63]  # a real U64_MAX key and bit 63
    a, _ = _random_state(rng, tree, na, ca, pool)
    b, _ = _random_state(rng, tree, nb, cb, pool)
    root1 = int(tree.compact(np.array([1], dtype=np.uint32))[0])
    sa = bd.State.from_numpy(*a, na, "cpu")
    sb = bd.State.from_numpy(*b, nb, "cpu")
    want = bd.merge_fold(sa, sb, tree.device_arrays("cpu"), root1, sum_counts)
    before = bd.merge_fold.launches
    got = bd.merge_fold(bd.State.from_numpy(*a, na, cuda),
                        bd.State.from_numpy(*b, nb, cuda),
                        tree.device_arrays(cuda), root1, sum_counts)
    assert bd.merge_fold.launches == before + 1
    _same([got.keys, got.pad, got.node, got.orig, got.cnt, got.n],
          [want.keys, want.pad, want.node, want.orig, want.cnt, want.n])


@pytest.mark.cuda
@pytest.mark.parametrize("sum_counts", [False, True])
def test_merge_fold_kernel_lca_corners(cuda, small_tree, sum_counts):
    """k1..k8: lca 2, lca 1, zero identity, all-same-missing, missing
    poison, disjoint roots, 0 with 0, a key in one state only."""
    ta = {10: 11, 20: 11, 30: 11, 40: 999, 50: 999, 60: 11, 70: 0, 80: 12}
    tb = {10: 12, 20: 13, 30: 0, 40: 999, 50: 11, 60: 51, 70: 0}
    root1 = int(small_tree.compact(np.array([1], dtype=np.uint32))[0])

    def state(d, dev):
        keys = np.array(sorted(d), dtype=np.uint64)
        taxa = np.array([d[x] for x in sorted(d)], dtype=np.uint32)
        cap = 8
        pad = lambda a, v, dt: np.concatenate(  # noqa: E731
            [a, np.full(cap - a.size, v, dt)]).astype(dt)
        return bd.State.from_numpy(
            pad(keys, 2**64 - 1, np.uint64), pad(np.zeros(keys.size), 1, np.uint8),
            pad(small_tree.compact(taxa, missing_ok=True), 0, np.int32),
            pad(taxa, 0, np.uint32), pad(np.ones(keys.size), 0, np.uint32),
            keys.size, dev)

    want = bd.merge_fold(state(ta, "cpu"), state(tb, "cpu"),
                         small_tree.device_arrays("cpu"), root1, sum_counts)
    got = bd.merge_fold(state(ta, cuda), state(tb, cuda),
                        small_tree.device_arrays(cuda), root1, sum_counts)
    _same([got.keys, got.pad, got.node, got.orig, got.cnt, got.n],
          [want.keys, want.pad, want.node, want.orig, want.cnt, want.n])
    keys, _, _, orig, _, n = got.numpy()
    assert dict(zip(keys[:n].tolist(), orig[:n].tolist())) == {
        10: 2, 20: 1, 30: 11, 40: 999, 50: 0xFFFFFFFF, 60: 1, 70: 0, 80: 12}


KB3_TILE = 2048  # csrc/merge_fold.cu: output slots a tile
# (taxid in a, taxid in b) of the eight lca() corners of the small tree
KB3_CORNERS = [(11, 12), (11, 13), (11, 0), (999, 999), (999, 11), (11, 51),
               (0, 0), (12, 12)]


def _placed_states(rng, tree, pairs_at, n_after, corners=(), u64max=False):
    """Host arrays of two states whose merged order holds a pair (a's entry
    at slot p - 1, b's at p) for each p of ``pairs_at``, the pairs taking
    the taxa of ``corners`` in turn; singles in a or b elsewhere, ``n_after``
    of them after the last pair; a real U64_MAX key in both states last
    where ``u64max``.  Returns (a, na, b, nb)."""
    where = []  # per distinct key: "a", "b" or "ab"
    pos = 0
    for p in sorted(pairs_at):
        while pos < p - 1:
            where.append("ab"[rng.integers(0, 2)])
            pos += 1
        where.append("ab")
        pos += 2
    where += ["ab"[rng.integers(0, 2)] for _ in range(n_after)]
    if u64max:
        where.append("ab")
    distinct = np.unique(rng.integers(0, 2**64 - 1, 2 * len(where) + 8,
                                      dtype=np.uint64))
    keys = np.sort(rng.choice(distinct, len(where), replace=False))
    if u64max:
        keys[-1] = np.uint64(2**64 - 1)
    pool = np.array([0, 999, *tree.tax_ids], dtype=np.uint64)
    cs = iter(corners)
    taxa = {"a": [], "b": []}
    kk = {"a": [], "b": []}
    for key, w in zip(keys, where):
        tx = next(cs, None) if w == "ab" else None
        for s, t in zip("ab", tx or rng.choice(pool, 2)):
            if s in w:
                kk[s].append(key)
                taxa[s].append(t)
    out = []
    for s in "ab":
        n = len(kk[s])
        cap = 1 << max(int(n - 1).bit_length(), 3)
        t = np.array(taxa[s], dtype=np.uint32)
        st = [np.full(cap, 2**64 - 1, np.uint64), np.ones(cap, np.uint8),
              np.zeros(cap, np.int32), np.zeros(cap, np.uint32),
              np.zeros(cap, np.uint32)]
        for a, v in zip(st, (np.array(kk[s], dtype=np.uint64), 0,
                             tree.compact(t, missing_ok=True), t,
                             rng.integers(1, 4, n))):
            a[:n] = v
        out += [st, n]
    return out


def _kb3_same(cuda, tree, a, na, b, nb, sum_counts):
    root1 = int(tree.compact(np.array([1], dtype=np.uint32))[0])
    want = bd.merge_fold(bd.State.from_numpy(*a, na, "cpu"),
                         bd.State.from_numpy(*b, nb, "cpu"),
                         tree.device_arrays("cpu"), root1, sum_counts)
    before = bd.merge_fold.launches
    got = bd.merge_fold(bd.State.from_numpy(*a, na, cuda),
                        bd.State.from_numpy(*b, nb, cuda),
                        tree.device_arrays(cuda), root1, sum_counts)
    assert bd.merge_fold.launches == before + 1
    f = ("keys", "pad", "node", "orig", "cnt", "n")
    _same([getattr(got, x) for x in f], [getattr(want, x) for x in f])
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("sum_counts", [False, True])
@pytest.mark.parametrize("swap", [False, True])
def test_merge_fold_kernel_pairs_across_tile_edges(cuda, small_tree,
                                                   sum_counts, swap):
    """A pair's first entry the last slot of a tile and its second the
    first of the next, at eight tile edges with the eight lca() corners,
    and with the states' roles swapped; a real U64_MAX key next to the
    pads."""
    rng = np.random.default_rng(11 + swap)
    edges = [KB3_TILE * (t + 1) for t in range(len(KB3_CORNERS))]
    a, na, b, nb = _placed_states(rng, small_tree, edges, 1000,
                                  KB3_CORNERS, u64max=True)
    if swap:
        a, na, b, nb = b, nb, a, na
    want = _kb3_same(cuda, small_tree, a, na, b, nb, sum_counts)
    assert int(want.n) == na + nb - len(edges) - 1
    assert int(want.keys[int(want.n) - 1]) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("sum_counts", [False, True])
def test_merge_fold_kernel_tiles_of_pairs(cuda, small_tree, sum_counts):
    """Whole tiles of pairs, starting at a tile edge and one slot after."""
    rng = np.random.default_rng(12)
    pairs = [KB3_TILE + 1 + 2 * i for i in range(KB3_TILE // 2)]
    pairs += [3 * KB3_TILE + 2 + 2 * i for i in range(KB3_TILE // 2)]
    a, na, b, nb = _placed_states(rng, small_tree, pairs, 300)
    _kb3_same(cuda, small_tree, a, na, b, nb, sum_counts)


@pytest.mark.cuda
@pytest.mark.parametrize("na,ca,nb,cb", [(0, 0, 0, 0), (0, 0, 5, 8),
                                         (3000, 4096, 0, 0), (3, 8, 50_000, 65536),
                                         (50_000, 65536, 1, 8),
                                         (3 << 20, 1 << 22, 3 << 20, 1 << 22)])
def test_merge_fold_kernel_capacities(cuda, tree, na, ca, nb, cb):
    """An empty state, one state far smaller than a tile, and 2^22 + 2^22."""
    rng = np.random.default_rng(na + 7 * nb)
    pool = rng.integers(0, 2**64, 2 * (na + nb) + 4, dtype=np.uint64)
    pool[:2] = [2**64 - 1, 2**63]
    a, _ = _random_state(rng, tree, na, ca, pool)
    b, _ = _random_state(rng, tree, nb, cb, pool)
    _kb3_same(cuda, tree, a, na, b, nb, True)


@pytest.mark.cuda
def test_merge_fold_kernel_twice_on_one_stream(cuda, tree):
    """Two calls queued back to back: the second's tile counter and status
    words must start cleared again."""
    rng = np.random.default_rng(13)
    root1 = int(tree.compact(np.array([1], dtype=np.uint32))[0])
    cases = []
    for n, cap in ((40_000, 65536), (70_000, 131072)):
        pool = rng.integers(0, 2**64, 3 * n, dtype=np.uint64)
        cases.append([_random_state(rng, tree, n, cap, pool)[0] for _ in "ab"]
                     + [n])
    got = [bd.merge_fold(bd.State.from_numpy(*a, n, cuda),
                         bd.State.from_numpy(*b, n, cuda),
                         tree.device_arrays(cuda), root1, True)
           for a, b, n in cases]
    f = ("keys", "pad", "node", "orig", "cnt", "n")
    for g, (a, b, n) in zip(got, cases):
        want = bd.merge_fold(bd.State.from_numpy(*a, n, "cpu"),
                             bd.State.from_numpy(*b, n, "cpu"),
                             tree.device_arrays("cpu"), root1, True)
        _same([getattr(g, x) for x in f], [getattr(want, x) for x in f])


# -- G1 row_gather, G2 take_along ------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("R,C,Q", [(1 << 12, 32, 1 << 11), (1 << 14, 8, 5000),
                                   (17, 4, 3)])
def test_row_gather_kernel_matches_plain(cuda, R, C, Q):
    rng = np.random.default_rng(R + C)
    tbl = torch.from_numpy(rng.integers(-2**31, 2**31, (R, C)).astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, R, Q).astype(np.int32))
    before = gb.row_gather.launches
    got = gb.row_gather(tbl.to(cuda), idx.to(cuda))
    assert gb.row_gather.launches == before + 1
    _same([got], [gb.row_gather(tbl, idx)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(4))
def test_take_along_kernel_matches_plain(cuda, case):
    name, tab, idx, axis = gb.take_cases(cuda)[case]
    before = gb.take_along.launches
    got = gb.take_along(tab, idx, axis)
    assert gb.take_along.launches == before + 1
    _same([got], [gb.take_along(tab.cpu(), idx.cpu(), axis)])


@pytest.mark.cuda
@pytest.mark.parametrize("axis,R,Ct,Q,Ci", [(0, 1000, 128, 1001, 128),
                                            (0, 37, 6, 5, 6),
                                            (1, 77, 48, 77, 70),
                                            (1, 1024, 128, 1024, 64)])
def test_take_along_kernel_ragged(cuda, axis, R, Ct, Q, Ci):
    """A ragged Q, widths that are not a multiple of 4, and axis 1 with
    Ci != Ct."""
    rng = np.random.default_rng(R + Ci)
    tab = torch.from_numpy(rng.integers(-2**31, 2**31, (R, Ct)).astype(np.int32))
    hi = R if axis == 0 else Ct
    idx = torch.from_numpy(rng.integers(0, hi, (Q, Ci)).astype(np.int32))
    got = gb.take_along(tab.to(cuda), idx.to(cuda), axis)
    _same([got], [gb.take_along(tab, idx, axis)])


@pytest.mark.cuda
@pytest.mark.parametrize("coop", [False, True])
def test_empty_launch_yardstick(cuda, coop):
    """The launch floor's yardstick launches (cooperative: every block at
    one grid barrier) and its graph replay gives a time; blocks past what
    the card holds at once are refused in cooperative mode."""
    gb.empty_launch(148, coop, cuda)
    torch.cuda.synchronize()
    assert gb.graph_ms(lambda: gb.empty_launch(148, coop, cuda), 10) > 0
    if coop:
        with pytest.raises(RuntimeError, match="bk_empty_launch"):
            gb.empty_launch(1 << 20, True, cuda)


_BAD_GATHER = """
import torch
from bonsai_tpu_torch.tools import gather_bench as gb
dev = torch.device("cuda", 0)
tab = torch.zeros((64, 8), dtype=torch.int32, device=dev)
good = torch.zeros((64, 8), dtype=torch.int32, device=dev)
bad = good.clone()
bad[5, 0] = {bad}
for idx in (good, bad):
    if "{which}" == "row_gather":
        gb.row_gather(tab, idx[:, 0].contiguous())
    else:
        gb.take_along(tab, idx, {axis})
    torch.cuda.synchronize()
    print("returned", flush=True)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("which,axis,bad", [("row_gather", 0, 64),
                                            ("take_along", 0, -1),
                                            ("take_along", 1, 8)])
def test_gathers_trap_on_a_bad_index(cuda, which, axis, bad):
    """An index outside the table stops G1 and G2 with a trap, which ends
    the process's CUDA context, so each runs in a process of its own: the
    good gather returns, the bad one fails at the next synchronisation."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _BAD_GATHER.format(which=which, axis=axis, bad=bad)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.stdout.count("returned") == 1, proc.stderr
    assert proc.returncode != 0


# -- the seed disciplines of -S, -e and -C -w: KB1 spaced and entropy-file,
# -- KB4, K1 spaced ------------------------------------------------------------

SPACINGS = {  # k -> a spacing string of k - 1 gaps
    21: "0x16,1x4",  # the spaced_k21 golden's: span 25
    31: "0,2,0,1,3,0x10,5,0x14",  # irregular: span 42
    32: "1x31",  # every other base: span 63
}


def _positions(k):
    from bonsai_tpu_torch.core.spacer import Spacer

    return tuple(int(p) for p in Spacer(k, k, SPACINGS[k]).positions)


def _discipline_rows(rng, c, W, L=300, B=48):
    """Rows with 2% Ns, an N run longer than the span, a row of T (k = 32:
    U64_MAX), a row of G/T (bit 63 set), an all-N row, rows shorter than
    the span, rows with fewer than W valid seeds, padded with -1."""
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.02] = -1
    lengths = rng.integers(c, L + 1, B).astype(np.int32)
    codes[0, 40 : 40 + c + 20] = -1
    codes[1] = 3
    lengths[1] = L
    codes[2] = rng.integers(2, 4, L)
    codes[3] = -1
    lengths[4:8] = rng.integers(0, c, 4)
    lengths[8:12] = c + rng.integers(0, max(W - 1, 1), 4)  # n_valid < W
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return codes, lengths


def _run_kb1(cuda, codes, lengths, k, W, canon, scheme, positions,
             score_map=None):
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    want = enc.minimizers(c, ln, k, W, canon, scheme, positions, score_map)
    before = enc.minimizers.launches
    got = enc.minimizers(c.to(cuda), ln.to(cuda), k, W, canon, scheme,
                         positions, score_map)
    assert enc.minimizers.launches == before + 1
    _same(got, want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("k", sorted(SPACINGS))
@pytest.mark.parametrize("W", [1, 2, 13, 16])
@pytest.mark.parametrize("scheme", ["lex", "entropy-file"])
def test_minimizers_spaced_kernel_matches_plain(cuda, k, W, scheme):
    pos = _positions(k)
    rng = np.random.default_rng(k * 7 + W)
    codes, lengths = _discipline_rows(rng, pos[-1] + 1, W)
    want = _run_kb1(cuda, codes, lengths, k, W, False, scheme, pos)
    assert want.mask.any()
    # Ns at thread-run and tile edges, an N run across a tile edge
    codes, lengths = _kb1_edge_rows(rng, pos[-1] + 1, W)
    _run_kb1(cuda, codes, lengths, k, W, False, scheme, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [21, 25, 32])
@pytest.mark.parametrize("W", [2, 13, 16])
def test_minimizers_entropy_kernel_matches_plain(cuda, k, W):
    rng = np.random.default_rng(k * 11 + W)
    codes, lengths = _discipline_rows(rng, k, W)
    want = _run_kb1(cuda, codes, lengths, k, W, True, "entropy-file", None)
    assert want.mask.any()
    codes, lengths = _kb1_edge_rows(rng, k, W)
    _run_kb1(cuda, codes, lengths, k, W, True, "entropy-file", None)


def _run_kb4(cuda, codes, lengths, k, W, scheme, score_map=None):
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    want = enc.compacted_minimizers(c, ln, k, W, scheme, score_map)
    before = enc.compacted_minimizers.launches
    got = enc.compacted_minimizers(c.to(cuda), ln.to(cuda), k, W, scheme,
                                   score_map)
    assert enc.compacted_minimizers.launches == before + 1
    _same(got, want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 21, 31, 32])
@pytest.mark.parametrize("W", [1, 2, 13, 16])
@pytest.mark.parametrize("scheme", ["lex", "entropy-file"])
def test_compacted_minimizers_kernel_matches_plain(cuda, k, W, scheme):
    rng = np.random.default_rng(k * 13 + W)
    codes, lengths = _discipline_rows(rng, k, W)
    want = _run_kb4(cuda, codes, lengths, k, W, scheme)
    assert want.mask[:, 1:].any()
    if W > 1:  # a trailing partial window in some row
        assert want.mask[:, 0].any()
    # rows of several tiles: the look-back between a row's tiles, Ns at
    # tile edges, a tile with no valid seed
    codes, lengths = _kb1_edge_rows(rng, k, W)
    codes[4, : 2 * KB1_TILE] = -1
    lengths[4] = codes.shape[1]
    _run_kb4(cuda, codes, lengths, k, W, scheme)


@pytest.mark.cuda
@pytest.mark.parametrize("L,W", [(40, 13), (30, 16), (4, 2)])
def test_compacted_minimizers_kernel_many_short_rows(cuda, L, W):
    """Rows shorter than a window (P < W: the tail column alone) and
    rows shorter than k, thousands of them."""
    rng = np.random.default_rng(L + W)
    codes = rng.integers(0, 4, (3000, L)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.05] = -1
    lengths = rng.integers(0, L + 1, 3000).astype(np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    for k in (5, 21):
        if L >= k:
            _run_kb4(cuda, codes, lengths, k, W, "lex")


@pytest.mark.cuda
def test_compacted_minimizers_kernel_twice_on_one_stream(cuda):
    """Two calls queued back to back: the status words and the tile
    counter are cleared again."""
    rng = np.random.default_rng(5)
    cases = [_discipline_rows(rng, 31, 10, L=9000, B=16) for _ in range(2)]
    got = [enc.compacted_minimizers(torch.from_numpy(c).to(cuda),
                                    torch.from_numpy(n).to(cuda), 31, 10)
           for c, n in cases]
    for g, (c, n) in zip(got, cases):
        _same(g, enc.compacted_minimizers(torch.from_numpy(c),
                                          torch.from_numpy(n), 31, 10))


@pytest.mark.cuda
@pytest.mark.parametrize("k", sorted(SPACINGS))
@pytest.mark.parametrize("mode", ["dict", "flat"])
def test_encode_probe_spaced_kernel_matches_plain(cuda, k, mode):
    pos = _positions(k)
    c = pos[-1] + 1
    rng = np.random.default_rng(k + 1)
    codes, lengths = _reads(rng, 256, 150, c)
    codes[0, :] = 3  # k = 32: U64_MAX k-mers, never valid
    lengths[0] = 150
    cl, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    em = enc.minimizers(cl, ln, k, 1, False, "lex", pos)
    kmers = em.values[em.mask].numpy().view(np.uint64)
    extra = rng.integers(0, 2**64, 3000, dtype=np.uint64) | np.uint64(1 << 63)
    keys = np.unique(np.concatenate([rng.choice(kmers, kmers.size // 2),
                                     extra]))
    v = (np.arange(keys.size, dtype=np.uint64) if mode == "flat" else
         rng.integers(0, 6, keys.size).astype(np.uint64))
    table = KmerTable(keys, ((v + np.uint64(7)) << np.uint64(32)) | v)
    slots, vals, inline = table.arrays_np()
    arrs = [ProbeArrays.from_numpy(slots, vals, inline, table.lgnb,
                                   table.vbits, d) for d in ("cpu", cuda)]
    pc, nm = _pack(codes)
    for lproc, with_n in ((160, True), (144, False)):
        m = nm if with_n else None
        args = (lproc, k, False)
        want = pl.encode_probe(pc, m, ln, *args, arrs[0], mode == "dict",
                               positions=pos)
        assert want[0].shape[1] == lproc - c + 1
        before = pl.encode_probe.variants.get("spaced", 0)
        got = pl.encode_probe(pc.to(cuda), None if m is None else m.to(cuda),
                              ln.to(cuda), *args, arrs[1], mode == "dict",
                              positions=pos)
        assert pl.encode_probe.variants["spaced"] == before + 1
        _same(got, want)
        assert want[0].any() and (~want[0] & want[1]).any()


def _nlist(codes, lengths, lproc, pad=0, extra=()):
    """The sparse-N list of the reads: the flat positions row * lproc +
    col of their in-read Ns, sorted, then ``extra`` entries, padded with
    ``pad`` sentinels (0: a list exactly as long as its Ns)."""
    r, c = np.nonzero((codes < 0) & (np.arange(codes.shape[1])[None, :]
                                     < lengths[:, None]))
    flat = np.concatenate([(r * lproc + c).astype(np.uint32),
                           np.asarray(extra, np.uint32),
                           np.full(pad, pl.N_SENTINEL, np.uint32)])
    return _i32(flat)


def _sparse_case(rng, c, B=256, L=150):
    """Reads with a few in-read Ns where the sparse channel puts them: at
    column 0, at len - 1, at 16- and 32-base word edges, two in one
    window, on a spaced seed's gaps and offsets alike."""
    codes, lengths = _reads(rng, B, L, c)
    inread = np.arange(L)[None, :] < lengths[:, None]
    codes[(codes < 0) & inread] = 1
    lengths[:6] = L
    codes[:6] = rng.integers(0, 4, (6, L))
    for row, cols in enumerate(((0,), (L - 1,), (15, 16), (31, 32),
                                (63, 64), (40, 41, 42))):
        codes[row, list(cols)] = -1
    more = rng.choice(np.flatnonzero(inread[6:]), 40, replace=False)
    codes[6:].reshape(-1)[more] = -1
    codes[~inread] = -1
    return codes, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("k,spaced", [(21, False), (31, False), (32, False),
                                      (21, True), (31, True), (32, True)])
def test_encode_probe_sparse_kernel_matches_plain_and_mask(cuda, k, spaced):
    """K1's sparse instantiation against its plain version and against
    K1's mask instantiation on the same reads, with a list exactly as long
    as its Ns, one padded with sentinels and entries past the batch (the
    JAX scatter drops them), and the empty list."""
    pos = _positions(k) if spaced else None
    c = pos[-1] + 1 if spaced else k
    rng = np.random.default_rng(100 + k + spaced)
    codes, lengths = _sparse_case(rng, c)
    B, lproc = codes.shape[0], 160
    cl, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    em = enc.minimizers(cl, ln, k, 1, not spaced, "lex", pos)
    kmers = em.values[em.mask].numpy().view(np.uint64)
    keys = np.unique(np.concatenate([
        rng.choice(kmers, kmers.size // 2),
        rng.integers(0, 2**64, 3000, dtype=np.uint64)]))
    arrs = [_inline_arrays(keys, np.random.default_rng(k), d)
            for d in ("cpu", cuda)]
    pc, nm = _pack(codes)
    for canon in ((False,) if spaced else (True, False)):
        args = (lproc, k, canon)
        kw = dict(positions=pos)
        mask = pl.encode_probe(pc.to(cuda), nm.to(cuda), ln.to(cuda), *args,
                               arrs[1], True, **kw)
        for nidx in (_nlist(codes, lengths, lproc),
                     _nlist(codes, lengths, lproc, 37,
                            (B * lproc, B * lproc + 5))):
            want = pl.encode_probe(pc, None, ln, *args, arrs[0], True,
                                   nidx=nidx, **kw)
            variant = "spaced sparse" if spaced else "sparse"
            before = pl.encode_probe.variants.get(variant, 0)
            got = pl.encode_probe(pc.to(cuda), None, ln.to(cuda), *args,
                                  arrs[1], True, nidx=nidx.to(cuda), **kw)
            assert pl.encode_probe.variants[variant] == before + 1
            _same(got, want)
            _same(got, [m.cpu() for m in mask])
            assert want[0].any() and (~want[0] & want[1]).any()
        # no N listed: every in-length window valid but the all-T ones
        empty = torch.full((64,), pl.N_SENTINEL, dtype=torch.int32)
        for nidx in (empty, empty[:0]):
            _same(pl.encode_probe(pc.to(cuda), None, ln.to(cuda), *args,
                                  arrs[1], True, nidx=nidx.to(cuda), **kw),
                  pl.encode_probe(pc, None, ln, *args, arrs[0], True,
                                  nidx=nidx, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("spaced", [False, True])
def test_encode_probe_sparse_kernel_many_ns_in_a_block(cuda, spaced):
    """Short reads, so a block of 128 positions spans many reads, and
    whole reads of Ns: a block's list past the 256 entries it stages is
    read where it lies."""
    k = 21
    pos = _positions(k) if spaced else None
    c = pos[-1] + 1 if spaced else k
    lproc = c + 7  # P = 8 positions a read
    rng = np.random.default_rng(7 + spaced)
    B = 512
    codes = rng.integers(0, 4, (B, lproc)).astype(np.int8)
    lengths = rng.integers(c - 2, lproc + 1, B).astype(np.int32)
    codes[20:60] = -1  # 40 reads of Ns: over a thousand entries in a block
    codes[rng.random((B, lproc)) < 0.03] = -1
    codes[np.arange(lproc)[None, :] >= lengths[:, None]] = -1
    keys = np.unique(rng.integers(0, 4 ** k, 5000, dtype=np.uint64))
    arrs = [_inline_arrays(keys, np.random.default_rng(1), d)
            for d in ("cpu", cuda)]
    pc, nm = _pack(codes)
    ln = torch.from_numpy(lengths)
    nidx = _nlist(codes, lengths, lproc)
    assert nidx.numel() > 1000
    args = (lproc, k, not spaced)
    want = pl.encode_probe(pc, None, ln, *args, arrs[0], True, positions=pos,
                           nidx=nidx)
    got = pl.encode_probe(pc.to(cuda), None, ln.to(cuda), *args, arrs[1],
                          True, positions=pos, nidx=nidx.to(cuda))
    _same(got, want)
    _same(got, pl.encode_probe(pc, nm, ln, *args, arrs[0], True,
                               positions=pos))
    assert not want[1][20:60].any() and want[1].any()


@pytest.mark.cuda
def test_encode_probe_sparse_refuses_what_the_kernel_does_not_take(cuda):
    table = KmerTable(np.arange(1, 100, dtype=np.uint64),
                      np.ones(99, dtype=np.uint64))
    arr = ProbeArrays.from_numpy(*table.arrays_np(), table.lgnb, table.vbits,
                                 cuda)
    pc = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    ln = torch.full((4,), 100, dtype=torch.int32, device=cuda)
    nidx = torch.full((64,), pl.N_SENTINEL, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="not both"):
        pl.encode_probe(pc, pc[:, :4], ln, 128, 31, True, arr, True,
                        nidx=nidx)
    with pytest.raises(ValueError, match="a list"):
        pl.encode_probe(pc, None, ln, 128, 31, True, arr, True,
                        nidx=nidx.view(8, 8))
    with pytest.raises(TypeError):
        pl.encode_probe(pc, None, ln, 128, 31, True, arr, True,
                        nidx=nidx.to(torch.int64))
    # 2^24 reads of 128 bases: flat positions reach the sentinel
    big = torch.zeros((1 << 24, 8), dtype=torch.int32, device=cuda)
    bln = torch.zeros(1 << 24, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="sentinel"):
        pl.encode_probe(big, None, bln, 128, 31, True, arr, True, nidx=nidx)
    del big, bln
    ranged = ProbeArrays(arr.slots, arr.vals, arr.inline, arr.lgnb,
                         arr.vbits, 0, arr.slots.shape[0])
    with pytest.raises(ValueError, match="bucket-range"):
        pl.encode_probe(pc, None, ln, 128, 31, True, ranged, True, nidx=nidx)


def _u16_rows(rng, c):
    """Eight reads in a width of 65,536 with lengths past 32,767 (65,535,
    65,534, 40,000, 32,768, 32,767), one of 300 and two shorter than the
    seed's span c; a few in-read Ns, among them at 32,767 and 32,768."""
    L = 65_536
    lengths = np.array([65_535, 65_534, 40_000, 32_768, 32_767, 300, c - 1,
                        0], dtype=np.int32)
    codes = rng.integers(0, 4, (8, L)).astype(np.int8)
    codes[0, [5, 32_767, 32_768, 65_000]] = -1
    codes[2, [39_999]] = -1
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return codes, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["mask", "none", "uncanonical", "sparse",
                                 "spaced", "spaced sparse", "range",
                                 "spaced range", "encode", "spaced encode"])
def test_encode_probe_kernel_reads_u16_lengths(cuda, how):
    """Every K1 instantiation on u16 lengths of 32,767-65,535 against its
    plain version, against the kernel on the same lengths as int32, and
    (mask) replayed from a captured CUDA graph."""
    k = 21
    pos = _positions(k) if how.startswith("spaced") else None
    c = pos[-1] + 1 if pos else k
    rng = np.random.default_rng(65_535 + len(how))
    codes, lengths = _u16_rows(rng, c)
    lproc = 65_535
    canon = pos is None and how != "uncanonical"
    cl = torch.from_numpy(codes)
    em = enc.minimizers(cl, torch.from_numpy(lengths), k, 1, canon, "lex", pos)
    kmers = em.values[em.mask].numpy().view(np.uint64)
    keys = np.unique(np.concatenate([
        rng.choice(kmers, kmers.size // 2),
        rng.integers(0, 2**64, 3000, dtype=np.uint64)]))
    cpu_arr = _inline_arrays(keys, np.random.default_rng(k), "cpu")
    if "range" in how:  # a psum rank's rows: the second quarter
        rows = cpu_arr.slots.shape[0] // 4
        cpu_arr = ProbeArrays(cpu_arr.slots[rows:2 * rows].contiguous(),
                              cpu_arr.vals, cpu_arr.inline, cpu_arr.lgnb,
                              cpu_arr.vbits, rows, rows)
    dev_arr = ProbeArrays(cpu_arr.slots.to(cuda), cpu_arr.vals.to(cuda),
                          cpu_arr.inline, cpu_arr.lgnb, cpu_arr.vbits,
                          cpu_arr.row0, cpu_arr.rows)
    pc, nm = _pack(codes)
    nm = None if how in ("none", "encode") else nm
    nidx = None
    if "sparse" in how:
        nm, nidx = None, _nlist(codes, lengths, lproc, 11)
    u16 = torch.from_numpy(lengths.astype(np.uint16))
    i32 = torch.from_numpy(lengths)

    def run(dev, ln):
        on = (lambda t: None if t is None else t.to(dev))
        arr = dev_arr if dev != "cpu" else cpu_arr
        if "encode" in how:
            return pl.encode_only(on(pc), on(nm), on(ln), lproc, k, canon, pos)
        return pl.encode_probe(on(pc), on(nm), on(ln), lproc, k, canon, arr,
                               True, pos, nidx=on(nidx))

    want = run("cpu", u16)
    _same(want, run("cpu", i32))
    got = run(cuda, u16)
    _same(got, want)
    _same(run(cuda, i32), want)
    valid = want[1]
    masked = nm is not None or nidx is not None  # row 2 ends in an N
    for r in range(5):  # the last window of each long read is its own
        v = np.flatnonzero(valid[r].numpy())
        assert int(v[-1]) == int(lengths[r]) - c - (r == 2 and masked), r
    assert not valid[6:].any()
    if how == "mask":  # a graph captured on the u16 lengths, replayed
        ins = [t.to(cuda) for t in (pc, nm, u16)]
        run_g = (lambda: pl.encode_probe(*ins, lproc, k, canon, dev_arr, True))
        run_g()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = run_g()
        g.replay()
        torch.cuda.synchronize()
        _same(out, want)


@pytest.mark.cuda
def test_minimizers_spaced_kernel_refuses_what_it_does_not_take(cuda):
    """A tile whose span and window do not fit in shared memory, offsets
    that do not increase, a canonical spaced seed."""
    c = torch.zeros((1, 20000), dtype=torch.int8, device=cuda)
    ln = torch.tensor([20000], dtype=torch.int32, device=cuda)
    wide = tuple(range(0, 31 * 600, 600)) + (18601,)
    with pytest.raises(ValueError, match="shared memory"):
        enc.minimizers(c, ln, 32, 8192, False, "lex", wide)
    with pytest.raises(ValueError, match="increasing"):
        enc.minimizers(c, ln, 3, 1, False, "lex", (0, 2, 2))
    with pytest.raises(ValueError, match="canonicalized"):
        enc.minimizers(c, ln, 3, 1, True, "lex", (0, 1, 3))


# -- the hash-scored phase 2: KB5 and the score::Hash instantiations of KB1
# -- and KB4 --------------------------------------------------------------------

U64_MAX = np.uint64(2**64 - 1)


def _score_map(rng, keys, mode):
    """A phase-1 map of ``keys``: 6 packed values (inline) or one a key
    (flat: more than the slot's index field holds)."""
    keys = np.unique(np.asarray(keys, dtype=np.uint64))
    v = (np.arange(keys.size, dtype=np.uint64) if mode == "flat" else
         rng.integers(0, 6, keys.size).astype(np.uint64))
    table = KmerTable(keys, ((v + np.uint64(7)) << np.uint64(32)) | v,
                      min_nb=0 if mode == "flat" else 1 << 10)
    assert table.arrays_np()[2] == (mode == "inline")
    return ScoreMap(table)


def _hash_rows(rng, c, W, mode, k, canon, positions):
    """``_discipline_rows`` with a poly-A run, and a phase-1 map of half
    the seeds of every row but the last two (whose seeds are missing), and
    of 0 and U64_MAX."""
    codes, lengths = _discipline_rows(rng, c, W)
    codes[12, : c + 3 * W] = 0
    lengths[12] = codes.shape[1]
    em = enc.minimizers(torch.from_numpy(codes[:-2]),
                        torch.from_numpy(lengths[:-2]), k, 1, canon, "lex",
                        positions)
    seeds = np.unique(em.values[em.mask].numpy().view(np.uint64))
    keep = rng.choice(seeds, seeds.size // 2, replace=False)
    return codes, lengths, _score_map(
        rng, np.concatenate([keep, np.array([0, U64_MAX], np.uint64)]), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["inline", "flat"])
def test_lookup_scores_kernel_matches_plain(cuda, mode):
    rng = np.random.default_rng(17)
    stored = rng.integers(0, 2**64, 50_000, dtype=np.uint64)
    smap = _score_map(rng, np.concatenate(
        [stored, np.array([0, U64_MAX], np.uint64)]), mode)
    q = np.concatenate([rng.choice(stored, 40_000),
                        rng.integers(0, 2**64, 40_000, dtype=np.uint64),
                        np.array([0, U64_MAX, 1], np.uint64)])
    qt = torch.from_numpy(q.view(np.int64))
    want = smap.lookup_scores(qt)
    assert (want.numpy().view(np.uint64) == smap.lookup_scores(q)).all()
    before = lookup_scores.launches
    got = smap.lookup_scores(qt.to(cuda))
    assert lookup_scores.launches == before + 1
    _same([got], [want])
    # a (rows, cols) batch, and the image passed by hand
    _same([lookup_scores(qt[:-3].view(400, 200).to(cuda), smap.arrays(cuda))],
          [want[:-3].view(400, 200)])


def _large_map(rng, mode):
    """A phase-1 map of random keys, 0 and U64_MAX in an image of 64 MiB:
    2^21 rows inline, 2^20 flat (with its values; more keys than its
    18-bit index field holds): the size that the sliced design of
    ``tools/kernel_ab.py`` (``kb5-sliced``) cuts into 4 slices."""
    lgnb = 21 if mode == "inline" else 20
    keys = np.unique(np.concatenate([
        rng.integers(0, 2**64, 200_000 if mode == "inline" else 400_000,
                     dtype=np.uint64),
        np.array([0, U64_MAX], np.uint64)]))
    v = (np.arange(keys.size, dtype=np.uint64) if mode == "flat" else
         rng.integers(0, 6, keys.size).astype(np.uint64))
    table = KmerTable(keys, ((v + np.uint64(7)) << np.uint64(32)) | v,
                      min_nb=1 << lgnb)
    assert table.lgnb == lgnb and table.arrays_np()[2] == (mode == "inline")
    return ScoreMap(table)


def _kb5_buckets(q, lgnb):
    """The first and second buckets of u64 k-mers ``q``."""
    from bonsai_tpu_torch.db.table import BSALT, splitmix64_np

    h = splitmix64_np(q)
    mask = np.uint64((1 << lgnb) - 1)
    b1 = h & mask
    return b1, b1 ^ (splitmix64_np((h >> np.uint64(lgnb)) ^ np.uint64(BSALT))
                     & mask)


def _kb5_same(cuda, smap, q):
    """KB5 on u64 k-mers ``q`` equal to its plain version, one launch."""
    qt = torch.from_numpy(q.view(np.int64))
    want = smap.lookup_scores(qt)
    before = lookup_scores.launches
    got = lookup_scores(qt.to(cuda), smap.arrays(cuda))
    assert lookup_scores.launches == before + 1
    _same([got], [want])
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["inline", "flat"])
def test_lookup_scores_kernel_large_image(cuda, mode):
    """A 64 MiB image: 2^(lgnb - 1) k-mers half stored, 0, U64_MAX and
    repeats; every k-mer's first bucket in the image's first quarter and
    every missing one's second bucket outside it; n = 1; a (rows, cols)
    batch."""
    rng = np.random.default_rng(71 + (mode == "flat"))
    smap = _large_map(rng, mode)
    lgnb = smap.table.lgnb
    stored = smap.table.keys_sorted
    nq = 1 << (lgnb - 1)
    q = np.concatenate([rng.choice(stored, nq // 2),
                        rng.integers(0, 2**64, nq // 2 - 5, dtype=np.uint64),
                        np.array([0, U64_MAX, 1, 0, U64_MAX], np.uint64)])
    want = _kb5_same(cuda, smap, q)
    assert (want[-5:].numpy().view(np.uint64) != U64_MAX).sum() == 4
    shift = np.uint64(lgnb - 2)
    b1, _ = _kb5_buckets(stored, lgnb)
    cand = rng.integers(0, 2**64, 4 * nq, dtype=np.uint64)
    c1, c2 = _kb5_buckets(cand, lgnb)
    lacking = cand[((c1 >> shift) == 0) & ((c2 >> shift) != 0)]
    want = _kb5_same(cuda, smap, np.concatenate([stored[(b1 >> shift) == 0],
                                                 lacking]))
    assert (want[-lacking.size:].numpy().view(np.uint64) == U64_MAX).all()
    _kb5_same(cuda, smap, stored[:1])
    qt = torch.from_numpy(q[: (q.size // 64) * 64].view(np.int64))
    got = lookup_scores(qt.view(-1, 64).to(cuda), smap.arrays(cuda))
    _same([got], [smap.lookup_scores(qt).view(-1, 64)])


@pytest.mark.cuda
def test_lookup_scores_kernel_in_a_cuda_graph(cuda):
    """KB5 captured in a CUDA graph, as ``chip_smoke.py`` and
    ``kernel_ab`` time it, and replayed: equal to the eager call, twice."""
    rng = np.random.default_rng(75)
    smap = _large_map(rng, "inline")
    arr = smap.arrays(cuda)
    n = 1 << (smap.table.lgnb - 1)
    q = np.concatenate([rng.choice(smap.table.keys_sorted, n // 2),
                        rng.integers(0, 2**64, n // 2, dtype=np.uint64)])
    qt = torch.from_numpy(q.view(np.int64)).to(cuda)
    eager = lookup_scores(qt, arr)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        lookup_scores(qt, arr)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lookup_scores(qt, arr)
    for _ in range(2):
        out.fill_(0)
        graph.replay()
        torch.cuda.synchronize(cuda)
        assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["inline", "flat"])
@pytest.mark.parametrize("W", [2, 13, 16])
@pytest.mark.parametrize("k", [21, 25, 32])
def test_minimizers_hash_kernel_matches_plain(cuda, k, W, mode):
    """The canonical windowed discipline of build -t|-f: an N window pushes
    0, which is probed (0 is stored)."""
    rng = np.random.default_rng(k * 17 + W)
    codes, lengths, smap = _hash_rows(rng, k, W, mode, k, True, None)
    before = enc.minimizers.variants.get("hash", 0)
    want = _run_kb1(cuda, codes, lengths, k, W, True, "hash", None, smap)
    assert enc.minimizers.variants["hash"] == before + 1
    assert want.mask.any()
    codes, lengths = _kb1_edge_rows(rng, k, W)
    _run_kb1(cuda, codes, lengths, k, W, True, "hash", None, smap)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["inline", "flat"])
@pytest.mark.parametrize("W", [2, 13, 16])
@pytest.mark.parametrize("k", sorted(SPACINGS))
def test_minimizers_spaced_hash_kernel_matches_plain(cuda, k, W, mode):
    """The spaced windowed discipline of build -S -w -t|-f: an N seed
    pushes U64_MAX, which is probed (U64_MAX is stored; at k = 32 it is
    also a real all-T k-mer)."""
    pos = _positions(k)
    rng = np.random.default_rng(k * 19 + W)
    codes, lengths, smap = _hash_rows(rng, pos[-1] + 1, W, mode, k, False,
                                      pos)
    before = enc.minimizers.variants.get("spaced hash", 0)
    want = _run_kb1(cuda, codes, lengths, k, W, False, "hash", pos, smap)
    assert enc.minimizers.variants["spaced hash"] == before + 1
    assert want.mask.any()
    codes, lengths = _kb1_edge_rows(rng, pos[-1] + 1, W)
    _run_kb1(cuda, codes, lengths, k, W, False, "hash", pos, smap)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["inline", "flat"])
@pytest.mark.parametrize("W", [2, 13, 16])
@pytest.mark.parametrize("k", [21, 25, 32])
def test_compacted_minimizers_hash_kernel_matches_plain(cuda, k, W, mode):
    """The uncanonical windowed discipline of build -C -w -t|-f, with
    0 < n_valid < W tails; then rows of several tiles."""
    rng = np.random.default_rng(k * 23 + W)
    codes, lengths, smap = _hash_rows(rng, k, W, mode, k, False, None)
    before = enc.compacted_minimizers.variants.get("hash", 0)
    want = _run_kb4(cuda, codes, lengths, k, W, "hash", smap)
    assert enc.compacted_minimizers.variants["hash"] == before + 1
    assert want.mask[:, 0].any() and want.mask[:, 1:].any()
    codes, lengths = _kb1_edge_rows(rng, k, W)
    codes[4, : 2 * KB1_TILE] = -1
    lengths[4] = codes.shape[1]
    _run_kb4(cuda, codes, lengths, k, W, "hash", smap)


@pytest.mark.cuda
def test_compacted_minimizers_hash_kernel_short_rows_twice(cuda):
    """3000 rows of at most 40 bases (P < W: the tail alone), then two
    calls back to back on one stream."""
    rng = np.random.default_rng(29)
    codes = rng.integers(0, 4, (3000, 40)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.05] = -1
    lengths = rng.integers(0, 41, 3000).astype(np.int32)
    codes[np.arange(40)[None, :] >= lengths[:, None]] = -1
    em = enc.minimizers(torch.from_numpy(codes), torch.from_numpy(lengths),
                        21, 1, False)
    smap = _score_map(rng, em.values[em.mask].numpy().view(np.uint64)[::2],
                      "inline")
    _run_kb4(cuda, codes, lengths, 21, 13, "hash", smap)
    cases = [_discipline_rows(rng, 25, 13, L=9000, B=16) for _ in range(2)]
    got = [enc.compacted_minimizers(torch.from_numpy(c).to(cuda),
                                    torch.from_numpy(n).to(cuda), 25, 13,
                                    "hash", smap) for c, n in cases]
    for g, (c, n) in zip(got, cases):
        _same(g, enc.compacted_minimizers(torch.from_numpy(c),
                                          torch.from_numpy(n), 25, 13,
                                          "hash", smap))


def _high_load_map(rng, keys, mode, n=31_000):
    """A phase-1 map of ``keys`` (fewer than n), 0 and U64_MAX, padded
    with random keys to n: 2^13 buckets 95% full, so that many keys sit in
    their second bucket."""
    keys = np.unique(np.concatenate([np.asarray(keys, np.uint64),
                                     np.array([0, U64_MAX], np.uint64)]))
    pad = np.setdiff1d(rng.integers(1, 2**64 - 1, n, dtype=np.uint64), keys)
    keys = np.unique(np.concatenate([keys, pad[: n - keys.size]]))
    v = (np.arange(keys.size, dtype=np.uint64) if mode == "flat" else
         rng.integers(0, 6, keys.size).astype(np.uint64))
    table = KmerTable(keys, ((v + np.uint64(7)) << np.uint64(32)) | v,
                      load_factor=0.97)
    assert table.nb == 1 << 13 and table.arrays_np()[2] == (mode == "inline")
    return ScoreMap(table)


def _batch_rows(rng, c, W):
    """``_kb1_edge_rows`` (tile edges, runs of positions that are no
    multiple of a probe batch), three rows of 1, 2 and 3 seeds (fewer than
    a batch) and a row all N across two tiles."""
    codes, lengths = _kb1_edge_rows(rng, c, W)
    L = codes.shape[1]
    short = rng.integers(0, 4, (3, L)).astype(np.int8)
    short_len = c + np.arange(3, dtype=np.int32)
    short[np.arange(L)[None, :] >= short_len[:, None]] = -1
    codes = np.concatenate([codes, short, np.full((1, L), -1, np.int8)])
    return codes, np.concatenate([lengths, short_len, [L]]).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["inline", "flat"])
@pytest.mark.parametrize("W", [2, 5, 16])
@pytest.mark.parametrize("disc", ["kb1", "kb1 spaced", "kb4"])
def test_hash_kernels_probe_batches(cuda, disc, W, mode):
    """The batched probe of KB1's and KB4's hash instantiations against
    the plain version, exactly: ``_batch_rows`` (an all-N tile probes 0,
    or U64_MAX spaced, both stored) against a map 95% full that holds half
    their seeds; then against a map that lacks every seed, where every
    score is U64_MAX.  KB4 runs both calls back to back."""
    from bonsai_tpu_torch.db.table import lookup_scores_plain
    from bonsai_tpu_torch.tools.bounds import hash_queries, probe_rows

    k, pos = (21, _positions(21)) if disc == "kb1 spaced" else (25, None)
    c = pos[-1] + 1 if pos else k
    canon = {"kb1": True, "kb1 spaced": False, "kb4": None}[disc]
    rng = np.random.default_rng(W * 31 + len(disc) + len(mode))
    codes, lengths = _batch_rows(rng, c, W)
    ct, lt = torch.from_numpy(codes), torch.from_numpy(lengths)
    q = hash_queries(ct, lt, k, canon, pos)
    seeds = np.unique(q.numpy().view(np.uint64))
    full = _high_load_map(rng, rng.choice(seeds, seeds.size // 2,
                                          replace=False), mode)
    probes, rows, _ = probe_rows(q, full.arrays(torch.device("cpu")))
    assert rows > 1.2 * probes  # a fifth of the probes read a second row
    lacking = _score_map(rng, rng.integers(1, 2**64 - 1, 5000,
                                           dtype=np.uint64), mode)
    assert (lookup_scores_plain(q, lacking.arrays(torch.device("cpu")))
            == -1).all()
    if disc == "kb4":
        want = [_run_kb4(cuda, codes, lengths, k, W, "hash", m)
                for m in (full, lacking)]
        assert want[0].mask[:, 0].any() and want[0].mask[:, 1:].any()
        got = [enc.compacted_minimizers(ct.to(cuda), lt.to(cuda), k, W,
                                        "hash", m) for m in (full, lacking)]
        for g, w in zip(got, want):
            _same(g, w)
    else:
        for m in (full, lacking):
            _run_kb1(cuda, codes, lengths, k, W, canon, "hash", pos, m)


@pytest.mark.cuda
def test_hash_kernels_need_a_score_map(cuda):
    c = torch.zeros((1, 200), dtype=torch.int8, device=cuda)
    ln = torch.tensor([200], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="score_map"):
        enc.minimizers(c, ln, 21, 10, True, "hash")
    with pytest.raises(ValueError, match="score_map"):
        enc.compacted_minimizers(c, ln, 21, 10, "hash")


# -- the Python API's disciplines: the Shannon score (scheme entropy) and
# -- the other alphabets' folds in KB1 and KB4, and KR1 cyclic_hashes ---------


def _run_gen(cuda, kb, codes, lengths, k, W, scheme, it, positions=None,
             score_map=None, canon=False):
    """KB1 (``kb`` "kb1") or KB4 on the card against its plain version."""
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    if kb == "kb1":
        def call(c, ln):
            return enc.minimizers(c, ln, k, W, False, scheme, positions,
                                  score_map, it)
        wrapper = enc.minimizers
    else:
        def call(c, ln):
            return enc.compacted_minimizers(c, ln, k, W, scheme, score_map,
                                            it, canon)
        wrapper = enc.compacted_minimizers
    want = call(c, ln)
    before = wrapper.launches
    got = call(c.to(cuda), ln.to(cuda))
    assert wrapper.launches == before + (1 if want.values.shape[1] else 0)
    _same(got, want)
    return want


# spaced DNA seeds of the Shannon tests beside SPACINGS': one base, and
# five bases over a span of 48 (gathered, past the rolled span of 32)
SHANNON_SEEDS = {1: (0,), 5: (0, 9, 20, 33, 47)}


def _shannon_rows(rng, L=300):
    """Rows whose seeds hold one code (each count k: all A, all C, all
    G, all T), ACGT repeated (its k-mers of k = 4j are their own reverse
    complements), and complement-heavy rows: A/T only, C/G only, 95% A
    with T, 95% G with C (complement swaps the counts of A and T, C and
    G, and so the order in which the Shannon terms are added)."""
    rows = [np.full(L, c) for c in range(4)]
    rows.append(np.tile(np.arange(4), L // 4 + 1)[:L])
    rows.append(rng.choice([0, 3], L))
    rows.append(rng.choice([1, 2], L))
    rows.append(np.where(rng.random(L) < 0.95, 0, 3))
    rows.append(np.where(rng.random(L) < 0.95, 2, 1))
    codes = np.stack(rows).astype(np.int8)
    return codes, np.full(len(rows), L, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", sorted(SPACINGS) + sorted(SHANNON_SEEDS))
@pytest.mark.parametrize("W", [2, 13, 16])
def test_minimizers_spaced_shannon_kernel_matches_plain(cuda, k, W):
    """DNA spaced seeds under the Shannon score (eps 1e-4): an N seed
    scores 0x8000000000000000, the counts run over the k included
    bases; one base, spans past 32 (the gathered seeds), seeds of one
    code and complement-heavy rows."""
    pos = SHANNON_SEEDS.get(k) or _positions(k)
    rng = np.random.default_rng(k * 31 + W)
    codes, lengths = _discipline_rows(rng, pos[-1] + 1, W)
    before = enc.minimizers.variants.get("spaced shannon", 0)
    want = _run_gen(cuda, "kb1", codes, lengths, k, W, "entropy",
                    InputType.DNA, pos)
    assert enc.minimizers.variants["spaced shannon"] == before + 1
    assert want.mask.any()
    codes, lengths = _kb1_edge_rows(rng, pos[-1] + 1, W)
    _run_gen(cuda, "kb1", codes, lengths, k, W, "entropy", InputType.DNA, pos)
    codes, lengths = _shannon_rows(rng)
    _run_gen(cuda, "kb1", codes, lengths, k, W, "entropy", InputType.DNA, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 13, 31, 32])
@pytest.mark.parametrize("W", [1, 2, 13, 16])
@pytest.mark.parametrize("canon", [False, True])
def test_compacted_minimizers_shannon_kernel_matches_plain(cuda, k, W, canon):
    """DNA contiguous seeds under the Shannon score (eps 1e-3), selected
    uncanonical, the emitted values canonicalized with ``canon``; rows of
    several tiles, a tile with no valid seed; k = 1 and k = 32 (all 64
    bits), seeds of one code, palindromic and complement-heavy rows.
    The window launch scores each k-mer: the wrapper's scratch holds no
    score stream (its pointer is null in the kernel)."""
    rng = np.random.default_rng(k * 37 + W + canon)
    codes, lengths = _discipline_rows(rng, k, W)
    want = _run_gen(cuda, "kb4", codes, lengths, k, W, "entropy",
                    InputType.DNA, canon=canon)
    assert want.mask[:, 1:].any()
    codes, lengths = _kb1_edge_rows(rng, k, W)
    codes[4, : 2 * KB1_TILE] = -1
    lengths[4] = codes.shape[1]
    _run_gen(cuda, "kb4", codes, lengths, k, W, "entropy", InputType.DNA,
             canon=canon)
    codes, lengths = _shannon_rows(rng)
    _run_gen(cuda, "kb4", codes, lengths, k, W, "entropy", InputType.DNA,
             canon=canon)


@pytest.mark.cuda
@pytest.mark.parametrize("disc", ["kb4", "kb1 spaced"])
def test_dna_shannon_kernels_keep_the_order_of_the_adds(cuda, disc):
    """KB4 -k 31 -w 40 canonical and KB1 -k 21 -S 0x16,1x4 -w 40 emit the
    plain version's minimizers on the rows of ``tests/shannon_order.py``,
    where adding G's term before C's would emit others
    (``tests/test_torch_entropy.py`` shows both against the JAX
    package)."""
    import shannon_order as so

    if disc == "kb4":
        (codes, lengths), call, kern = so.kb4_rows(), so.kb4_call, \
            enc.compacted_minimizers
    else:
        (codes, lengths), call, kern = so.kb1_spaced_rows(), \
            so.kb1_spaced_call, enc.minimizers
    ct, lt = torch.from_numpy(codes), torch.from_numpy(lengths)
    want = call(ct, lt)
    with so.swapped_order():
        other = call(ct, lt)
    assert ((want.values != other.values) | (want.mask != other.mask)).any(
        -1).all()
    before = kern.launches
    got = call(ct.to(cuda), lt.to(cuda))
    assert kern.launches == before + 1
    _same(got, want)


RADIX_TYPES = [t for t in InputType if t != InputType.DNA]


def _radix_codes(rng, codes4, it):
    """DNA rows of ``_discipline_rows`` / ``_kb1_edge_rows`` as rows of
    the type's codes: each base a random code, T the largest (a row of T
    folds to the largest k-mer: PROTEIN_3BIT at k = 22 to U64_MAX), -1
    kept; PROTEIN (bytes) also gets bytes past 127 (negative int8,
    ambiguous)."""
    hi = 128 if radix_of(it) == 256 else radix_of(it)
    out = rng.integers(0, hi, codes4.shape).astype(np.int8)
    out[codes4 == 3] = hi - 1
    out[codes4 < 0] = -1
    if hi == 128:
        past = (rng.random(codes4.shape) < 0.01) & (codes4 >= 0)
        out[past] = rng.integers(-128, 0, int(past.sum()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("it", RADIX_TYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("which", ["one", "mid", "nper64"])
def test_radix_kernels_match_plain(cuda, it, which):
    """Every other alphabet's fold (shift-or and mask, multiply-add and
    modulus) in KB1 (unwindowed contiguous; spaced at W = 1 and 13) and
    KB4 (W = 1 and 13), under lex, entropy-file and Shannon (the scheme
    hash of these types: ``test_radix_hash_kernels_match_plain``)."""
    n = nper64(it)
    k = {"one": 1, "mid": (n + 1) // 2, "nper64": n}[which]
    rng = np.random.default_rng(int(it) * 41 + k)
    pos = tuple(range(0, 2 * k - 1, 2))  # every other character
    for spaced in (False, True):
        c = pos[-1] + 1 if spaced else k
        for rows in (_discipline_rows(rng, c, 13), _kb1_edge_rows(rng, c, 13)):
            codes, lengths = _radix_codes(rng, rows[0], it), rows[1]
            p = pos if spaced else None
            want = _run_gen(cuda, "kb1", codes, lengths, k, 1, "lex", it, p)
            assert want.mask.any()
            for W in (1, 13):
                for scheme in ("lex", "entropy-file", "entropy"):
                    if spaced:
                        _run_gen(cuda, "kb1", codes, lengths, k, W, scheme,
                                 it, pos)
                    else:
                        _run_gen(cuda, "kb4", codes, lengths, k, W, scheme,
                                 it)


@pytest.mark.cuda
@pytest.mark.parametrize("it", RADIX_TYPES, ids=lambda t: t.name)
def test_radix_rolled_fold_kernel_matches_plain(cuda, it):
    """KB1's rolled fold of a contiguous seed (W = 1), at every k from 1 to
    the type's largest, on rows that cross a thread's run and a tile, with
    an ambiguous code going out of a roll (a run's first and 15th codes);
    each launch counted as "radix rolled"."""
    for k in range(1, nper64(it) + 1):
        rng = np.random.default_rng(int(it) * 97 + k)
        codes4, lengths = _kb1_edge_rows(rng, k, 1)
        codes4[3, 2 * KB1_RUN + 14] = -1
        codes = _radix_codes(rng, codes4, it)
        before = enc.minimizers.variants.get("radix rolled", 0)
        want = _run_gen(cuda, "kb1", codes, lengths, k, 1, "lex", it)
        assert enc.minimizers.variants["radix rolled"] == before + 1
        assert want.mask.any() and not want.mask.all()


@pytest.mark.cuda
def test_radix_kernels_keep_a_real_u64_max(cuda):
    """PROTEIN_3BIT at k = 22 folds 66 bits: 22 residues of code 7 are
    U64_MAX, emitted unwindowed (a valid seed) and dropped as a spaced
    emission, as the plain versions do."""
    it = InputType.PROTEIN_3BIT
    codes = np.full((2, 200), 7, np.int8)
    codes[1, 100] = -1
    lengths = np.array([200, 180], np.int32)
    want = _run_gen(cuda, "kb1", codes, lengths, 22, 1, "lex", it)
    assert (want.values[want.mask] == -1).all() and want.mask.any()
    want = _run_gen(cuda, "kb1", codes, lengths, 22, 1, "lex", it,
                    tuple(range(0, 43, 2)))
    assert not want.mask.any()


def _radix_map(rng, codes, lengths, k, positions, it, mode):
    """A phase-1 map of half the seeds of ``codes`` of the type ``it``
    (contiguous, or spaced at ``positions``; the last two rows left out,
    so their seeds are missing), and of 0 and U64_MAX."""
    em = enc.minimizers(torch.from_numpy(codes[:-2]),
                        torch.from_numpy(lengths[:-2]), k, 1, False, "lex",
                        positions, it=it)
    seeds = np.unique(em.values[em.mask].numpy().view(np.uint64))
    keep = rng.choice(seeds, seeds.size // 2, replace=False)
    return _score_map(
        rng, np.concatenate([keep, np.array([0, U64_MAX], np.uint64)]), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["inline", "flat"])
@pytest.mark.parametrize("W", [2, 13, 16])
@pytest.mark.parametrize("which", ["mid", "nper64"])
@pytest.mark.parametrize("it", RADIX_TYPES, ids=lambda t: t.name)
def test_radix_hash_kernels_match_plain(cuda, it, which, W, mode):
    """The scheme hash of every other alphabet: KB1's spaced instantiation
    (every other character) and KB4's windowed one, each k-mer probed as
    its fold leaves it (the mask or the modulus applied), against maps of
    half their own seeds; rows with ambiguous codes, a row of the largest
    code (PROTEIN_3BIT at k = 22: a real U64_MAX, probed and, spaced,
    dropped), thread-run and tile edges (KB1) and KB4's halo rows; each
    launch counted as "radix hash"."""
    n = nper64(it)
    k = {"mid": (n + 1) // 2, "nper64": n}[which]
    rng = np.random.default_rng(int(it) * 53 + k * 7 + W)
    pos = tuple(range(0, 2 * k - 1, 2))
    codes4, lengths = _discipline_rows(rng, pos[-1] + 1, W)
    codes = _radix_codes(rng, codes4, it)
    smap = _radix_map(rng, codes, lengths, k, pos, it, mode)
    before = enc.minimizers.variants.get("radix hash", 0)
    want = _run_gen(cuda, "kb1", codes, lengths, k, W, "hash", it, pos, smap)
    assert enc.minimizers.variants["radix hash"] == before + 1
    assert want.mask.any()
    codes4, lengths = _kb1_edge_rows(rng, pos[-1] + 1, W)
    _run_gen(cuda, "kb1", _radix_codes(rng, codes4, it), lengths, k, W,
             "hash", it, pos, smap)
    codes4, lengths = _discipline_rows(rng, k, W)
    codes = _radix_codes(rng, codes4, it)
    smap = _radix_map(rng, codes, lengths, k, None, it, mode)
    before = enc.compacted_minimizers.variants.get("radix hash", 0)
    want = _run_gen(cuda, "kb4", codes, lengths, k, W, "hash", it,
                    score_map=smap)
    assert enc.compacted_minimizers.variants["radix hash"] == before + 1
    assert want.mask[:, 1:].any()
    codes4, lengths = _halo_rows(rng, k, W)
    want = _run_gen(cuda, "kb4", _radix_codes(rng, codes4, it), lengths, k,
                    W, "hash", it, score_map=smap)
    if it != InputType.PROTEIN:  # bytes past 127 add ambiguous codes
        _check_halo_counts(want, W)


@pytest.mark.cuda
def test_radix_hash_kernels_probe_a_real_u64_max(cuda):
    """PROTEIN_3BIT at k = 22: a run of code 7 folds to U64_MAX, which
    phase 1 stores; KB4 scores it by its stored value and emits it, KB1
    spaced probes it and drops the emission, as the plain versions do."""
    it = InputType.PROTEIN_3BIT
    rng = np.random.default_rng(22)
    codes = rng.integers(0, 7, (3, 400)).astype(np.int8)
    codes[:, 100:160] = 7
    codes[2, 130] = -1
    lengths = np.array([400, 350, 400], np.int32)
    smap = _score_map(rng, np.array([0, U64_MAX], np.uint64), "inline")
    want = _run_gen(cuda, "kb4", codes, lengths, 22, 9, "hash", it,
                    score_map=smap)
    assert (want.values[want.mask] == -1).any()
    want = _run_gen(cuda, "kb1", codes, lengths, 22, 9, "hash", it,
                    tuple(range(0, 43, 2)), smap)
    assert want.mask.any() and not (want.values[want.mask] == -1).any()


@pytest.mark.cuda
def test_radix_hash_instantiations_fit_an_sm(cuda):
    """The blocks a SM of the two new hash instantiations at phase 9j's
    shapes (KB1 PROTEIN_6 -k 12 -S 1x11 -w 30: span 23, W = 8; KB4
    PROTEIN20 -k 7 -w 20: W = 14) and at the largest window: at least one,
    no CUDA error."""
    lib = kernels.get_lib()
    for W in (8, 8192 - 22):
        assert lib.bk_minimizers_hash_blocks_per_sm(1, 23, W, 1) >= 1
    for W in (14, 8192):
        assert lib.bk_compacted_minimizers_hash_blocks_per_sm(W, 1) >= 1


KB4_TILE = 4096  # csrc/compacted_minimizers.cu: seed positions a tile


def _halo_rows(rng, k, W):
    """Rows of six KB4 tiles for its forward halo (the W - 1 valid seeds
    past a tile): 2% Ns; an N run of more than two tiles right after tile
    0, so that tile 0's halo skips whole tiles; no valid seed in tiles 0,
    3 and 5 (the start, the middle and the end of the row); n_valid = W -
    1, W and W + 1, the seeds in runs in tiles 0, 2 and 4; no N at all."""
    T = KB4_TILE
    L = 6 * T + k - 1 + 37
    codes = rng.integers(0, 4, (7, L)).astype(np.int8)
    codes[0][rng.random(L) < 0.02] = -1
    codes[1, T: 3 * T + 1000] = -1
    codes[2, : T] = -1
    codes[2, 3 * T: 4 * T] = -1
    codes[2, 5 * T:] = -1
    for row, n in ((3, W - 1), (4, W), (5, W + 1)):
        codes[row] = -1
        for i, m in enumerate((n // 3, n // 3, n - 2 * (n // 3))):
            if m:
                codes[row, 2 * i * T: 2 * i * T + m + k - 1] = rng.integers(
                    0, 4, m + k - 1)
    return codes, np.full(7, L, np.int32)


def _check_halo_counts(want, W):
    """Rows 3-5 of ``_halo_rows``: n_valid = W - 1 emits the tail alone,
    W the first window alone, W + 1 the first two."""
    m = want.mask
    assert m[3, 0] and not m[3, 1:].any()
    assert m[4, 1] and not m[4, 0] and not m[4, 2:].any()
    assert m[5, 1:3].all() and not m[5, 0] and not m[5, 3:].any()


# (scheme, input type, k, canon) of each KB4 instantiation: lex,
# entropy-file, hash, DNA Shannon (uncanonical and canonical), radix lex
# (multiply-add), radix Shannon (one register of counts, two, and
# PROTEIN's passes)
HALO_KINDS = {
    "lex": ("lex", InputType.DNA, 31, False),
    "entropy-file": ("entropy-file", InputType.DNA, 25, False),
    "hash": ("hash", InputType.DNA, 25, False),
    "shannon": ("entropy", InputType.DNA, 31, False),
    "shannon-canon": ("entropy", InputType.DNA, 13, True),
    "radix-lex": ("lex", InputType.PROTEIN_14, 10, False),
    "radix-shannon": ("entropy", InputType.PROTEIN20, 7, False),
    "radix-shannon-2reg": ("entropy", InputType.PROTEIN20, 14, False),
    "radix-shannon-passes": ("entropy", InputType.PROTEIN, 5, False),
    "radix-hash": ("hash", InputType.PROTEIN20, 7, False),
    "radix-hash-shift": ("hash", InputType.PROTEIN_3BIT, 22, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("W", [13, 4097, 8192])
@pytest.mark.parametrize("kind", sorted(HALO_KINDS))
def test_compacted_minimizers_kernel_forward_halo(cuda, kind, W):
    """Every KB4 instantiation on ``_halo_rows``: halos longer than a
    tile (W = 4097, 8192) and within one (W = 13), halos that skip whole
    tiles, tiles with no valid seed, n_valid = W - 1, W, W + 1."""
    scheme, it, k, canon = HALO_KINDS[kind]
    rng = np.random.default_rng(W + k + len(kind))
    codes, lengths = _halo_rows(rng, k, W)
    smap = None
    if it != InputType.DNA:
        codes = _radix_codes(rng, codes, it)
    if scheme == "hash":
        em = enc.minimizers(torch.from_numpy(codes), torch.from_numpy(lengths),
                            k, 1, False, it=it)
        smap = _score_map(rng, em.values[em.mask].numpy().view(np.uint64)[::2],
                          "inline")
    want = _run_gen(cuda, "kb4", codes, lengths, k, W, scheme, it,
                    score_map=smap, canon=canon)
    if it != InputType.PROTEIN:  # bytes past 127 add ambiguous codes
        _check_halo_counts(want, W)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [13, 4097, 8192])
def test_compacted_stream_kernel_forward_halo(cuda, W):
    """KB4's stream source on the validity of ``_halo_rows`` (k = 31):
    random values, halos across and past tiles, n_valid = W - 1, W, W + 1."""
    rng = np.random.default_rng(W)
    codes, lengths = _halo_rows(rng, 31, W)
    kmers, invalid = enc._pack(torch.from_numpy(codes), 31, None,
                               InputType.DNA)
    valid = (~invalid).contiguous()
    vals = _u64s(rng, valid.numel()).reshape(valid.shape)
    want = enc.compacted_stream_plain(vals, valid, W)
    _check_halo_counts(want, W)
    _same(enc.compacted_stream(vals.to(cuda), valid.to(cuda), W), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["PROTEIN20", "PROTEIN_6"])
@pytest.mark.parametrize("kb", ["kb4", "kb1"])
def test_radix_shannon_kernels_keep_the_order_of_the_adds(cuda, name, kb):
    """KB4 (contiguous) and KB1 (every other code) of PROTEIN20 at k = 14
    and PROTEIN_6 at k = 24 emit the plain version's minimizers on the
    rows of ``tests/shannon_order.py`` ``radix_rows``, where another order
    of the terms' additions would emit others (``tests/test_torch_
    entropy.py`` shows both against the JAX package)."""
    import shannon_order as so

    codes, lengths = so.radix_rows(name, kb)
    call = (so.radix_kb4_call if kb == "kb4" else so.radix_kb1_call)(name)
    ct, lt = torch.from_numpy(codes), torch.from_numpy(lengths)
    want = call(ct, lt)
    with so.radix_other_order(name):
        other = call(ct, lt)
    assert ((want.values != other.values) | (want.mask != other.mask)).any(
        -1).all()
    kern = enc.compacted_minimizers if kb == "kb4" else enc.minimizers
    before = kern.launches
    got = call(ct.to(cuda), lt.to(cuda))
    assert kern.launches == before + 1
    _same(got, want)


def _rolling_rows(rng, L, n_chars=4):
    """Rows with 3% Ns, Ns at thread-run and tile edges, an N run longer
    than most k, an all-N row and a row of one code."""
    codes = rng.integers(0, n_chars, (6, L)).astype(np.int8)
    codes[rng.random((6, L)) < 0.03] = -1
    for p in (0, KB1_RUN - 1, KB1_RUN, KB1_TILE - 1, KB1_TILE,
              KB1_TILE + KB1_RUN):
        codes[1, p] = -1
    codes[2, KB1_TILE - 300: KB1_TILE + 1200] = -1
    codes[3] = -1
    codes[4] = n_chars - 1
    return codes


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 63, 64, 65, 200, 1000])
@pytest.mark.parametrize("mode", ["forward", "canon", "nthash"])
def test_cyclic_hashes_kernel_matches_plain(cuda, k, mode):
    rng = np.random.default_rng(k * 43 + len(mode))
    codes = _rolling_rows(rng, 2 * KB1_TILE + 37 + k)
    renc = rolling.RollingEncoder(k, mode != "forward", nthash=mode == "nthash")
    c = torch.from_numpy(codes)
    want = renc.hashes(c)
    before = rolling.cyclic_hashes.launches
    got = renc.hashes(c.to(cuda))
    assert rolling.cyclic_hashes.launches == before + 1
    _same(got, want)
    assert want[1][3].all() and not want[1][4].any()  # all N; one code
    # one row shorter than a tile, P = 1
    _same(renc.hashes(c[:2, :k + 40].contiguous().to(cuda)),
          renc.hashes(c[:2, :k + 40].contiguous()))
    _same(renc.hashes(c[:2, :k].contiguous().to(cuda)),
          renc.hashes(c[:2, :k].contiguous()))


KR1_RUN, KR1_TILE = rolling.KR1_RUN, rolling.KR1_TILE


@pytest.mark.cuda
@pytest.mark.parametrize("k", [128, KR1_TILE - 1, KR1_TILE, KR1_TILE + 1,
                               3 * KR1_TILE + 5])
@pytest.mark.parametrize("mode", ["forward", "canon"])
def test_cyclic_hashes_kernel_tile_edges(cuda, k, mode):
    """KR1's prefix scan at k within, at and past its tile (the span
    between its staged ranges read apart), three rows whose windows end
    inside, at and past a tile, Ns at run, tile and halo edges."""
    rng = np.random.default_rng(k * 5 + len(mode))
    renc = rolling.RollingEncoder(k, mode == "canon")
    for P in (1, KR1_TILE - 1, KR1_TILE, KR1_TILE + 1,
              2 * KR1_TILE + KR1_RUN + 3):
        L = P + k - 1
        codes = rng.integers(0, 4, (3, L)).astype(np.int8)
        codes[rng.random(codes.shape) < 0.01] = -1
        for p in (0, KR1_RUN - 1, KR1_RUN, KR1_TILE - 1, KR1_TILE,
                  KR1_TILE + KR1_RUN, k - 1, k, KR1_TILE + k - 1,
                  KR1_TILE + k):
            if p < L:
                codes[1, p] = -1
        codes[2] = 3
        c = torch.from_numpy(codes)
        _same(renc.hashes(c.to(cuda)), renc.hashes(c))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [17, 31])
def test_cyclic_hashes_kernel_kmercnt_row(cuda, k):
    """kmercnt's chunk (sketch/shs.py MultiKCounter): one row of 2^20
    bases, canonical."""
    rng = np.random.default_rng(k + 1000)
    codes = rng.integers(0, 4, (1, 1 << 20)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.001] = -1
    renc = rolling.RollingEncoder(k, True)
    c = torch.from_numpy(codes)
    before = rolling.cyclic_hashes.launches
    _same(renc.hashes(c.to(cuda)), renc.hashes(c))
    assert rolling.cyclic_hashes.launches == before + 1


@pytest.mark.cuda
def test_cyclic_hashes_kernel_twenty_characters(cuda):
    rng = np.random.default_rng(20)
    codes = torch.from_numpy(_rolling_rows(rng, 9000, 20))
    for k in (1, 21, 65):
        renc = rolling.RollingEncoder(k, n_chars=20)
        _same(renc.hashes(codes.to(cuda)), renc.hashes(codes))
    tf = torch.zeros(20, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="reverse complement takes 4"):
        rolling.cyclic_hashes(codes.to(cuda), 5, tf, tf)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 65])
def test_cyclic_hashes_kernel_codes_past_the_table(cuda, k):
    """A code at or past the table's length reads 0 on both strands, in
    the kernel as in the plain version; an empty batch launches nothing."""
    rng = np.random.default_rng(k + 128)
    codes = _rolling_rows(rng, KB1_TILE + 37 + k)
    renc = rolling.RollingEncoder(k, n_chars=2)  # DNA codes 2 and 3 past it
    c = torch.from_numpy(codes)
    _same(renc.hashes(c.to(cuda)), renc.hashes(c))
    codes[rng.random(codes.shape) < 0.1] = 127
    codes[0, :20] = 4
    c = torch.from_numpy(codes)
    renc = rolling.RollingEncoder(k, True)
    _same(renc.hashes(c.to(cuda)), renc.hashes(c))
    before = rolling.cyclic_hashes.launches
    v, inv = renc.hashes(c[:0].to(cuda))
    assert v.shape == (0, c.shape[1] - k + 1) and inv.shape == v.shape
    assert rolling.cyclic_hashes.launches == before


@pytest.mark.cuda
def test_gen_kernels_refuse_what_they_do_not_take(cuda):
    c = torch.zeros((1, 200), dtype=torch.int8, device=cuda)
    ln = torch.tensor([200], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="compacted_minimizers"):
        enc.minimizers(c, ln, 21, 10, True, "entropy")
    with pytest.raises(ValueError, match="never canonicalized"):
        enc.minimizers(c, ln, 7, 1, True, it=InputType.PROTEIN20)
    with pytest.raises(ValueError, match="exceeds 64 bits"):
        enc.compacted_minimizers(c, ln, 15, 10, it=InputType.PROTEIN20)
    with pytest.raises(ValueError, match="canonicalizes"):
        enc.compacted_minimizers(c, ln, 21, 10, "lex", canon=True)
    with pytest.raises(ValueError, match="score_map"):
        enc.compacted_minimizers(c, ln, 7, 10, "hash",
                                 it=InputType.PROTEIN20)
    with pytest.raises(ValueError, match="score_map"):
        enc.minimizers(c, ln, 7, 10, False, "hash", tuple(range(7)),
                       it=InputType.PROTEIN20)


# -- the sketches: KS1-KS4 -----------------------------------------------------

def _u64s(rng, n):
    v = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    v[:4] = [0, 2**64 - 1, 2**63, 2**63 - 1][: min(n, 4)]
    return torch.from_numpy(v.view(np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 1023, 1025, 300001])
def test_bitmix_kernel_matches_plain(cuda, n):
    x = _u64s(np.random.default_rng(n), n)
    for fn, plain in ((hashes.wang_hash, hashes.wang_hash_plain),
                      (hashes.khash_int64_hash, hashes.khash_int64_hash_plain),
                      (bitops.popcount64, bitops.popcount64_plain)):
        _same([fn(x.to(cuda))], [plain(x)])
    _same([hashes.wang_hash(x[: n // 2 * 2].reshape(-1, 2).to(cuda))],
          [hashes.wang_hash_plain(x[: n // 2 * 2].reshape(-1, 2))])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 1025, 1 << 22])
def test_bitmix_inverse_and_rotate_modes_match_plain(cuda, n):
    """KS4's frev64_inv, wang_hash_inv and rotl modes on 2^22 values and
    the edges 0, U64_MAX and bit 63, r in {0, 1, 31, 32, 63} and lrot 64,
    rrot 65; the round trips on the card."""
    x = _u64s(np.random.default_rng(n + 3), n)
    d = x.to(cuda)
    for fn, plain, mode in (
            (hashes.frev64_inv, hashes.frev64_inv_plain, "frev64_inv"),
            (hashes.wang_hash_inv, hashes.wang_hash_inv_plain,
             "wang_hash_inv")):
        before = bitops.bitmix.variants.get(mode, 0)
        _same([fn(d)], [plain(x)])
        assert bitops.bitmix.variants.get(mode, 0) == before + (n > 0)
    for r in (0, 1, 31, 32, 63):
        _same([hashes.rotl(d, r)], [hashes.rotl_plain(x, r)])
        _same([hashes.rrot(d, r)], [hashes.rrot(x, r)])
    _same([hashes.lrot(d, 64)], [x])
    _same([hashes.rrot(d, 65)], [hashes.rrot(x, 1)])
    _same([hashes.frev64_inv(hashes.frev64(d))], [x])
    _same([hashes.wang_hash_inv(hashes.wang_hash(d))], [x])
    with pytest.raises(ValueError):
        hashes.rotl(d, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 31, 32])
def test_nuccount_kernel_matches_plain(cuda, k):
    x = _u64s(np.random.default_rng(k), 100003) & bitops.i64(
        bitops.kmer_mask_bits(k))
    _same([bitops.nuccount(x.to(cuda), k)], [bitops.nuccount_plain(x, k)])
    before = bitops.nuccount.launches
    assert bitops.nuccount(x[:0].to(cuda), k).shape == (0, 4)
    assert bitops.nuccount.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 31, 32])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 100003])
def test_nuccount_kernel_sizes_and_offset(cuda, k, n):
    """Two lanes a k-mer, 4 k-mers a lane pair: n below, at and past a lane
    pair's and a block's k-mers, on a tensor and on its slice at an 8-B
    offset; k-mers with bits past the mask (the mask drops them)."""
    x = _u64s(np.random.default_rng(n + k), n + 1)
    d = x.to(cuda)
    before = bitops.nuccount.launches
    _same([bitops.nuccount(d[:n], k)], [bitops.nuccount_plain(x[:n], k)])
    _same([bitops.nuccount(d[1:], k)], [bitops.nuccount_plain(x[1:], k)])
    assert bitops.nuccount.launches == before + 2


def _hll_keys(rng, p, n):
    x = _u64s(rng, n)
    # keys whose h << p is 0 (only their top p bits set), unhashed
    top = torch.from_numpy((rng.integers(0, 1 << p, size=64).astype(np.uint64)
                            << np.uint64(64 - p)).view(np.int64))
    return torch.cat([x, top])


def _hll_same(cuda, p, wang, batches):
    """KS1 on each batch in turn into one set of registers (each call
    raises what the one before left) against the plain version; every
    nonempty batch is one launch."""
    regs = torch.zeros(1 << p, dtype=torch.int32)
    dregs = regs.to(cuda)
    before = hll.hll_fill.launches
    for keys in batches:
        hll.hll_fill_plain(keys, regs, p, wang)
        hll.hll_fill(keys.to(cuda), dregs, p, wang)
        _same([dregs], [regs])
    assert hll.hll_fill.launches == before + sum(b.numel() > 0
                                                  for b in batches)
    assert int(regs.max()) <= 64 - p + 1


@pytest.mark.cuda
@pytest.mark.parametrize("p", [4, 8, 12, 14, 15, 16, 17, 20])  # copies: <= 15
@pytest.mark.parametrize("wang", [False, True])
def test_hll_fill_kernel_matches_plain(cuda, p, wang):
    rng = np.random.default_rng(p)
    # n = 0, 1, errexp's 2^12 and 2^16, 200003: five calls raise the same
    # registers
    _hll_same(cuda, p, wang, [_hll_keys(rng, p, n)
                              for n in (0, 1, 4096, 65536, 200003)])


@pytest.mark.cuda
@pytest.mark.parametrize("p", [4, 8, 12, 14, 15, 16, 17, 20])
def test_hll_fill_kernel_size_switch_and_offsets(cuda, p):
    """n at the size switch (GLOBAL_BELOW x 2^p keys, +- 1, where the
    shared path takes p; 2^p past it), 2^20 keys, a slice at an 8-B
    offset of odd and even length (the 16-B pairs' head and tail keys),
    and unhashed keys aimed at the first and last register of every 32nd
    of the registers (the slices of a cluster of up to 32 blocks)."""
    rng = np.random.default_rng(p + 100)
    m = 1 << p
    at = hll.GLOBAL_BELOW * m if p <= hll.MAX_SHARED_P else m
    x = _u64s(rng, max(at + 2, 1 << 20) + 2)
    batches = [x[:at - 1], x[at - 1:2 * at - 1], x[:at + 1], x[: 1 << 20],
               x[1:4098], x[1:4097], x[1:2], x[1:3]]
    step = max(m >> 5, 1)
    regs = np.unique(np.concatenate([np.arange(0, m, step),
                                     np.arange(step - 1, m, step)]))
    low = rng.integers(0, 1 << (64 - p), size=regs.size, dtype=np.uint64)
    aimed = (regs.astype(np.uint64) << np.uint64(64 - p)) | low
    batches.append(torch.from_numpy(aimed.view(np.int64)))
    for wang in (False, True):
        _hll_same(cuda, p, wang, batches)


@pytest.mark.cuda
def test_hll_fill_refuses_registers_off_16_bytes(cuda):
    """The kernel flushes 16-B words of registers: a view 4 B in is
    refused, and nothing launches."""
    regs = torch.zeros((1 << 8) + 4, dtype=torch.int32, device=cuda)
    keys = torch.arange(1000, dtype=torch.int64, device=cuda)
    before = hll.hll_fill.launches
    with pytest.raises(ValueError):
        hll.hll_fill(keys, regs[1:1 + (1 << 8)], 8, True)
    assert hll.hll_fill.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("p", [8, 12, 16, 20])
def test_hll_fill_kernel_one_register(cuda, p):
    """Every key to one register (all the atomics of a launch on one
    address), 2^20 unhashed keys with the same top p bits and every rho,
    three calls; then the first and the last register."""
    rng = np.random.default_rng(p + 200)
    q = 64 - p
    n = 1 << 20
    for reg in (5 % (1 << p), 0, (1 << p) - 1):
        low = rng.integers(0, 1 << q, size=n, dtype=np.uint64)
        low >>= rng.integers(0, q + 1, size=low.size).astype(np.uint64)
        keys = torch.from_numpy(
            ((np.uint64(reg) << np.uint64(q)) | low).view(np.int64))
        _hll_same(cuda, p, False, [keys, keys[: n // 2], keys[1:]])


def _sort_count_keys(rng, case):
    """The keys of a KS3 case: hash-like, skewed, or sized at an edge of
    its plan (csrc/sort_unique.cu: buckets by the top bits, a bucket of at
    most SC_CAP keys in shared memory, scatter tiles of 8192 keys,
    histogram blocks of 16384)."""
    u = lambda n: _u64s(rng, n)
    top = -(1 << 63) | (0x5A5 << 51)  # the same top 13 bits
    low = (1 << 51) - 1
    cap = shs.SC_CAP
    if case == "random":
        return u(300000).repeat(3)
    if case == "saturated":
        return torch.cat([torch.full((70000,), 7), torch.full(
            (65535,), -1), torch.full((65536,), -(1 << 63)), u(1000)])
    if case == "bit63":
        return (u(50000) | -(1 << 63)).repeat(2)
    if case == "empty":
        return torch.zeros(0, dtype=torch.int64)
    if case == "one":
        return torch.tensor([-1])
    if case == "masked":
        return u(200000)
    if case == "one_bucket":  # every key in one bucket, past shared memory
        return (u(300000) & low) | top
    if case == "past_cap":  # one bucket of distinct keys past its capacity
        return torch.cat([u(cap + 5000) & ((1 << 50) - 1), u(75000)])
    if case in ("at_cap", "cap_plus_one"):  # E = cap: 2 buckets, 1 full
        n = cap + (case == "cap_plus_one")
        return torch.unique(u(n + 64) & ((1 << 63) - 1))[:n]
    if case == "split_runs":  # runs of equal keys past a split's limit
        return torch.cat([u(40).repeat(300), u(60000)])
    if case == "below_2_20":
        return torch.from_numpy(rng.integers(0, 1 << 20, 200000))
    if case == "lex":  # 62-bit k-mers, skewed to small values
        return torch.from_numpy(np.sort(rng.integers(
            0, 1 << 62, 100000)) >> rng.integers(0, 20, 100000)).repeat(2)
    n = int(case.split("=")[1])  # E at a tile edge
    return u(n)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "random", "saturated", "bit63", "empty", "one", "masked", "one_bucket",
    "past_cap", "at_cap", "cap_plus_one", "split_runs", "below_2_20", "lex",
    "E=8192", "E=8193", "E=16384", "E=16385", "E=20481"])
def test_sort_count_kernel_matches_plain(cuda, case):
    rng = np.random.default_rng(7)
    x = _sort_count_keys(rng, case)
    x = x[torch.from_numpy(rng.permutation(x.numel()))]
    em = torch.ones(x.numel(), dtype=torch.bool)
    if case == "masked":
        em = torch.from_numpy(rng.random(x.numel()) < 0.3)
    for _ in range(2):  # twice on one stream
        _same(shs.sort_count(x.to(cuda), em.to(cuda)),
              shs.sort_count_plain(x, em))


@pytest.mark.cuda
def test_sort_count_plan_matches_kernel(cuda):
    lib = kernels.get_lib()
    mean = shs.SC_BUCKET_MEAN
    for E in [0, 1, 2, 2 * mean, 2 * mean + 2, 4641622, (1 << 30) - 1] + [
            mean << b for b in range(14)] + [(mean << b) + 1
                                             for b in range(14)]:
        assert lib.bk_sort_count_bits(E) == shs.sort_count_plan(E), E


def _css_inputs(rng, m):
    v = _u64s(rng, 3000)
    return [v.repeat(2), torch.zeros(0, dtype=torch.int64), v[:1],
            torch.full(((1 << 16) + 1,), 0x1234567890ABCDEF),
            torch.cat([_u64s(rng, 70000), v[:5].repeat(20000)]),
            _u64s(rng, 10 * (1 << 16) + 3)]  # into a full sketch


def _same_sketch(got, want):
    np.testing.assert_array_max_ulp(got.registers, want.registers, maxulp=2)
    assert got.n_updates == want.n_updates
    if want.save_kmers:
        np.testing.assert_array_equal(got.ids(), want.ids())
    if want.save_kmer_counts:
        np.testing.assert_array_equal(got.idcounts(), want.idcounts())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 64, 4096, 1 << 16])
@pytest.mark.parametrize("mode", ["default", "-S", "-S -s"])
def test_csetsketch_kernel_matches_plain(cuda, m, mode):
    rng = np.random.default_rng(m)
    save, counts = "-S" in mode, "-s" in mode
    got = ss.CSetSketch(m, save, counts, device=cuda)
    want = ss.CSetSketch(m, save, counts, device="cpu")
    for v in _css_inputs(rng, m):
        got.update(v.to(cuda))
        want.update(v)
        _same_sketch(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3000, (1 << 16) + 1])
@pytest.mark.parametrize("save", [False, True])
def test_csetsketch_kernel_writes_only_its_scratch(cuda, n, save):
    """KS2 on a scratch of the size bk_csetsketch_update_scratch gives,
    followed by a guard: the guard comes back unchanged."""
    m = 4096
    v = _u64s(np.random.default_rng(n), n)
    used = kernels.get_lib().bk_csetsketch_update_scratch(n, ss.CHUNK, m)
    buf = torch.full((used + (2 << 20),), 0xA5, dtype=torch.uint8,
                     device=cuda)
    got = ss.CSetSketch(m, save, save, device=cuda)
    want = ss.CSetSketch(m, save, save, device="cpu")
    dv = v.to(cuda)
    kernels.launch("bk_csetsketch_update", cuda, dv.data_ptr(), n, ss.CHUNK,
                   m, got.regs.data_ptr(), kernels.ptr(got._ids),
                   kernels.ptr(got._idcounts), buf.data_ptr())
    torch.cuda.synchronize()
    got.n_updates = n
    want.update(v)
    assert int((buf[used:] != 0xA5).sum()) == 0
    _same_sketch(got, want)


# -- the formats and the encoders' tail: KS5, K128, KB4's stream source --------

@pytest.mark.cuda
@pytest.mark.parametrize("ndb", [1, 3, 4, 65536, 2**31 - 1])
@pytest.mark.parametrize("n", [0, 1, 1025, 300001, 5000011])
def test_shard_owner_kernel_matches_plain(cuda, ndb, n):
    from bonsai_tpu_torch.db import table as tbl

    x = _u64s(np.random.default_rng(n + ndb), n)
    _same([tbl.shard_owner(x.to(cuda), ndb)], [tbl.shard_owner_plain(x, ndb)])
    _same([tbl.shard_owner(x.reshape(-1, 1).to(cuda), ndb)],
          [tbl.shard_owner_plain(x.reshape(-1, 1), ndb)])
    with pytest.raises(ValueError, match="ndb"):
        tbl.shard_owner(x.to(cuda), 0)


K128_TILE = 2048  # csrc/encode128.cu kTile: the pack's positions a block


def _codes128(rng, B, L, n_prob=0.03):
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < n_prob] = -1
    return codes


@pytest.mark.cuda
@pytest.mark.parametrize("k", [33, 40, 55, 64])
@pytest.mark.parametrize("canon", [False, True])
def test_pack_kmers128_kernel_matches_plain(cuda, k, canon):
    """Rows of four tiles and a ragged one, an all-N row, Ns at the ends
    of a thread's run and of a tile, N runs longer than k, P = 1, codes
    past 3 (packed again from their codes; in the canonical pack, the rc
    formula), rows of one and two tiles exactly, rows whose P is odd
    (every other row starts its lanes off 16 B, and each ends inside a
    16-B pair), and rows that start 3 bytes past 16 B (``codes[:,
    3:1000]`` in place)."""
    from bonsai_tpu_torch.core import encode128 as e

    rng = np.random.default_rng(k + canon)
    codes = _codes128(rng, 6, 2 * 4096 + 300)
    codes[1, :] = -1
    codes[2, 15::16] = -1  # the last window start of each thread's run
    codes[3, 4095:4097] = -1
    codes[3, K128_TILE - 1:K128_TILE + 1] = -1
    codes[4, 500:700] = -1
    codes[5, rng.integers(0, codes.shape[1], 40)] = rng.integers(
        4, 128, 40).astype(np.int8)
    codes[5, [0, 16, K128_TILE + 3]] = [4, 127, 64]  # in a run's first window
    before = e.pack_kmers128.launches
    for c in (codes, codes[:, : k], codes[:2, : K128_TILE + k - 1],
              codes[:2, : 4096 + k - 1], codes[:, 3:1000].copy(),
              codes[:5, : 1001 + k - 1]):
        c = torch.from_numpy(np.ascontiguousarray(c))
        _same(e.pack_kmers128(c.to(cuda), k, canon),
              e.pack_kmers128_plain(c, k, canon))
    # codes[:, 3:1000] laid out from 3 bytes past a 16-B boundary
    c = torch.from_numpy(np.ascontiguousarray(codes[:, 3:1000]))
    flat = torch.empty(3 + c.numel(), dtype=torch.int8, device=cuda)
    flat[3:] = c.reshape(-1).to(cuda)
    view = flat[3:].view(c.shape)
    assert view.data_ptr() % 16 == 3
    _same(e.pack_kmers128(view, k, canon), e.pack_kmers128_plain(c, k, canon))
    assert e.pack_kmers128.launches == before + 7


@pytest.mark.cuda
@pytest.mark.parametrize("k", [33, 40, 55, 64])
def test_rc128_kernel_matches_plain(cuda, k):
    from bonsai_tpu_torch.core import encode128 as e

    rng = np.random.default_rng(k + 64)
    # past one pass of the grid-stride loop (sms * 16 blocks of 256)
    hi, lo = _u64s(rng, 1200007), _u64s(rng, 1200007)
    hi[:4] = torch.tensor([-(1 << 63), 0, -1, (1 << 63) - 1])
    for fn, plain in ((e.reverse_complement128, e.reverse_complement128_plain),
                      (e.canonical128, e.canonical128_plain)):
        for h, l in ((hi, lo), (hi[:1], lo[:1]), (hi[:0], lo[:0]),
                     (hi[:1000].reshape(10, 100), lo[:1000].reshape(10, 100))):
            _same(fn(h.to(cuda), l.to(cuda), k), plain(h, l, k))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 2, 37, 8192])
def test_compacted_stream_kernel_matches_plain(cuda, W):
    """Rows of several tiles, rows shorter than the window, an all-invalid
    row, a row whose valid values number 0 < n < W, values with bit 63
    set and U64_MAX, P = 1; then the rolling emissions of k = 64 and
    w = 100 on a long row against the plain path."""
    rng = np.random.default_rng(W)
    B, P = 6, 3 * 4096 + 77
    vals = _u64s(rng, B * P).reshape(B, P)
    vals[0, :5] = -1
    valid = torch.from_numpy(rng.random((B, P)) < 0.9)
    valid[1] = False
    valid[2] = False
    valid[2, 100:100 + max(W // 2, 1)] = True
    for v, ok in ((vals, valid), (vals[:, :W // 2 + 1], valid[:, :W // 2 + 1]),
                  (vals[:, :1], valid[:, :1])):
        v, ok = v.contiguous(), ok.contiguous()
        _same(enc.compacted_stream(v.to(cuda), ok.to(cuda), W),
              enc.compacted_stream_plain(v, ok, W))
    codes = torch.from_numpy(_codes128(rng, 2, 20000))
    lengths = torch.tensor([20000, 15000], dtype=torch.int32)
    renc = rolling.RollingEncoder(64, False, 100)
    got = renc.emissions(codes.to(cuda), lengths.to(cuda))
    want = enc.compacted_stream_plain(*_valid_hashes(renc, codes, lengths),
                                      37)
    _same(got, want)


def _valid_hashes(renc, codes, lengths):
    from bonsai_tpu_torch.core.encode import position_validity

    v, inv = rolling.cyclic_hashes_plain(codes, renc.k,
                                         *renc.tables("cpu"))
    return v, position_validity(lengths, v.shape[1], renc.k) & ~inv


@pytest.mark.cuda
def test_new_kernels_refuse_what_they_do_not_take(cuda):
    from bonsai_tpu_torch.core import encode128 as e

    c = torch.zeros((1, 100), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="32 < k <= 64"):
        e.pack_kmers128(c, 32)
    with pytest.raises(ValueError, match="32 < k <= 64"):
        e.pack_kmers128(c, 65)
    with pytest.raises(ValueError, match="k=64 > length 40"):
        e.pack_kmers128(c[:, :40].contiguous(), 64)
    v = torch.zeros((1, 100), dtype=torch.int64, device=cuda)
    ok = torch.ones((1, 100), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="window"):
        enc.compacted_stream(v, ok, 8193)
    with pytest.raises(TypeError, match="dtype"):
        enc.compacted_stream(v, ok.to(torch.int8), 10)


# -- the sharded classifier and the sharded build: KD1, K1's encode-only
#    and bucket-range instantiations, the key-range mode, KB1's
#    sequence-parallel instantiation -------------------------------------------

def _table_images(rng, n=200000, flat=False, with_max=False):
    """A table of n random keys (and U64_MAX ``with_max``) with 50 x 40
    packed values (some taxids past 2^31), as the image (inline, or flat)
    on the CPU and its keys."""
    keys = rng.integers(0, 2**64, n, dtype=np.uint64)
    keys = np.unique(np.append(keys, np.uint64(2**64 - 1)) if with_max
                     else keys[keys != np.uint64(2**64 - 1)])
    vals = (rng.integers(0, 50, keys.size).astype(np.uint64) << np.uint64(32)
            ) | rng.integers(0, 40, keys.size).astype(np.uint64)
    vals[:5] |= np.uint64(0xF0000000) << np.uint64(32)  # taxids >= 2^31
    t = KmerTable(keys, vals)
    return t, t.encode_slots(vals, allow_inline=not flat), keys


FRAME_TILE = 1024  # csrc/route.cu kTile: queries a frame tile


def _frames_on_one_scratch(cuda, cases, ndb, cap):
    """bk_route_frame called on one scratch buffer, filled with 0xAB
    first, for each (kq, done) of ``cases`` in turn: nothing in it needs
    clearing between calls."""
    from bonsai_tpu_torch.parallel import route as rt

    Q = cases[0][0].numel()
    scratch = kernels.scratch("bk_route_frame", (Q, ndb), cuda).fill_(0xAB)
    for x, d in cases:
        x, d = x.to(cuda), d.to(cuda)
        send = torch.empty(ndb * cap, dtype=torch.int64, device=cuda)
        slotq = torch.empty(Q, dtype=torch.int32, device=cuda)
        kernels.launch("bk_route_frame", cuda, x.data_ptr(), d.data_ptr(),
                       Q, ndb, cap, send.data_ptr(), slotq.data_ptr(),
                       scratch.data_ptr())
        _same([send, slotq], rt.route_frame_plain(x.cpu(), d.cpu(), ndb, cap))


@pytest.mark.cuda
@pytest.mark.parametrize("Q,ndb,cf", [
    (145408, 4, 1.05), (4_000_000, 4, 1.05), (1000, 3, 0.05), (3, 4, 1.05),
    (0, 2, 1.0), (50000, 1024, 1.0), (70000, 1, 1.0),
    (37 * FRAME_TILE + 1, 4, 1.05), (100, 1024, 1.0), (200000, 1024, 1.0)])
def test_route_frame_kernel_matches_plain(cuda, Q, ndb, cf):
    """KD1's frame: stable owner order, capacity overflow (cf 0.05), Q <
    ndb, an empty batch, 1024 owners (fewer queries than owners; blocks x
    owners past what a block sums itself, so owners' columns are
    scanned), Q one past a multiple of the tile, and 4M queries (blocks
    of several tiles); then rounds where every query is done (the frame
    all padding) and where only the last query is pending, and calls on
    one scratch that is never cleared."""
    from bonsai_tpu_torch.parallel import route as rt

    rng = np.random.default_rng(Q + ndb)
    kq = _u64s(rng, Q)
    done = torch.from_numpy(rng.random(Q) < 0.3)
    cap = max(int(np.ceil(Q / ndb * cf)), 1)
    _same(rt.route_frame(kq.to(cuda), done.to(cuda), ndb, cap),
          rt.route_frame_plain(kq, done, ndb, cap))
    # every query to one owner
    one = kq[rt.shard_owner_plain(kq, ndb) == 0][:5000].contiguous()
    d0 = torch.zeros(one.numel(), dtype=torch.bool)
    _same(rt.route_frame(one.to(cuda), d0.to(cuda), ndb, 100),
          rt.route_frame_plain(one, d0, ndb, 100))
    if Q == 0:
        return
    # every query done; only the last one pending
    all_done = torch.ones(Q, dtype=torch.bool)
    last = all_done.clone()
    last[-1] = False
    for d in (all_done, last):
        got = rt.route_frame(kq.to(cuda), d.to(cuda), ndb, cap)
        _same(got, rt.route_frame_plain(kq, d, ndb, cap))
    assert bool((got[0] != -1).sum() == (1 if kq[-1] != -1 else 0))
    _frames_on_one_scratch(cuda, [(kq, done), (kq, last), (kq, done)],
                                ndb, cap)


PROBE_BLOCK = 256  # csrc/route.cu kThreads: a probe block's threads, at most
COLLECT_WIDTH = 4  # csrc/route.cu kCollectQ: queries a collect thread
COLLECT_BLOCK = 256 * COLLECT_WIDTH  # queries a collect block a pass


@pytest.mark.cuda
@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("want_idx", [False, True])
def test_route_probe_kernel_matches_plain(cuda, flat, want_idx):
    """KD1's probe: stored and random keys, also at the sizes where the
    launch's block size changes (256 a block from one block an SM, and
    9g's later rounds); then a2a frames with runs of U64_MAX pad rows,
    against a table that stores U64_MAX (a real query can be that key)
    and one that does not, cut to n = 1, 3, 5 and a probe block's keys -
    1, + 0, + 1, and a frame of pads only."""
    from bonsai_tpu_torch.parallel import route as rt

    rng = np.random.default_rng(7 + flat)
    t, (s, v, inline), keys = _table_images(rng, flat=flat)
    q = torch.from_numpy(np.concatenate([
        keys[:100000], rng.integers(0, 2**64, 100000, dtype=np.uint64),
        np.array([0, 2**64 - 1], np.uint64)]).view(np.int64))
    a = ProbeArrays.from_numpy(s, v, inline, t.lgnb, t.vbits, cuda)
    c = ProbeArrays.from_numpy(s, v, inline, t.lgnb, t.vbits, "cpu")
    got = rt.route_probe(q.to(cuda), a, want_idx)
    want = rt.route_probe_plain(q, c, want_idx)
    _same([got], [want])
    assert bool((want[:100000] >> 31 & 1).all())  # stored keys found
    # where the launch's block size changes: 256 a block from one per SM
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m in (256 * sms - 1, 256 * sms, 64 * sms + 1, 7580):
        x = q[-m:].contiguous()  # random keys first, U64_MAX last
        _same([rt.route_probe(x.to(cuda), a, want_idx)],
              [rt.route_probe_plain(x, c, want_idx)])
    pad = np.uint64(2**64 - 1)
    for with_max in (False, True):
        t, (s, v, inline), keys = _table_images(rng, 50000, flat, with_max)
        a = ProbeArrays.from_numpy(s, v, inline, t.lgnb, t.vbits, cuda)
        c = ProbeArrays.from_numpy(s, v, inline, t.lgnb, t.vbits, "cpu")
        frame = np.concatenate([
            [pad, keys[0], pad], keys[1:2000], np.full(3000, pad),
            rng.integers(0, 2**64, 1000, dtype=np.uint64), [pad],
            keys[2000:2100], np.full(777, pad)]).view(np.int64)
        frame = torch.from_numpy(frame)
        cases = [frame, torch.full((10000,), -1, dtype=torch.int64)] + [
            frame[:m] for m in (1, 3, 5, PROBE_BLOCK - 1, PROBE_BLOCK,
                                PROBE_BLOCK + 1)]
        for x in cases:
            x = x.contiguous()
            got = rt.route_probe(x.to(cuda), a, want_idx)
            want = rt.route_probe_plain(x, c, want_idx)
            _same([got], [want])
            pads = want[x == -1]
            assert bool((pads >> 31 & 1).all() if with_max
                        else (pads == 0).all())


def _collect_state(rng, Q):
    """done, hit (bool) and cidx, oidx (int32) of Q queries at random."""
    return [torch.from_numpy(rng.random(Q) < .5),
            torch.from_numpy(rng.random(Q) < .5),
            _i32(rng.integers(0, 9, Q).astype(np.int32)),
            _i32(rng.integers(0, 9, Q).astype(np.int32))]


@pytest.mark.cuda
def test_route_collect_kernel_matches_plain(cuda):
    """KD1's collect at Q of a thread's and a block's queries - 1, + 0,
    + 1, an empty batch and several passes of the grid, on contiguous
    tensors and on views at an odd offset (x[1:]: the scalar loads and
    stores)."""
    from bonsai_tpu_torch.parallel import route as rt

    rng = np.random.default_rng(11)
    W, B = COLLECT_WIDTH, COLLECT_BLOCK
    for Q, dump in ((100000, 120000), (1, 4), (0, 4), (600001, 600000),
                    (W - 1, 8), (W, 8), (W + 1, 8), (B - 1, 900),
                    (B, 900), (B + 1, 900), (5_000_003, 4_000_000)):
        for view in (False, True):
            slotq = torch.from_numpy(
                rng.integers(0, dump + 1, Q + view).astype(np.int32))
            back = _u64s(rng, dump)
            state = _collect_state(rng, Q + view)
            on = [x.to(cuda) for x in state]
            off = [x.clone() for x in state]
            sq, o, f = ((slotq[1:], [x[1:] for x in on],
                         [x[1:] for x in off]) if view
                        else (slotq, on, off))
            n1 = rt.route_collect(back.to(cuda), sq.to(cuda), *o)
            n2 = rt.route_collect_plain(back, sq, *f)
            _same(on + [n1], off + [n2])


@pytest.mark.cuda
def test_route_collect_on_one_pending_buffer(cuda):
    """bk_route_collect called three times on one pending word, filled
    with 0xAB first, each call with its own state; then a CUDA graph of
    one call replayed three times, a new state copied in before each: the
    count is right every time (the tally the blocks share is back at 0
    after each call)."""
    from bonsai_tpu_torch.parallel import route as rt

    rng = np.random.default_rng(12)
    Q, dump = 151552, 159132
    pending = torch.empty((), dtype=torch.int64, device=cuda)
    pending.reshape(1).view(torch.uint8).fill_(0xAB)

    def call(back, slotq, st):
        kernels.launch("bk_route_collect", cuda, back.data_ptr(),
                       slotq.data_ptr(), Q, dump, *(x.data_ptr() for x in st),
                       pending.data_ptr())

    def inputs():
        slotq = torch.from_numpy(rng.integers(0, dump + 1, Q).astype(np.int32))
        return _u64s(rng, dump), slotq, _collect_state(rng, Q)

    for _ in range(3):
        back, slotq, state = inputs()
        on = [x.to(cuda) for x in state]
        call(back.to(cuda), slotq.to(cuda), on)
        n2 = rt.route_collect_plain(back, slotq, *state)
        _same(on + [pending], state + [n2])
    back, slotq, state = inputs()
    g_in = [back.to(cuda), slotq.to(cuda)] + [x.to(cuda) for x in state]
    call(*g_in[:2], g_in[2:])  # warm up outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        call(*g_in[:2], g_in[2:])
    for _ in range(3):
        back, slotq, state = inputs()
        for dst, src in zip(g_in, [back, slotq] + state):
            dst.copy_(src)
        pending.reshape(1).view(torch.uint8).fill_(0xAB)
        g.replay()
        torch.cuda.synchronize()
        n2 = rt.route_collect_plain(back, slotq, *state)
        _same(g_in[2:] + [pending], state + [n2])


@pytest.mark.cuda
@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("ndb", [1, 3, 4])
def test_encode_probe_range_kernel_matches_plain(cuda, flat, ndb):
    """K1's bucket-range instantiation on each rank's rows, contiguous
    (canonical or not) and spaced, value index or taxid out."""
    rng = np.random.default_rng(ndb + 10 * flat)
    t, (s, v, inline), _ = _table_images(rng, flat=flat)
    rps = (t.nb + ndb - 1) // ndb
    codes = rng.integers(0, 4, (64, 150)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.02] = -1
    pc, nm = _pack(codes)
    ln = torch.from_numpy(rng.integers(0, 151, 64).astype(np.int32))
    pos = (0, 1, 2, 3, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
           20, 21, 25)
    for r in range(ndb):
        lo, hi = r * rps, min((r + 1) * rps, t.nb)
        z = np.zeros((rps - (hi - lo), 4), np.uint64)
        sl = np.concatenate([s[lo:hi], z])
        fv = v if inline else np.concatenate([v[lo:hi], z])
        a = ProbeArrays.from_numpy(sl, fv, inline, t.lgnb, t.vbits, cuda, lo,
                                   rps)
        c = ProbeArrays.from_numpy(sl, fv, inline, t.lgnb, t.vbits, "cpu", lo,
                                   rps)
        for k, canon, p in ((31, True, None), (31, False, None),
                            (21, False, pos)):
            for want_idx in (False, True):
                _same(pl.encode_probe(pc.to(cuda), nm.to(cuda), ln.to(cuda),
                                      150, k, canon, a, want_idx, p),
                      pl.encode_probe_plain(pc, nm, ln, 150, k, canon, c,
                                            want_idx, p))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 21, 31, 32])
def test_encode_only_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (300, 200)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.03] = -1
    codes[7, :] = 3  # k = 32: the all-T k-mer is U64_MAX, uncanonical
    pc, nm = _pack(codes)
    ln = torch.from_numpy(rng.integers(0, 201, 300).astype(np.int32))
    ln[7] = 200
    for canon in (True, False):
        _same(pl.encode_only(pc.to(cuda), nm.to(cuda), ln.to(cuda), 200, k,
                             canon),
              pl.encode_only_plain(pc, nm, ln, 200, k, canon))
    if k == 21:
        pos = (0, 1, 2, 3, 5, 6, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
               19, 20, 21, 25)
        _same(pl.encode_only(pc.to(cuda), nm.to(cuda), ln.to(cuda), 200, k,
                             False, pos),
              pl.encode_only_plain(pc, nm, ln, 200, k, False, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 1000, 5_000_011])
def test_key_range_kernel_matches_plain(cuda, n):
    """Past one pass of the grid-stride loop; U64_MAX keys, keys at the
    splitters, pads; the last rank's inclusive upper end."""
    rng = np.random.default_rng(n)
    keys = _u64s(rng, n)
    pad = torch.from_numpy((rng.random(n) < 0.1).astype(np.uint8))
    spl = [2**62, 2**63 + 5]
    if n >= 6:
        keys[:3] = -1
        keys[3:6] = torch.tensor([2**62, -(2**63) + 5, 0])
    for lo, hi, last in ((0, spl[0], False), (spl[0], spl[1], False),
                         (spl[1], 2**64 - 1, True), (0, 2**64 - 1, True)):
        _same([bd.key_range(keys.to(cuda), pad.to(cuda), lo, hi, last)],
              [bd.key_range_plain(keys, pad, lo, hi, last)])


@pytest.mark.cuda
@pytest.mark.parametrize("canon", [False, True])
def test_minimizers_sequence_parallel_kernel_matches_plain(cuda, canon):
    """KB1 at W = 1 writing 0 where nothing is emitted: Ns, rows shorter
    than their codes, a row shorter than k."""
    rng = np.random.default_rng(3 + canon)
    codes = torch.from_numpy(rng.integers(-1, 4, (3, 9000)).astype(np.int8))
    lens = torch.tensor([9000, 5000, 20], dtype=torch.int32)
    for k in (17, 31):
        a = enc.minimizers(codes.to(cuda), lens.to(cuda), k, 1, canon,
                           zero_invalid=True)
        b = enc.minimizers_plain(codes, lens, k, 1, canon, zero_invalid=True)
        _same([a.values, a.mask], [b.values, b.mask])
        assert not bool((b.values[~b.mask] != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("route,dp,db", [("a2a", 1, 4), ("a2a", 2, 2),
                                         ("a2a", 1, 3), ("psum", 1, 4),
                                         ("psum", 2, 2)])
def test_sharded_classifier_on_the_card_matches_one_device(cuda, route, dp,
                                                           db):
    """In-process ranks on one card: the raw step and the compact text
    equal the one-device classifier's on the card, at cf 1.05 and 0.05
    (several rounds)."""
    from bonsai_tpu_torch.classify import output as out_mod
    from bonsai_tpu_torch.db.formats import Database
    from bonsai_tpu_torch.io import fastx
    from bonsai_tpu_torch.parallel.mesh import make_mesh
    from bonsai_tpu_torch.parallel.sharded import ShardedClassifier

    rng = np.random.default_rng(dp * 10 + db)
    genome = rng.integers(0, 4, 20000).astype(np.int8)
    starts = rng.integers(0, 19800, 96)
    codes = np.stack([genome[s:s + 120] for s in starts])
    codes[rng.random(codes.shape) < 0.01] = -1
    codes[:48] = rng.integers(0, 4, (48, 120)).astype(np.int8)
    lengths = rng.integers(20, 121, 96).astype(np.int32)
    codes[np.arange(120)[None, :] >= lengths[:, None]] = -1
    em = enc.minimizers_plain(torch.from_numpy(genome[None]),
                              torch.tensor([20000], dtype=torch.int32), 21,
                              1, True)
    keys = np.unique(em.values[em.mask].numpy().view(np.uint64))
    keys = keys[rng.random(keys.size) < 0.7]
    tree = TaxTree({1: 0, 2: 1, 3: 1, 11: 2, 12: 2, 13: 3})
    taxa = rng.choice([2, 3, 11, 12, 13], keys.size).astype(np.uint32)
    db_ = Database(table=KmerTable(keys, taxa), k=21, w=21, gaps=[0] * 20)
    one = pl.Classifier(db_, tree, emit_all=True, device=cuda)
    batch = fastx.ReadBatch(names=[f"r{i}".encode() for i in range(96)],
                            seqs=[b"A" * int(n) for n in lengths],
                            codes=codes, lengths=lengths,
                            quals=[None] * 96)
    want = one.classify_batch(batch, full=True)
    want_txt = out_mod.format_batch(one.classify_batch(batch), 21,
                                    emit_all=True)
    for cf in (1.05, 0.05):
        sc = ShardedClassifier(db_, tree, make_mesh({"dp": dp, "db": db},
                                                    [cuda]),
                               route=route, capacity_factor=cf,
                               emit_all=True)
        taxon, taxa_, hit, n_missing, n_kmers, n_kmers1 = sc.step(codes,
                                                                 lengths)
        assert np.array_equal(taxon, want.taxon)
        assert np.array_equal(hit[:, :want.hit_mask.shape[1]], want.hit_mask)
        assert np.array_equal(n_missing, want.n_missing)
        assert np.array_equal(n_kmers, want.n_kmers)
        got_txt = out_mod.format_batch(sc.classify_batch(batch), 21,
                                       emit_all=True)
        assert got_txt == want_txt
        if route == "a2a" and cf < 1:
            assert sc.last_rounds > 1


# -- the on-card LCA build's k-mer sets (db/build.py use_device) --------------

GOLDEN_GENOMES = [os.path.join(os.path.dirname(__file__), "data", "golden", f)
                  for f in ("g_phix.fa", "g_phixmut.fa", "g_rand.fa")]


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["lex", "-C -w", "-S", "PROTEIN20",
                                 "PROTEIN20 -w"])
@pytest.mark.parametrize("block", [1 << 22, 777])
def test_genome_kmer_set_on_the_card_equals_the_host(cuda, tmp_path, how,
                                                     block):
    """genome_kmer_set(use_device=True) (KB1, or KB4 for -C -w and another
    alphabet's windows) equals the host's set, the contigs whole and in
    chunks of 777 windows; and lca_map on the card the host's table."""
    from bonsai_tpu_torch.core.spacer import Spacer, parse_spacing
    from bonsai_tpu_torch.db import build
    from bonsai_tpu_torch.io import fastx
    from bonsai_tpu_torch.tools.synthetic import translate

    it = InputType.PROTEIN20 if how.startswith("PROTEIN") else InputType.DNA
    sp, canon = {
        "lex": (Spacer(31, 31), True),
        "-C -w": (Spacer(31, 40), False),
        "-S": (Spacer(21, 21, parse_spacing("0x16,1x4", 21)), False),
        "PROTEIN20": (Spacer(7, 7), False),
        "PROTEIN20 -w": (Spacer(7, 20), False),
    }[how]
    paths = GOLDEN_GENOMES
    if it != InputType.DNA:
        paths = []
        for g in GOLDEN_GENOMES:
            seq = b"".join(s for _, s, _ in fastx.read_fastx(g))
            p = tmp_path / (os.path.basename(g) + ".faa")
            p.write_bytes(b"".join(b">f%d\n%s\n" % (f, translate(seq, f))
                                   for f in range(3)))
            paths.append(str(p))
    before = (enc.minimizers.launches, enc.compacted_minimizers.launches)
    for path in paths:
        got = build.genome_kmer_set(path, sp, canon, input_type=it,
                                    use_device=True, block=block,
                                    device=cuda)
        want = build.genome_kmer_set(path, sp, canon, input_type=it,
                                     block=block)
        assert got.size and np.array_equal(got, want), path
    after = (enc.minimizers.launches, enc.compacted_minimizers.launches)
    assert after != before  # the kernels ran
    if how in ("lex", "-C -w") and block == 777:
        from bonsai_tpu_torch.taxonomy.ncbi import accession_from_header

        tree = TaxTree({1: 0, 2: 1, 11: 2, 12: 2, 13: 1})
        names = {accession_from_header(fastx.first_header(g)): 11 + i
                 for i, g in enumerate(GOLDEN_GENOMES)}
        got = build.lca_map(GOLDEN_GENOMES, tree, names, sp, canon,
                            use_device=True, device=cuda, block=block)
        want = build.lca_map(GOLDEN_GENOMES, tree, names, sp, canon,
                             block=block)
        assert np.array_equal(got.keys_sorted, want.keys_sorted)
        assert np.array_equal(got.vals_sorted, want.vals_sorted)


# -- index and taxonomy tools --------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("block", [1 << 22, 97])
def test_kmeridx_on_the_card_equals_the_cpu(cuda, tmp_path, monkeypatch,
                                            block):
    """KmerIdx at k = 32 (keys with bit 63 set) on the card (KB1, the
    stable sort) equals KB1's plain version on the CPU: the golden
    genomes, whole and in chunks of 97 windows, a second add_seq after
    finalize, and the written file's bytes after gunzip."""
    import gzip

    from bonsai_tpu_torch.db import kmeridx
    from bonsai_tpu_torch.io import fastx

    monkeypatch.setattr(kmeridx, "BLOCK", block)
    rng = np.random.default_rng(32)
    contigs = [(n, s) for g in GOLDEN_GENOMES
               for n, s, _ in fastx.read_fastx(g)]
    seq = bytearray(rng.choice(np.frombuffer(b"ACGTN", np.uint8), 3000))
    contigs += [(b"rand", bytes(seq)), (b"short", b"ACGT"), (b"empty", b"")]
    idx = []
    before = enc.minimizers.launches
    for i, dev in enumerate((cuda, "cpu")):
        x = kmeridx.KmerIdx(32, device=dev)
        for name, s in contigs[:-2]:
            x.add_seq(name, s)
        x.finalize()
        for name, s in contigs[-2:] + contigs[:1]:
            x.add_seq(name, s)
        x.write(str(tmp_path / f"{i}.kidx"))
        idx.append(x)
    assert enc.minimizers.launches > before
    got, want = idx
    assert (want.keys >> np.uint64(63)).any() and len(want) > 0
    for a in ("keys", "offsets", "positions"):
        assert np.array_equal(getattr(got, a), getattr(want, a)), a
    files = [gzip.open(tmp_path / f"{i}.kidx").read() for i in range(2)]
    assert files[0] == files[1]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [3, 70])
def test_bitmap_patterns_on_the_card_equal_the_cpu(cuda, T):
    """bitmap_patterns and pairwise_veccmp on the card equal the CPU's on
    the same sets (keys with bit 63 set, an owner on bit 63 where T > 63),
    and KmerGenomeSets of the golden genomes at k = 32 (KB1) equals the
    CPU's."""
    from bonsai_tpu_torch.core.spacer import Spacer
    from bonsai_tpu_torch.metatree import bitsets

    rng = np.random.default_rng(T)
    pool = rng.choice(1 << 62, 4000, replace=False).astype(np.uint64)
    pool[::3] |= np.uint64(1 << 63)
    pats = rng.random((12, T)) < 0.5
    which = rng.integers(0, 12, pool.size)
    sets = [np.sort(pool[pats[which, t]]) for t in range(T)]
    out = []
    for dev in (cuda, "cpu"):
        kgs = bitsets.KmerGenomeSets({}, Spacer(32, 32), device=dev)
        kgs.taxes, kgs.sets = list(range(T)), sets
        p, c = bitsets.bitmap_patterns(kgs)
        out.append((p, c, *bitsets.pairwise_veccmp(p, dev)))
    assert out[0][0].shape[0] > 2
    if T > 63:
        assert (out[0][0][:, 0] >> np.uint64(63)).any()
    for g, w in zip(*out):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    t2p = {11 + i: [g] for i, g in enumerate(GOLDEN_GENOMES)}
    before = enc.minimizers.launches
    got = bitsets.KmerGenomeSets(t2p, Spacer(32, 32), True, device=cuda)
    assert enc.minimizers.launches > before
    want = bitsets.KmerGenomeSets(t2p, Spacer(32, 32), True, device="cpu")
    for g, w in zip(got.sets, want.sets):
        assert g.size and np.array_equal(g, w)
    for g, w in zip(bitsets.bitmap_patterns(got),
                    bitsets.bitmap_patterns(want)):
        assert np.array_equal(g, w)


# -- K1's radix instantiations: another input type's int8 codes --------------

# (input type, k): shift-or folds (PROTEIN at its 8 bits, PROTEIN_3BIT at
# k = 22, whose 66-bit fold keeps 64, DNA2 at k = 32) and multiply-add
# folds (PROTEIN20, PROTEIN_14, PROTEIN_6 at their largest k)
RADIX_K1 = [(InputType.PROTEIN, 8), (InputType.PROTEIN_3BIT, 22),
            (InputType.DNA2, 32), (InputType.PROTEIN20, 7),
            (InputType.PROTEIN_14, 16), (InputType.PROTEIN_6, 24)]


def _radix_reads(rng, it, B, L, c):
    """(B, L) int8 codes of ``it`` (2% ambiguous, -1 past each length; a
    row of the largest code, which folds to U64_MAX for PROTEIN_3BIT at
    k = 22 and DNA2 at k = 32) and int32 lengths (some shorter than c)."""
    top = min(radix_of(it), 128)
    codes = rng.integers(0, top, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.02] = -1
    codes[3] = top - 1
    lengths = rng.integers(c, L + 1, B).astype(np.int32)
    lengths[3] = L
    lengths[rng.choice(np.arange(4, B), B // 8, replace=False)] = \
        rng.integers(0, c, B // 8)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return torch.from_numpy(codes), torch.from_numpy(lengths)


def _radix_tables(rng, kmers, valid, flat):
    """A table of half the valid k-mers and random keys (U64_MAX among
    them), 6 packed values (inline) or one a key (flat)."""
    seen = np.unique(kmers[valid].numpy().view(np.uint64))
    keys = np.unique(np.concatenate([
        rng.choice(seen, seen.size // 2, replace=False),
        rng.integers(0, 2**64, 2000, dtype=np.uint64),
        np.array([2**64 - 1], np.uint64)]))
    v = (np.arange(keys.size, dtype=np.uint64) if flat else
         rng.integers(0, 6, keys.size).astype(np.uint64))
    t = KmerTable(keys, ((v + np.uint64(7)) << np.uint64(32)) | v)
    return t, t.encode_slots(t.vals_sorted, allow_inline=not flat)


def _radix_check(cuda, rng, it, k, pos, codes, ln, flat):
    """K1's radix instantiations on (codes, ln) against their plain
    versions: encode only, then the whole table and each rank's bucket
    range (ndb = 3) of a table of half the valid k-mers, want_idx on and
    off, the int32 lengths and, where they fit, u16."""
    kmers, valid = pl.encode_only_radix_plain(codes, ln, k, it, pos)
    assert valid.any() and not valid.all()
    _same(pl.encode_only_radix(codes.to(cuda), ln.to(cuda), k, False, it,
                               pos), (kmers, valid))
    t, (s, v, inline) = _radix_tables(rng, kmers, valid, flat)
    assert inline != flat
    whole = [ProbeArrays.from_numpy(s, v, inline, t.lgnb, t.vbits, d)
             for d in ("cpu", cuda)]
    rps = (t.nb + 2) // 3
    ranges = []
    for r in range(3):
        lo, hi = r * rps, min((r + 1) * rps, t.nb)
        z = np.zeros((rps - (hi - lo), 4), np.uint64)
        sl = np.concatenate([s[lo:hi], z])
        fv = v if inline else np.concatenate([v[lo:hi], z])
        ranges.append([ProbeArrays.from_numpy(sl, fv, inline, t.lgnb,
                                              t.vbits, d, lo, rps)
                       for d in ("cpu", cuda)])
    lens = (ln, ln.to(torch.uint16)) if int(ln.max()) < 1 << 16 else (ln,)
    for lengths in lens:
        for want_idx in (False, True):
            for cpu_arr, dev_arr in [whole] + ranges:
                want = pl.encode_probe_radix_plain(codes, lengths, k, it,
                                                   cpu_arr, want_idx, pos)
                before = pl.encode_probe.launches
                got = pl.encode_probe_radix(codes.to(cuda), lengths.to(cuda),
                                            k, False, it, dev_arr, want_idx,
                                            pos)
                assert pl.encode_probe.launches == before + 1
                _same(got, want)
            assert want[0].any()
    variants = pl.encode_probe.variants
    tag = "spaced " if pos is not None else ""
    for v in ("radix", "radix range", "radix encode"):
        assert variants.get(tag + v, 0) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("spaced", [False, True])
@pytest.mark.parametrize("it,k", RADIX_K1,
                         ids=[f"{t.name}-{k}" for t, k in RADIX_K1])
def test_encode_probe_radix_kernel_matches_plain(cuda, it, k, spaced, flat):
    """K1's radix instantiations, whole table, each rank's bucket range
    (ndb = 3) and encode only, contiguous and spaced (every other code),
    want_idx on and off, int32 and u16 lengths."""
    rng = np.random.default_rng(int(it) * 100 + k + 7 * spaced + flat)
    pos = tuple(range(0, 2 * k - 1, 2)) if spaced else None
    c = 2 * k - 1 if spaced else k
    codes, ln = _radix_reads(rng, it, 200, c + 90, c)
    _radix_check(cuda, rng, it, k, pos, codes, ln, flat)


def _span_positions(k, span):
    """k offsets spread over ``span`` codes, the first and the last
    included."""
    return tuple(int(x) for x in np.round(np.linspace(0, span - 1, k)))


def _long_reads(rng, it, B, L):
    """(B, L) codes of ``it`` (2% ambiguous) and int32 lengths at and
    near L, past u16."""
    top = min(radix_of(it), 128)
    codes = rng.integers(0, top, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.02] = -1
    lengths = np.array([L, L - 10, 65_600][:B], np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return torch.from_numpy(codes), torch.from_numpy(lengths)


# the shapes the kernel's design turns on: the stream's batch (8192 reads,
# P = 34 at c = 7), one position a read (L = c: a contiguous run over two
# reads, several blocks), three reads of 70,000 codes (int32
# lengths), and reads of one position under a spaced span of 63
RADIX_SHAPES = [(shape, it, k, spaced, flat)
                for shape in ("stream", "P=1", "70000", "span 63")
                for it, k in RADIX_K1
                for spaced in ((True,) if shape == "span 63" else
                               (False, True))
                for flat in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,it,k,spaced,flat", RADIX_SHAPES,
    ids=[f"{sh}-{t.name}-{k}-{'spaced' if sp else 'contiguous'}-"
         f"{'flat' if f else 'inline'}" for sh, t, k, sp, f in RADIX_SHAPES])
def test_encode_probe_radix_kernel_matches_plain_at_shapes(cuda, shape, it, k,
                                                           spaced, flat):
    """K1's radix instantiations, every mode, at the shapes of
    ``RADIX_SHAPES`` (spaced: every other code, or over a span of 63)."""
    rng = np.random.default_rng(int(it) * 100 + k + 7 * spaced + flat
                                + 1000 * RADIX_SHAPES.index(
                                    (shape, it, k, spaced, flat)))
    c = 63 if shape == "span 63" else 2 * k - 1 if spaced else k
    pos = (_span_positions(k, c) if shape == "span 63" else
           tuple(range(0, c, 2)) if spaced else None)
    if shape == "stream":
        codes, ln = _radix_reads(rng, it, 8192, c + 33, c)
    elif shape == "P=1":
        codes, ln = _radix_reads(rng, it, 600, c, c)
    elif shape == "70000":
        codes, ln = _long_reads(rng, it, 3, 70_000)
    else:
        codes, ln = _radix_reads(rng, it, 700, c, c)
    _radix_check(cuda, rng, it, k, pos, codes, ln, flat)


@pytest.mark.cuda
def test_encode_probe_radix_refuses_what_the_kernel_does_not_take(cuda):
    codes, ln = _radix_reads(np.random.default_rng(1), InputType.PROTEIN20,
                             8, 40, 7)
    t, (s, v, inline) = _radix_tables(np.random.default_rng(2),
                                      *pl.encode_only_radix_plain(
                                          codes, ln, 7, InputType.PROTEIN20),
                                      False)
    arr = ProbeArrays.from_numpy(s, v, inline, t.lgnb, t.vbits, cuda)
    c, n = codes.to(cuda), ln.to(cuda)
    with pytest.raises(TypeError, match="codes"):
        pl.encode_probe_radix(c.to(torch.int32), n, 7, False,
                              InputType.PROTEIN20, arr, False)
    with pytest.raises(ValueError, match="k=15"):
        pl.encode_probe_radix(c, n, 15, False, InputType.PROTEIN20, arr,
                              False)
    with pytest.raises(ValueError, match="never canonicalized"):
        pl.encode_only_radix(c, n, 4, True, InputType.PROTEIN20,
                             (0, 2, 4, 6))
    with pytest.raises(ValueError, match="2-bit words"):
        pl.encode_probe_radix(c, n, 7, False, InputType.DNA, arr, False)


# -- classify --trace-dir ------------------------------------------------------

@pytest.mark.cuda
def test_classify_trace_dir_counts_the_kernels(cuda, tmp_path):
    """The CLI's classify of the HiSeq set against the ec k=31 database
    with --trace-dir: the Kraken text is the golden's, the trace's K1
    (by instantiation), K2 and K3 events equal the wrappers' launch
    counts, and the stage ranges run on three threads."""
    import hashlib
    import json

    from bonsai_tpu_torch import cli
    from bonsai_tpu_torch.core.spacer import Spacer
    from bonsai_tpu_torch.db import build, formats
    from bonsai_tpu_torch.taxonomy.tree import TaxTree
    from bonsai_tpu_torch.tools import trace_summary

    data = os.path.join(os.path.dirname(__file__), "data")
    gold = os.path.join(data, "golden")
    kk = json.load(open(os.path.join(gold, "manifest.json")))["kraken"]
    nodes = os.path.join(gold, kk["nodes"])
    tree = TaxTree.from_nodes_dmp(nodes)
    table = build.lca_map([os.path.join(data, "ec", g) for g in kk["genomes"]],
                          tree, os.path.join(gold, kk["nameid"]),
                          Spacer(kk["k"], kk["k"]))
    img = str(tmp_path / "ec_img")
    formats.save_probe_image(img, formats.Database(
        table=table, k=kk["k"], w=kk["k"], gaps=[0] * (kk["k"] - 1)), tree)
    wrappers = (pl.encode_probe, res.resolve, pl.step_outputs)
    for w in wrappers:
        w.launches = 0
    pl.encode_probe.variants = {}
    out, tdir = str(tmp_path / "out.tsv"), str(tmp_path / "trace")
    s = kk["sets"]["HiSeq"]
    assert cli.main(["classify", img, nodes, os.path.join(data, s["reads"]),
                     "-a", "-c", "8192", "--trace-dir", tdir,
                     "-o", out]) == 0
    torch.cuda.synchronize()
    with open(out, "rb") as fh:
        assert hashlib.sha256(fh.read()).hexdigest() == s["sha256"]
    events = trace_summary.load(tdir)
    want = {f"encode_probe {v}": n for v, n in pl.encode_probe.variants.items()}
    want.update(resolve=res.resolve.launches,
                step_outputs=pl.step_outputs.launches)
    assert want["encode_probe sparse"] == 2 and want["resolve"] == 2
    got = {k: v[0] for k, v in trace_summary.classify_kernels(events).items()}
    assert got == want
    threads = trace_summary.stage_threads(events)
    assert len({t for s in ("parse", "dispatch", "format")
                for t in threads[s]}) == 3
