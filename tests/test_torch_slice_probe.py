"""The sliced probe order designed for KB5, against the JAX package's
ScoreMap.

KB5 (``bonsai_tpu_torch/csrc/lookup_scores.cu``) probes one k-mer a
thread.  Its slice-by-slice design, measured against it on the card and
not kept (``PERF.md``, "PR 20"), stays runnable as the ``--hash`` edit
``kb5-sliced`` of ``bonsai_tpu_torch/tools/kernel_ab.py``
(``SLICED_KB5``), which checks its output against the kernel's there.
For an image past one 16 MiB slice it probes slice by slice: it counts the k-mers by the slice of their first bucket, writes (h, index)
into that order tile by tile, probes the first rows in that order (a
k-mer found there is scored), sends each miss into its second bucket's
slice of a miss list (each slice's room sized by the count of all k-mers
whose second bucket lies in it; places past its misses idle), then probes
the second rows in that order.  The kernel cannot run on the CPU, so
``sliced_scores`` transcribes those steps in numpy, and the tests hold it
to ``ScoreMap.lookup_scores`` of ``bonsai_tpu/db/table.py`` (its numpy
probe and its jnp one) and to the port's plain ``lookup_scores_plain``:
inline and flat images of 2 to 16 slices, k-mers whose two buckets lie in
different slices, 0, U64_MAX and repeated k-mers, every k-mer in one
slice, and images whose matching lanes sum past the values (the index
clamped).  Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bonsai_tpu  # noqa: F401  (enables jax x64)
from bonsai_tpu.db.table import KmerTable as JTable
from bonsai_tpu.db.table import ScoreMap as JScoreMap
from bonsai_tpu.db.table import probe_slots_device

from bonsai_tpu_torch.db.table import (BSALT, ProbeArrays, lookup_scores_plain,
                                       splitmix64_np)

torch.set_num_threads(1)
U = np.uint64
U64_MAX = U(2**64 - 1)
TILE = 2048  # k-mers a block of steps 1 and 2 (kTile)


def buckets(q, lgnb):
    h = splitmix64_np(np.asarray(q, dtype=np.uint64))
    mask = U((1 << lgnb) - 1)
    b1 = h & mask
    b2 = b1 ^ (splitmix64_np((h >> U(lgnb)) ^ U(BSALT)) & mask)
    return h, b1.astype(np.int64), b2.astype(np.int64)


def _match(slots, b, e, vbits, inline):
    """probe.cuh's match_row of rows ``b``: (hit, the sum of the matching
    lanes' value fields or flat positions)."""
    vmask = U((1 << vbits) - 1)
    row = slots[b]
    m = (row & ~vmask) == e[:, None]
    if inline:
        acc = np.where(m, row & vmask, U(0)).sum(-1, dtype=np.uint64)
        acc = acc & U(0xFFFFFFFF)
    else:
        pos = (b[:, None] * 4 + np.arange(4)).astype(np.uint64)
        acc = np.where(m, pos, U(0)).sum(-1, dtype=np.uint64)
    return m.any(-1), acc.astype(np.int64)


def sliced_scores(q, slots, vals, inline, lgnb, vbits, ls):
    """numpy transcription of KB5's sliced path over 2^ls slices of the
    image's rows: u64 k-mers -> u64 scores, and the list orders it made."""
    n = q.size
    S, shift = 1 << ls, lgnb - ls
    h, b1, b2 = buckets(q, lgnb)
    s1, s2 = b1 >> shift, b2 >> shift
    flat = np.asarray(vals, dtype=np.uint64).reshape(-1)

    def value(acc):
        return flat[np.minimum(acc, flat.size - 1)]

    # 1. the first buckets' slices counted
    start1 = np.concatenate([[0], np.cumsum(np.bincount(s1, minlength=S))])
    # 2. a tile at a time, staged by slice, each run reserved at its
    # slice's cursor; the second buckets' slices counted
    cur1 = np.zeros(S, np.int64)
    cnt2 = np.zeros(S, np.int64)
    order = np.full(n, -1, np.int64)  # list place -> k-mer index
    for t0 in range(0, n, TILE):
        idx = np.arange(t0, min(n, t0 + TILE))
        staged = idx[np.argsort(s1[idx], kind="stable")]
        for s in np.unique(s1[idx]):
            run = staged[s1[staged] == s]
            g = start1[s] + cur1[s]
            order[g: g + run.size] = run
            cur1[s] += run.size
        cnt2 += np.bincount(s2[idx], minlength=S)
    assert (order >= 0).all() and (np.diff(s1[order]) >= 0).all()
    out = np.zeros(n, np.uint64)
    written = np.zeros(n, np.int64)
    # 3. the first rows in slice order; misses by their second slice
    e = U(1 << 63) | ((h >> U(lgnb)) << U(vbits))
    hit, acc = _match(slots, b1[order], e[order], vbits, inline)
    out[order[hit]] = value(acc[hit])
    written[order[hit]] += 1
    start2 = np.concatenate([[0], np.cumsum(cnt2)])
    cur2 = np.zeros(S, np.int64)
    misses = np.full(n, -1, np.int64)  # miss list place -> k-mer index
    for i in order[~hit]:
        misses[start2[s2[i]] + cur2[s2[i]]] = i
        cur2[s2[i]] += 1
    # 4. every place of the miss list; those past a slice's misses idle
    p = np.arange(n)
    lo = np.searchsorted(start2, p, side="right") - 1
    live = p - start2[lo] < cur2[lo]
    i = misses[live]
    assert (i >= 0).all() and (misses[~live] == -1).all()
    hit2, acc2 = _match(slots, b2[i], e[i] | U(1 << 62), vbits, inline)
    out[i] = np.where(hit2, value(acc2), U64_MAX)
    written[i] += 1
    assert (written == 1).all()
    return out, order, misses[live]


def tables(rng, keys, mode, lgnb):
    """The JAX phase-1 table of ``keys`` in 2^lgnb buckets (6 values
    inline, one a key flat) and its image (slots, vals, inline)."""
    keys = np.unique(np.asarray(keys, dtype=np.uint64))
    v = (np.arange(keys.size, dtype=np.uint64) if mode == "flat" else
         rng.integers(0, 6, keys.size).astype(np.uint64))
    jt = JTable(keys, ((v + U(7)) << U(32)) | v, min_nb=1 << lgnb)
    assert jt.lgnb == lgnb
    slots, vals, inline = jt.arrays_np()
    assert inline == (mode == "inline")
    return jt, slots, vals, inline


def _queries(rng, jt):
    """Half stored, half random, 0 and U64_MAX (stored), repeats."""
    stored = rng.choice(jt.keys_sorted, 3000)
    return np.concatenate([stored, rng.integers(0, 2**64, 3000, dtype=U),
                           np.array([0, U64_MAX, 0, U64_MAX], U), stored[:50]])


def _jax_scores(jt, q):
    want = JScoreMap(jt).lookup_scores(q)
    dev = np.asarray(JScoreMap(jt).lookup_scores(jnp.asarray(q)))
    np.testing.assert_array_equal(dev, want)
    return want


@pytest.mark.parametrize("mode", ["inline", "flat"])
@pytest.mark.parametrize("ls", [1, 2, 4])
def test_slice_order_matches_jax(mode, ls):
    rng = np.random.default_rng(ls + 10 * (mode == "flat"))
    lgnb = 10
    keys = np.concatenate([rng.integers(0, 2**64, 3000, dtype=U),
                           np.array([0, U64_MAX], U)])
    jt, slots, vals, inline = tables(rng, keys, mode, lgnb)
    q = _queries(rng, jt)
    want = _jax_scores(jt, q)
    got, order, misses = sliced_scores(q, slots, vals, inline, lgnb,
                                       jt.vbits, ls)
    np.testing.assert_array_equal(got, want)
    arr = ProbeArrays.from_numpy(slots, vals, inline, lgnb, jt.vbits, "cpu")
    plain = lookup_scores_plain(torch.from_numpy(q.view(np.int64)), arr)
    np.testing.assert_array_equal(plain.numpy().view(U), want)
    # the second rows: found there, and in another slice than the first
    _, b1, b2 = buckets(q, lgnb)
    shift = lgnb - ls
    other = (b1[misses] >> shift) != (b2[misses] >> shift)
    assert other.any()
    assert (want[misses] != U64_MAX).any() and (want[misses] == U64_MAX).any()
    assert (want[-54:-50] != U64_MAX).all()  # 0 and U64_MAX, stored


@pytest.mark.parametrize("mode", ["inline", "flat"])
def test_slice_order_one_slice_of_keys(mode):
    """Every k-mer's first bucket in slice 0 of 8, every missing one's
    second bucket in another."""
    rng = np.random.default_rng(3 + (mode == "flat"))
    lgnb, ls = 11, 3
    keys = rng.integers(0, 2**64, 6000, dtype=U)
    jt, slots, vals, inline = tables(rng, keys, mode, lgnb)
    _, b1, _ = buckets(jt.keys_sorted, lgnb)
    stored = jt.keys_sorted[(b1 >> (lgnb - ls)) == 0]
    cand = rng.integers(0, 2**64, 200_000, dtype=U)
    _, c1, c2 = buckets(cand, lgnb)
    lacking = cand[((c1 >> (lgnb - ls)) == 0) & ((c2 >> (lgnb - ls)) != 0)]
    q = np.concatenate([stored, lacking[:3000]])
    want = _jax_scores(jt, q)
    got, _, misses = sliced_scores(q, slots, vals, inline, lgnb, jt.vbits, ls)
    np.testing.assert_array_equal(got, want)
    assert (want[-3000:] == U64_MAX).all() and misses.size >= 3000


@pytest.mark.parametrize("mode", ["inline", "flat"])
def test_slice_order_clamps_the_value_index(mode):
    """An image whose k-mer matches in two lanes of its row: the lanes'
    fields (inline) or positions (flat) summed past the values, clamped to
    the last, as the JAX probe clamps its gather."""
    rng = np.random.default_rng(5 + (mode == "flat"))
    lgnb, ls = 10, 2
    keys = rng.integers(0, 2**64, 2500, dtype=U)
    jt, slots, vals, inline = tables(rng, keys, mode, lgnb)
    slots = slots.copy()
    occupied = (slots >> U(63)) == 1
    # rows with one free lane (flat: past half the rows, whose two
    # positions sum past the values): copy an occupied lane into it
    rows = np.flatnonzero(occupied.sum(1) == 3)
    rows = rows[rows >= (0 if inline else (1 << lgnb) // 2 + 8)][:40]
    for r in rows:
        free = np.flatnonzero(~occupied[r])[0]
        src = np.flatnonzero(occupied[r])[-1]
        slots[r, free] = slots[r, src]
        if inline:  # the largest index field, so that the sum passes
            vmask = U((1 << jt.vbits) - 1)
            slots[r, free] = (slots[r, free] & ~vmask) | U(vals.size - 1)
    q = np.concatenate([jt.keys_sorted, rng.integers(0, 2**64, 500, dtype=U)])
    val, found = probe_slots_device(jnp.asarray(q), jnp.asarray(slots),
                                    jnp.asarray(vals), inline, lgnb, jt.vbits)
    want = np.where(np.asarray(found), np.asarray(val).astype(U), U64_MAX)
    got, _, _ = sliced_scores(q, slots, vals, inline, lgnb, jt.vbits, ls)
    np.testing.assert_array_equal(got, want)
    nv = np.asarray(vals).size
    assert (got == np.asarray(vals).reshape(-1)[nv - 1]).sum() > 10
