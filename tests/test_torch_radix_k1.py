"""K1's radix kernel (``bonsai_tpu_torch/csrc/encode_probe_radix.cu``),
transcribed.

The kernel cannot run on the CPU, so this file writes its layout and its
arithmetic in numpy, with its real runs (K1R_RUN_CONTIGUOUS positions a
thread for a contiguous seed, K1R_RUN_SPACED for a spaced one), and holds
the result, exactly, to the JAX package: ``BatchEncoder.emissions`` at
W = 1 with the input type (``bonsai_tpu/core/encoder.py``), then
``probe_slots_device`` (``bonsai_tpu/db/table.py:370``) and the hit /
cidx / oidx glue of the JAX step (``classify/pipeline.py:438-463``).

What is transcribed:

* each thread's run of positions i = R t .. R t + R - 1 of the flat (B,
  P) output from its first (b, p), the read's length read at the run's
  first position and where the run enters the next read (u16 or int32
  lengths);
* a contiguous seed's fold: k codes at the run's first position and at
  each new read, read 4 a word (the bytes past them, -1 past the tensor,
  left out), then rolled (``scores.cuh`` ``fold_roll``: the mask kept, or
  the outgoing code times radix^(k - 1) subtracted before the
  multiply-add, an ambiguous code in or out as 0) and ``fold_finish``; the
  byte of the last ambiguous code marks the positions holding one; a
  spaced seed's k codes gathered at its offsets; validity: p < len - (c -
  1), no ambiguous code, and a spaced k-mer not U64_MAX;
* the probe of a run together: every valid lane's first row (a bucket
  outside the rank's rows skipped in the range mode), the second rows of
  the lanes that missed, the sums of the matching lanes' value indices
  (inline, u32) or flat positions (64-bit, local in the range mode), the
  clamp to the value array, and the four outputs with want_idx on and
  off; encode only: the k-mers (0 where invalid) and valid.

The bucket range is held to ``probe_slots_device`` on the whole table
with every row outside the rank's emptied (its flat positions shifted by
4 row0: the JAX psum route's ``probe_local``, ``parallel/sharded.py:
466-501``, reads the rank's rows in place).  Rows are made to hold a k-mer
in two lanes, so that the sums pass the value array and the clamp
decides.  Cases: every type and k of ``RADIX_K1`` (as the card tests),
contiguous and spaced; P = 1, P = 3 (not a multiple of the run), the
stream's P = 34 (ld = 40 at c = 7: not a multiple of 16), contiguous
runs over two reads, reads shorter than c and empty; a read of 70,000
codes (int32 lengths; PROTEIN20 and PROTEIN_3BIT); reads of one position
under a spaced span of 63; ambiguous codes at a run's first position and
as a roll's outgoing code (counted, so that a case that stops reaching
them fails).
Tolerance: exact equality (integer work).
"""

import numpy as np
import pytest
import torch

import bonsai_tpu  # noqa: F401  (enables jax x64)
import jax.numpy as jnp
from bonsai_tpu.core.alphabet import InputType as JInputType
from bonsai_tpu.core.encoder import BatchEncoder as JBatchEncoder
from bonsai_tpu.core.spacer import Spacer as JSpacer
from bonsai_tpu.db.table import KmerTable as JKmerTable
from bonsai_tpu.db.table import probe_slots_device

from bonsai_tpu_torch.classify import pipeline as pl
from bonsai_tpu_torch.core.alphabet import (InputType, bits_of, kmer_mask,
                                            radix_of)
from bonsai_tpu_torch.db.table import ProbeArrays

U = np.uint64
M64 = (1 << 64) - 1
# csrc/encode_probe_radix.cu kRunContiguous, kRunSpaced
K1R_RUN_CONTIGUOUS, K1R_RUN_SPACED = 2, 1


def k1r_run(pos):
    """A thread's positions: kRun of the kernel's seed kind."""
    return K1R_RUN_CONTIGUOUS if pos is None else K1R_RUN_SPACED
BSALT = U(0xA24BAED4963EE407)
# as tests/test_torch_kernels.py RADIX_K1: shift-or folds (PROTEIN at 8
# bits, PROTEIN_3BIT at k = 22: 66 bits kept as 64, DNA2 at k = 32) and
# multiply-add folds (PROTEIN20, PROTEIN_14, PROTEIN_6 at their largest k)
RADIX_K1 = [(InputType.PROTEIN, 8), (InputType.PROTEIN_3BIT, 22),
            (InputType.DNA2, 32), (InputType.PROTEIN20, 7),
            (InputType.PROTEIN_14, 16), (InputType.PROTEIN_6, 24)]


def _splitmix64(x):
    x = x + U(0x9E3779B97F4A7C15)
    x = (x ^ (x >> U(30))) * U(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> U(27))) * U(0x94D049BB133111EB)
    return x ^ (x >> U(31))


class Fold:
    """scores.cuh Fold of input type ``it`` at k: fold_roll, fold_step
    (the spaced seed's), fold_finish."""

    def __init__(self, it, k):
        self.bits = bits_of(it)
        self.radix = U(radix_of(it))
        self.lim = U(kmer_mask(it, k))
        self.rpow = U(pow(radix_of(it), k - 1, 1 << 64))

    def roll(self, v, c, out):
        if self.bits is not None:
            return ((v << U(self.bits)) | c) & self.lim
        return (v - out * self.rpow) * self.radix + c

    def step(self, v, c):
        if self.bits is not None:
            return (v << U(self.bits)) | c
        return v * self.radix + c

    def finish(self, v):
        if self.bits is not None:
            return v & self.lim
        return np.where(v >= self.lim, v % np.maximum(self.lim, U(1)), v)


def k1r_encode(flat, B, ld, P, lengths, k, pos, it, seen=None):
    """numpy transcription of the kernel's encode: the codes tensor as its
    B ld bytes ``flat`` (int8) -> (k-mers (n,) u64, valid (n,)), n = B P.
    ``seen`` counts what the rows reached: runs entering a new read,
    ambiguous codes at a run's first position and going out of a roll."""
    seen = {} if seen is None else seen
    n = B * P
    c = k if pos is None else pos[-1] + 1
    R = k1r_run(pos)
    total = B * ld
    fold = Fold(it, k)
    # the threads, one a run: i = R t < n, its first position (b, p)
    i = R * np.arange((n + R - 1) // R, dtype=np.int64)
    b, p = i // P, i % P

    def code(g):
        """The code at byte g (-1 past the tensor: a word's bytes past the
        k codes, never used)."""
        inside = (g >= 0) & (g < total)
        return np.where(inside, flat[np.clip(g, 0, total - 1)],
                        -1).astype(np.int64)

    def length(bb):
        return lengths[np.clip(bb, 0, B - 1)].astype(np.int64)

    km = np.zeros((i.size, R), np.uint64)
    ok = np.zeros((i.size, R), bool)
    g = b * ld + p
    end = length(b) - (c - 1)
    v = np.zeros(i.size, np.uint64)
    last_n = np.full(i.size, -1, np.int64)
    for r in range(R):
        live = i + r < n
        fresh = (p == 0) if r else np.ones(i.size, bool)
        if r:
            seen["refold"] = seen.get("refold", 0) + int((fresh & live).sum())
            end = np.where(fresh, length(b) - (c - 1), end)
        inside = p < end
        if pos is not None:
            f = np.zeros(i.size, np.uint64)
            amb = np.zeros(i.size, bool)
            for j in range(k):
                cj = code(g + pos[j])
                amb |= cj < 0
                f = fold.step(f, np.maximum(cj, 0).astype(np.uint64))
            km[:, r] = fold.finish(f)
            good = inside & ~amb & (km[:, r] != U(M64))
            if r == 0:
                seen["first amb"] = seen.get("first amb", 0) + int(
                    (live & amb).sum())
        else:
            # the fresh fold, 4 codes a word: the bytes past the k codes
            # read and left out
            vf = np.zeros(i.size, np.uint64)
            lf = np.full(i.size, -1, np.int64)
            for j in range(0, k, 4):
                word = [code(g + j + u) for u in range(4)]
                for u in range(min(4, k - j)):
                    cj = word[u]
                    lf = np.where(cj < 0, g + j + u, lf)
                    vf = fold.roll(vf, np.maximum(cj, 0).astype(np.uint64),
                                   U(0))
            ci, co = code(g + k - 1), code(g - 1)
            vr = fold.roll(v, np.maximum(ci, 0).astype(np.uint64),
                           np.maximum(co, 0).astype(np.uint64))
            lr = np.where(ci < 0, g + k - 1, last_n)
            v = np.where(fresh, vf, vr)
            last_n = np.where(fresh, lf, lr)
            km[:, r] = fold.finish(v)
            good = inside & (last_n < g)
            if r == 0:
                seen["first amb"] = seen.get("first amb", 0) + int(
                    (live & (lf >= g)).sum())
            else:
                seen["amb out"] = seen.get("amb out", 0) + int(
                    (live & ~fresh & (co < 0)).sum())
        ok[:, r] = good & live
        p = p + 1
        wrap = p == P
        b = b + wrap
        p = np.where(wrap, 0, p)
        g = np.where(wrap, b * ld, g + 1)
    kmers = np.zeros(n, np.uint64)
    valid = np.zeros(n, bool)
    idx = i[:, None] + np.arange(R)
    inn = idx < n
    kmers[idx[inn]] = km[inn]
    valid[idx[inn]] = ok[inn]
    return kmers, valid


def k1r_probe(kmers, valid, slots, vals, inline, lgnb, vbits, want_idx,
              row0=0, rows=0, seen=None):
    """numpy transcription of a run's probes (lane by lane: the lanes of a
    run are independent once batched) -> (hit, valid, cidx int32, oidx
    u32).  ``rows`` > 0: the range mode, ``slots`` the rank's rows."""
    seen = {} if seen is None else seen
    bmask = U((1 << lgnb) - 1)
    vmask = U((1 << vbits) - 1)
    base = U(row0)
    nrows = slots.shape[0]
    h = _splitmix64(kmers)
    q = h >> U(lgnb)
    b1 = h & bmask
    acc = np.zeros(kmers.size, np.uint64)
    found = np.zeros(kmers.size, bool)
    for ch in range(2):
        bk = (b1 if ch == 0 else
              b1 ^ (_splitmix64(q ^ BSALT) & bmask)) - base
        todo = valid & ~found
        loaded = todo & ((bk < U(rows)) if rows else True)
        if rows and ch == 0:
            seen["range skip"] = seen.get("range skip", 0) + int(
                (todo & ~loaded).sum())
        row = slots[np.where(loaded, bk, 0).astype(np.int64) % nrows]
        e = U(1 << 63) | (q << U(vbits)) | (U(1 << 62) if ch else U(0))
        m = ((row & ~vmask) == e[:, None]) & loaded[:, None]
        add = (row & vmask) if inline else (
            bk[:, None] * U(4) + np.arange(4, dtype=np.uint64))
        acc = acc + np.where(m, add, U(0)).sum(axis=1, dtype=np.uint64)
        found |= m.any(axis=1)
    vflat = vals.reshape(-1)
    idx = np.where(inline, acc & U(0xFFFFFFFF), acc).astype(np.int64)
    clamp = found & (idx > vflat.size - 1)
    seen["clamp"] = seen.get("clamp", 0) + int(clamp.sum())
    val = np.where(found, vflat[np.minimum(idx, vflat.size - 1)], U(0))
    cidx = np.where(found, val & U(0xFFFFFFFF), U(0)).astype(np.uint32)
    oidx = np.where(found, (acc & U(0xFFFFFFFF)) if want_idx else val >> U(32),
                    U(0)).astype(np.uint32)
    return found, valid, cidx.view(np.int32), oidx


# -- the JAX package: the step's encode, probe and glue ---------------------

def jax_encode(codes, lengths, k, pos, it):
    gaps = None if pos is None else [b - a - 1 for a, b in zip(pos, pos[1:])]
    enc = JBatchEncoder(JSpacer(k, 0, gaps), canonicalize=False,
                        input_type=JInputType(int(it)))
    em = enc.emissions(codes, lengths.astype(np.int32))
    return np.asarray(em.values, np.uint64), np.asarray(em.mask, bool)


def jax_probe(kmers, valid, slots, vals, inline, lgnb, vbits, want_idx):
    packed, found, sel = probe_slots_device(
        jnp.asarray(kmers), jnp.asarray(slots), jnp.asarray(vals), inline,
        lgnb, vbits, want_idx=True)
    packed, found, sel = (np.asarray(packed), np.asarray(found),
                          np.asarray(sel))
    hit = valid & found
    cidx = np.where(hit, (packed & U(0xFFFFFFFF)).astype(np.uint32),
                    0).view(np.int32)
    oidx = np.where(hit, sel if want_idx else (packed >> U(32)).astype(
        np.uint32), 0).astype(np.uint32)
    return hit, valid, cidx, oidx


# -- rows and tables --------------------------------------------------------

def _reads(rng, it, B, L, c):
    """(B, L) int8 codes of ``it`` (2% ambiguous, -1 past each length; a
    row of the largest code, which folds to U64_MAX for PROTEIN_3BIT at
    k = 22) and int32 lengths: most L, some shorter than c, one 0."""
    top = min(radix_of(it), 128)
    codes = rng.integers(0, top, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.02] = -1
    lengths = rng.integers(c, L + 1, B).astype(np.int32)
    lengths[rng.random(B) < 0.5] = L
    if B > 8:
        codes[3] = top - 1
        lengths[3] = L
        short = rng.choice(np.arange(4, B), B // 8, replace=False)
        lengths[short] = rng.integers(0, c, B // 8)
        lengths[5] = 0
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return codes, lengths


def _tables(rng, kmers, valid, flat):
    """The JAX slot image of half the valid k-mers and random keys
    (U64_MAX among them), 6 packed values (inline) or one a key (flat):
    (slots, vals, inline, lgnb, vbits), and a copy whose rows hold a
    k-mer in two lanes (lgnb, vbits the same): sums past the value array
    and the clamp."""
    seen = np.unique(kmers[valid])
    keys = np.unique(np.concatenate([
        rng.choice(seen, seen.size // 2, replace=False),
        rng.integers(0, 2**64, 2000, dtype=np.uint64),
        np.array([M64], np.uint64)]))
    v = (np.arange(keys.size, dtype=np.uint64) if flat else
         rng.integers(0, 6, keys.size).astype(np.uint64))
    t = JKmerTable(keys, ((v + U(7)) << U(32)) | v)
    slots, vals, inline = t._encode_slots(t.vals_sorted,
                                          allow_inline=not flat)
    assert inline != flat
    twice = slots.copy()
    full = (twice != 0).all(axis=1)
    for r in np.flatnonzero(~full & (twice != 0).any(axis=1))[::3]:
        lane = np.flatnonzero(twice[r])[0]
        twice[r, np.flatnonzero(twice[r] == 0)[0]] = twice[r, lane]
    return (slots, vals, inline, t.lgnb, t.vbits), (twice, vals, inline,
                                                     t.lgnb, t.vbits)


def _rank(image, r, ndb=3):
    """Rank r's rows of ``image`` as the card holds them (padded to
    ceil(nb / ndb) rows) and the whole image with the other rows emptied,
    JAX's view of the same probe: (local image, row0, rows, masked)."""
    slots, vals, inline, lgnb, vbits = image
    nb = slots.shape[0]
    rps = (nb + ndb - 1) // ndb
    lo, hi = r * rps, min((r + 1) * rps, nb)
    z = np.zeros((rps - (hi - lo), 4), np.uint64)
    local = (np.concatenate([slots[lo:hi], z]), vals if inline else
             np.concatenate([vals[lo:hi], z]), inline, lgnb, vbits)
    ms = np.zeros_like(slots)
    ms[lo:hi] = slots[lo:hi]
    mv = vals.copy()
    if not inline:
        mv[:] = 0
        mv[lo:hi] = vals[lo:hi]
    return local, lo, rps, (ms, mv, inline, lgnb, vbits)


# -- the cases ----------------------------------------------------------------

def _span_positions(k, span):
    return tuple(int(x) for x in np.round(np.linspace(0, span - 1, k)))


# (shape, B, L of a seed of span c): P = 1 (a run over two reads), P = 3
# (not a multiple of the run), the stream's P = 34 (ld = c + 33, 40 at
# c = 7), a read of 70,000 codes, and reads of one position under a span
# of 63 (the spaced seeds only)
SHAPES = {"P=1": (700, lambda c: c), "P=3": (300, lambda c: c + 2),
          "stream": (120, lambda c: c + 33),
          "70000": (1, lambda c: 70_000),
          "span 63": (300, lambda c: c)}
# (the read of 70,000 codes at one type of each fold kind: its 70,000
# positions make it the slowest case)
CASES = [(shape, it, k, spaced) for shape in SHAPES for it, k in RADIX_K1
         for spaced in ((True,) if shape == "span 63" else (False, True))
         if shape != "70000" or it in (InputType.PROTEIN20,
                                       InputType.PROTEIN_3BIT)]


@pytest.mark.parametrize(
    "shape,it,k,spaced", CASES,
    ids=[f"{sh}-{t.name}-{k}-{'spaced' if sp else 'contiguous'}"
         for sh, t, k, sp in CASES])
def test_k1_radix_transcription_matches_jax(shape, it, k, spaced):
    rng = np.random.default_rng(int(it) * 131 + k * 7 + spaced
                                + 1000 * list(SHAPES).index(shape))
    c = 63 if shape == "span 63" else 2 * k - 1 if spaced else k
    pos = (_span_positions(k, c) if shape == "span 63" else
           tuple(range(0, c, 2)) if spaced else None)
    B, width = SHAPES[shape]
    L = width(c)
    codes, lengths = _reads(rng, it, B, L, c)
    if shape == "70000":
        lengths[0] = L - 3
    P = L - c + 1
    flat = codes.reshape(-1)
    seen = {}
    jk, jv = jax_encode(codes, lengths, k, pos, it)
    assert jv.any() and not jv.all()
    lens = [lengths] + ([lengths.astype(np.uint16)] if L < 1 << 16 else [])
    for ln in lens:
        kmers, valid = k1r_encode(flat, B, L, P, ln, k, pos, it, seen)
        np.testing.assert_array_equal(valid, jv.reshape(-1))
        np.testing.assert_array_equal(kmers[valid],
                                      jk.reshape(-1)[jv.reshape(-1)])
    # the port's plain version, which the card's kernel is held to
    pk, pv = pl.encode_only_radix_plain(torch.from_numpy(codes),
                                        torch.from_numpy(lengths), k, it, pos)
    np.testing.assert_array_equal(pv.numpy().reshape(-1), valid)
    np.testing.assert_array_equal(pk.numpy().view(U).reshape(-1),
                                  np.where(valid, kmers, U(0)))
    for flat_vals in (False, True):
        image, twice = _tables(rng, kmers, valid, flat_vals)
        for img in (image, twice):
            for want_idx in (False, True):
                got = k1r_probe(kmers, valid, *img[:2], img[2], img[3],
                                img[4], want_idx, seen=seen)
                want = jax_probe(jk.reshape(-1), jv.reshape(-1), *img[:2],
                                 img[2], img[3], img[4], want_idx)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
        for r in range(3):
            local, row0, rows, masked = _rank(image, r)
            for want_idx in (False, True):
                got = k1r_probe(kmers, valid, *local[:2], local[2], local[3],
                                local[4], want_idx, row0, rows, seen)
                want = list(jax_probe(jk.reshape(-1), jv.reshape(-1),
                                      *masked[:2], masked[2], masked[3],
                                      masked[4], want_idx))
                if want_idx and not local[2]:
                    # a flat index is the rank's own position
                    want[3] = np.where(want[0], want[3] - np.uint32(4 * row0),
                                       0).astype(np.uint32)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)
                if not local[2]:
                    # the port's plain version of the range mode
                    arr = ProbeArrays.from_numpy(*local[:3], local[3],
                                                 local[4], "cpu", row0, rows)
                    pw = pl.encode_probe_radix_plain(
                        torch.from_numpy(codes), torch.from_numpy(lengths),
                        k, it, arr, want_idx, pos)
                    np.testing.assert_array_equal(pw[0].numpy().reshape(-1),
                                                  got[0])
                    np.testing.assert_array_equal(
                        pw[3].numpy().view(np.uint32).reshape(-1), got[3])
    # what the rows reached
    assert seen["range skip"] > 0 and seen["clamp"] > 0
    if P % k1r_run(pos) and B > 1:
        assert seen["refold"] > 0
    if not spaced and shape in ("P=3", "stream"):
        assert seen["amb out"] > 0 and seen["first amb"] > 0
