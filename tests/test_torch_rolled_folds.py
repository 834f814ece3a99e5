"""KB1's rolled fold of the other alphabets and K128's pack, transcribed.

Two kernels roll what they once rebuilt a position at a time, and neither
can run on the CPU, so this file transcribes their arithmetic in numpy,
tile by tile and run by run with their real tile and run sizes, and holds
it, exactly, to the JAX package:

* KB1 (``bonsai_tpu_torch/csrc/minimizers.cu``), another alphabet's
  contiguous seed at W = 1: each thread of a tile of KB1_TILE slots folds
  its run's first k - 1 codes, then rolls the fold across its KB1_RUN
  slots, one staged code in and one out a position (``scores.cuh``
  ``fold_roll``): shift-or with the mask kept at each step, or the
  outgoing code times radix^(k - 1) subtracted before the multiply-add,
  modulo 2^64, then ``fold_finish``; an ambiguous code folds as 0 coming
  in and going out, and the last one's index marks the seeds that hold
  it.  Held to ``bonsai_tpu.core.encode._pack`` and
  ``apply_mask`` with ``position_validity``, for every alphabet but DNA
  at k = 1, the middle k and the largest (``nper64``).
* K128 (``bonsai_tpu_torch/csrc/encode128.cu``), the pack: each thread of
  a tile of K128_TILE positions builds its first window from the staged
  code words (4 codes a u32 folded into 8 bits by one multiply, the
  words read at the row's own byte offset from 16 B), then rolls the
  128-bit k-mer and, for the canonical pack, its reverse complement
  (rlo = rlo >> 2 | rhi << 62, rhi = rhi >> 2 | (3 - c) << 2(k_hi - 1))
  across its K128_RUN windows; a window holding a code past 3 is packed
  again from its codes and takes the rc formula.  Held to
  ``bonsai_tpu.core.encode128.pack_kmers128`` and ``canonical128`` at
  k = 33, 40, 55 and 64, with the bytes the staging leaves unwritten set
  at random (they must not matter).

Rows put ambiguous codes at the ends of a thread's run and of a tile and
as the outgoing code of a roll, codes past 3 (K128), and come in P = 1,
exactly one tile and ragged.  Tolerance: exact equality (integer work).
"""

import numpy as np
import pytest
import torch

from bonsai_tpu.core import encode as jenc
from bonsai_tpu.core import encode128 as j128
from bonsai_tpu.core.alphabet import (InputType, bits_of, kmer_mask, nper64,
                                      radix_of)

from bonsai_tpu_torch.core import encode128 as e128
from bonsai_tpu_torch.core import encoder as enc

torch.set_num_threads(1)
U = np.uint64
M64 = (1 << 64) - 1
KB1_RUN, KB1_TILE = 16, 4096  # csrc/minimizers.cu kRun, kTile
K128_RUN, K128_THREADS = 16, 128  # csrc/encode128.cu kRun, kThreads
K128_TILE = K128_RUN * K128_THREADS
K128_CODE_BYTES = K128_TILE + 64 + 32  # csrc/encode128.cu kCodeBytes
RADIX_TYPES = [t for t in InputType if t != InputType.DNA]


# -- KB1: the rolled fold ------------------------------------------------------

def kb1_rolled(codes, lengths, k, it):
    """numpy transcription of KB1's rolled fold: (B, L) int8 codes, (B,)
    lengths -> (values (B, E) u64, emitted (B, E)), E = L - k + 1."""
    B, L = codes.shape
    E = L - k + 1
    bits, radix, lim = bits_of(it), U(radix_of(it)), U(kmer_mask(it, k))
    rpow = U(pow(radix_of(it), k - 1, 1 << 64))

    def roll(v, c, out):  # scores.cuh fold_roll
        if bits is not None:
            return ((v << U(bits)) | c) & lim
        return (v - out * rpow) * radix + c

    threads = KB1_TILE // KB1_RUN
    p0 = KB1_RUN * np.arange(threads)
    values = np.zeros((B, E), np.uint64)
    emitted = np.zeros((B, E), bool)
    for b in range(B):
        n_push = max(int(lengths[b]) - (k - 1), 0)
        for j0 in range(0, E, KB1_TILE):
            # the staged tile: its codes and the k - 1 halo, -1 past the row
            staged = np.full(KB1_TILE + k - 1, -1, np.int64)
            part = codes[b, j0: j0 + KB1_TILE + k - 1]
            staged[: part.size] = part
            # each run's first k - 1 codes, then its seeds r: code
            # k - 1 + r in and, past the first, code r - 1 out
            v = np.zeros(threads, np.uint64)
            last_n = np.full(threads, -1)
            for i in range(k - 1):
                c = staged[p0 + i]
                last_n = np.where(c < 0, i, last_n)
                v = roll(v, np.maximum(c, 0).astype(np.uint64), U(0))
            val = np.zeros((threads, KB1_RUN), np.uint64)
            bad = np.zeros((threads, KB1_RUN), bool)
            for r in range(KB1_RUN):
                c = staged[p0 + k - 1 + r]
                o = staged[p0 + r - 1] if r else np.zeros(threads, np.int64)
                last_n = np.where(c < 0, k - 1 + r, last_n)
                v = roll(v, np.maximum(c, 0).astype(np.uint64),
                         np.maximum(o, 0).astype(np.uint64))
                val[:, r] = v if bits is not None else np.where(
                    v >= lim, v % lim, v)
                bad[:, r] = last_n >= r
            js = j0 + np.arange(KB1_TILE)
            m = min(KB1_TILE, E - j0)
            values[b, j0: j0 + m] = val.ravel()[:m]
            emitted[b, j0: j0 + m] = ((js < n_push) & ~bad.ravel())[:m]
    return values, emitted


def _kb1_rows(rng, k, it):
    """Rows of the type's codes (-1 ambiguous; PROTEIN's bytes past 127
    too): ambiguous codes at the ends of a thread's run and of a tile, at
    a run's 15th code (the outgoing code of its last roll), a run of them
    longer than k across a tile edge, a row of the largest
    code (PROTEIN_3BIT at k = 22: U64_MAX), a row shorter than its width;
    then rows of P = 1 and of exactly one tile."""
    hi = 128 if radix_of(it) == 256 else radix_of(it)
    L = 2 * KB1_TILE + 37 + k - 1

    def draw(shape):
        c = rng.integers(0, hi, shape).astype(np.int8)
        c[rng.random(shape) < 0.01] = -1
        if hi == 128:
            past = rng.random(shape) < 0.01
            c[past] = rng.integers(-128, 0, int(past.sum()))
        return c

    codes = draw((5, L))
    for p in (0, KB1_RUN - 1, KB1_RUN, 2 * KB1_RUN - 1, KB1_TILE - 1,
              KB1_TILE, KB1_TILE + KB1_RUN - 1, KB1_RUN + 14,
              KB1_TILE + 14, 2 * KB1_TILE + 5):
        codes[0, p] = -1
    codes[1, KB1_TILE - 20: KB1_TILE + k + 20] = -1
    codes[2] = hi - 1
    lengths = np.array([L, L - 3, L, L - KB1_TILE, k - 1], np.int32)
    yield codes, lengths
    yield draw((2, k)), np.array([k, k], np.int32)
    one = draw((2, KB1_TILE + k - 1))
    one[0, KB1_TILE - 1] = -1
    yield one, np.array([KB1_TILE + k - 1, KB1_TILE], np.int32)


@pytest.mark.parametrize("it", RADIX_TYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("which", ["one", "mid", "nper64"])
def test_kb1_rolled_fold_matches_jax(it, which):
    n = nper64(it)
    k = {"one": 1, "mid": (n + 1) // 2, "nper64": n}[which]
    rng = np.random.default_rng(int(it) * 13 + k)
    for codes, lengths in _kb1_rows(rng, k, it):
        got, em = kb1_rolled(codes, lengths, k, it)
        kmers, invalid = jenc._pack(codes, [1] * (k - 1), it)
        want = jenc.apply_mask(kmers, k, it)
        valid = jenc.position_validity(lengths, want.shape[-1], k) & ~invalid
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(em, valid)
        # the port's plain version, which the card's kernel is held to
        pv = enc.minimizers_plain(torch.from_numpy(codes),
                                  torch.from_numpy(lengths), k, 1, False,
                                  it=it)
        np.testing.assert_array_equal(got, pv.values.numpy().view(U))
        np.testing.assert_array_equal(em, pv.mask.numpy())


def test_kb1_rolled_fold_keeps_a_real_u64_max():
    """PROTEIN_3BIT at k = 22 folds 66 bits: 22 codes of 7 roll to
    U64_MAX, a valid seed."""
    it = InputType.PROTEIN_3BIT
    codes = np.full((1, 100), 7, np.int8)
    got, em = kb1_rolled(codes, np.array([100], np.int32), 22, it)
    assert (got == U(M64)).all() and em.all()


# -- K128: the pack ------------------------------------------------------------

def _u32(x):
    return np.asarray(x, dtype=np.uint64) & U(0xFFFFFFFF)


def _fold4(w):
    """csrc/encode128.cu fold4: 4 codes' low 2 bits (an ambiguous code as
    0), first code high, by one multiply; w holds them as bytes."""
    amb = (w >> U(7)) & U(0x01010101)
    x = w & _u32(~(amb * U(3))) & U(0x03030303)
    return (_u32(x * U(0x40100401))) >> U(24)


def _codes4(w32, b):
    """csrc/encode128.cu codes4: the u32 of the 4 staged bytes from byte b,
    by a funnel shift of the two words that hold them."""
    lo, hi = w32[b >> 2], w32[(b >> 2) + 1]
    return _u32(((hi << U(32)) | lo) >> (U(8) * (b & 3).astype(np.uint64)))


def _top_byte(x):
    """The index of the highest set byte of each u32 (x != 0)."""
    return sum((x >= U(1 << s)).astype(np.int64) for s in (8, 16, 24))


def _first_window(w32, b, k):
    """csrc/encode128.cu first_window: the lanes of each thread's first
    window and the index of its last ambiguous code and code past 3."""
    n = b.size
    a = np.zeros(n, np.uint64)
    c = np.zeros(n, np.uint64)
    ln = np.full(n, -1)
    lb = np.full(n, -1)
    for q in range((k + 3) >> 2):
        w = _codes4(w32, b + 4 * q)
        f = _fold4(w)
        if q < 8:
            a |= f << U(56 - 8 * q)
        else:
            c |= f << U(120 - 8 * q)
        left = k - 4 * q
        if left < 4:
            w = w & U((1 << (8 * left)) - 1)
        amb = w & U(0x80808080)
        big = _u32((w & U(0x7C7C7C7C)) + U(0x7F7F7F7F)) & _u32(~w) & U(
            0x80808080)
        ln = np.where(amb != 0, 4 * q + _top_byte(amb), ln)
        lb = np.where(big != 0, 4 * q + _top_byte(big), lb)
    s = 128 - 2 * k
    hi = a >> U(s)
    lo = (c >> U(s)) | (a << U(64 - s)) if s else c
    return hi, lo, ln, lb


def _rc128(hi, lo, k_hi):
    """csrc/encode128.cu rc128 (the JAX formula) on u64 lanes."""
    return j128.reverse_complement128(hi, lo, 32 + k_hi)


def _pack_direct(cp, k):
    """csrc/encode128.cu pack_direct of one window's k codes."""
    k_hi = k - 32
    h = lo = 0
    for j in range(k):
        x = max(int(cp[j]), 0)
        if j < k_hi:
            h |= x << (2 * (k_hi - 1 - j))
        else:
            lo |= x << (2 * (k - 1 - j))
    return U(h & M64), U(lo & M64)


def k128_pack(codes, k, canon, offset, rng):
    """numpy transcription of K128's pack: (B, L) int8 codes whose row b
    starts ``offset`` + b L bytes past a 16-B boundary -> (hi, lo, invalid)
    (B, P), tile by tile and run by run."""
    B, L = codes.shape
    P = L - k + 1
    k_hi = k - 32
    hmask = U(M64 if k_hi == 32 else (1 << (2 * k_hi)) - 1)
    out = [np.zeros((B, P), np.uint64), np.zeros((B, P), np.uint64),
           np.zeros((B, P), bool)]
    r0 = K128_RUN * np.arange(K128_THREADS)
    for row in range(B):
        for p0 in range(0, P, K128_TILE):
            # the staging: 16-B chunks from the aligned byte at or below the
            # tile's first code, -1 outside the row; the bytes past the last
            # chunk are never written (random here)
            shift = (offset + row * L + p0) % 16
            need = K128_TILE + k - 1
            avail = min(need, L - p0)
            nchunk = (shift + need + 15) >> 4
            s_code = rng.integers(-128, 128, K128_CODE_BYTES).astype(np.int8)
            s_code[: nchunk * 16] = -1
            s_code[shift: shift + avail] = codes[row, p0: p0 + avail]
            w32 = s_code.view(np.uint32).astype(np.uint64)
            b0 = shift + r0
            hi, lo, last_n, last_big = _first_window(w32, b0, k)
            if canon:
                rhi, rlo = _rc128(hi, lo, k_hi)
            ins = [_codes4(w32, b0 + k + 4 * q) for q in range(K128_RUN // 4)]
            h_out = np.zeros((K128_THREADS, K128_RUN), np.uint64)
            l_out = np.zeros_like(h_out)
            inv = np.zeros(h_out.shape, bool)
            big = np.zeros(h_out.shape, bool)
            for r in range(K128_RUN):
                if r > 0:
                    byte = (ins[(r - 1) >> 2] >> U(8 * ((r - 1) & 3))) & U(255)
                    cc = byte.astype(np.int64) - 256 * (byte >= 128)
                    last_n = np.where(cc < 0, r + k - 1, last_n)
                    last_big = np.where(cc > 3, r + k - 1, last_big)
                    u = np.where(cc < 0, 0, cc & 3).astype(np.uint64)
                    hi = ((hi << U(2)) | (lo >> U(62))) & hmask
                    lo = (lo << U(2)) | u
                    if canon:
                        rlo = (rlo >> U(2)) | (rhi << U(62))
                        rhi = (rhi >> U(2)) | ((U(3) - u) << U(2 * k_hi - 2))
                h_out[:, r], l_out[:, r] = hi, lo
                if canon:
                    take = (rhi < hi) | ((rhi == hi) & (rlo < lo))
                    h_out[:, r] = np.where(take, rhi, hi)
                    l_out[:, r] = np.where(take, rlo, lo)
                inv[:, r] = last_n >= r
                big[:, r] = last_big >= r
            for t, r in zip(*np.nonzero(big)):
                h, l = _pack_direct(s_code[b0[t] + r:], k)
                if canon:
                    h, l = j128.canonical128(np.array([h]), np.array([l]), k)
                    h, l = h[0], l[0]
                h_out[t, r], l_out[t, r] = h, l
            m = min(K128_TILE, P - p0)
            for o, x in zip(out, (h_out, l_out, inv)):
                o[row, p0: p0 + m] = x.ravel()[:m]
    return tuple(out)


def _k128_rows(rng, k):
    """DNA rows of two tiles and a ragged one: ambiguous codes at the ends
    of a thread's run and of a tile, at a run's 15th code (the outgoing
    code of its last roll), a run of them longer than k, an all-N row,
    codes past 3 (some in the first window of a run); then P = 1 and
    exactly one tile."""
    L = 2 * K128_TILE + 300
    codes = rng.integers(0, 4, (5, L)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.02] = -1
    codes[1, :] = -1
    codes[2, 15::16] = -1
    codes[0, [14, K128_RUN + 14, K128_TILE + 14]] = -1
    codes[3, K128_TILE - 1: K128_TILE + 1] = -1
    codes[3, 500: 500 + 2 * k] = -1
    idx = rng.integers(0, L, 40)
    codes[4, idx] = rng.integers(4, 128, 40).astype(np.int8)
    codes[4, [0, K128_RUN, K128_TILE + 3]] = [4, 127, 64]
    yield codes
    yield codes[:, :k].copy()
    yield codes[:2, : K128_TILE + k - 1].copy()


@pytest.mark.parametrize("k", [33, 40, 55, 64])
@pytest.mark.parametrize("canon", [False, True])
@pytest.mark.parametrize("offset", [0, 3])
def test_k128_pack_matches_jax(k, canon, offset):
    rng = np.random.default_rng(k * 4 + canon * 2 + offset)
    for codes in _k128_rows(rng, k):
        hi, lo, inv = k128_pack(codes, k, canon, offset, rng)
        jhi, jlo, jinv = j128.pack_kmers128(codes, k)
        if canon:
            jhi, jlo = j128.canonical128(jhi, jlo, k)
        np.testing.assert_array_equal(hi, jhi)
        np.testing.assert_array_equal(lo, jlo)
        np.testing.assert_array_equal(inv, jinv)
        # the port's plain version, which the card's kernel is held to
        ph, pl, pinv = e128.pack_kmers128_plain(torch.from_numpy(codes), k,
                                                canon)
        np.testing.assert_array_equal(hi, ph.numpy().view(U))
        np.testing.assert_array_equal(lo, pl.numpy().view(U))
        np.testing.assert_array_equal(inv, pinv.numpy())


@pytest.mark.parametrize("k", [33, 40, 55, 64])
def test_k128_rolled_reverse_complement_matches_jax(k):
    """The rolled reverse complement alone, one window after another from
    the JAX rc of the first: equal to the JAX rc of every window of codes
    0..3 (an N packs as 0)."""
    rng = np.random.default_rng(k + 500)
    codes = rng.integers(-1, 4, (1, 400)).astype(np.int8)
    hi, lo, _ = j128.pack_kmers128(codes, k)
    whi, wlo = j128.reverse_complement128(hi, lo, k)
    k_hi = k - 32
    rhi, rlo = whi[0, 0], wlo[0, 0]
    for p in range(1, hi.shape[1]):
        u = U(max(int(codes[0, p + k - 1]), 0))
        rlo = (rlo >> U(2)) | (rhi << U(62))
        rhi = (rhi >> U(2)) | ((U(3) - u) << U(2 * k_hi - 2))
        assert (rhi, rlo) == (whi[0, p], wlo[0, p])


def test_fold4_and_the_flag_spread():
    """fold4 on every byte pattern of one code (the others 0, 255 and
    random), and the nibble-to-bytes spread of K128's flag store."""
    rng = np.random.default_rng(4)
    for pos in range(4):
        for v in range(256):
            w = np.array([v << (8 * pos)], np.uint64)
            w |= U(rng.integers(0, 1 << 32)) & _u32(~(U(255) << U(8 * pos)))
            by = [(int(w[0]) >> (8 * j)) & 255 for j in range(4)]
            want = 0
            for j, x in enumerate(by):
                want |= (0 if x >= 128 else x & 3) << (6 - 2 * j)
            assert int(_fold4(w)[0]) == want
    for n in range(16):
        spread = (n * 0x00204081) & 0x01010101
        assert spread == sum(((n >> j) & 1) << (8 * j) for j in range(4))
