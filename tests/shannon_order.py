"""Rows on which the order of the DNA Shannon score's additions decides a
window's minimizer, for ``tests/test_torch_entropy.py`` (the port's plain
version against the JAX package) and ``tests/test_torch_kernels.py`` (KB4
and KB1 spaced on the card).  Imports no jax.

The scheme ``entropy`` adds the terms p ln p of the codes a seed holds in
ascending code order, A, C, G, T (numpy's order over the code axis).
Adding G's term before C's (``swapped_order``) moves H by one ulp on some
seeds of A, C and G.  The rows below are built so that such an ulp moves
two seeds of one window across each other, and only rows on which the
port's plain version, in the two orders, emits another minimizer are kept.

- ``kb4_rows``: -k 31 -w 40, canonical (W = 10, eps 1e-3).  A seed's
  63-bit k-mer rounds to a double of 53 bits before the divide, so two
  seeds of one composition whose k-mers differ in their last bases can
  round to neighbouring doubles whose quotients tie in one order and not
  in the other (a tie goes to the smaller k-mer, else the larger k-mer
  has the smaller score).  A row is ten 31-base segments, each followed
  by an N, so that its compacted stream is exactly those ten seeds: such
  a pair, then eight seeds that start with A (scored above both).
- ``kb1_spaced_rows``: -k 21 -S 0x16,1x4 -w 40 (W = 16, eps 1e-4).  A
  periodic row repeats a block of d bases; the seed at p + d equals the
  one at p but for its last base, set to A where the period puts a C:
  its k-mer is one less, and its A and C counts are the other's swapped
  (A = x + 1, C = x against A = x, C = x + 1), so the two sums hold the
  same terms and agree in the true order.  Their scores then tie or not
  by where the quotient falls, which G's term added before C's can move.

The other alphabets (``radix_rows``) add their terms in numpy's pairwise
order too: PROTEIN20 (R = 20) into eight accumulators by code mod 8 for
codes 0..15, then codes 16..19 in order; PROTEIN_6 (R = 6) in order.
``radix_other_order`` adds PROTEIN20's terms in code order (no
accumulators) and PROTEIN_6's with codes 1 and 2 exchanged.  A pair of
seeds of one composition (the second is the first with its last codes
permuted) whose k-mers pass 2^53 and round to neighbouring doubles is
taken where its scores order one way in numpy's order and the other
way in the other; a row holds the pair as the only seeds of one window
of W = 2:
- KB4 (``radix_kb4_call``, contiguous, eps 1e-3): the two seeds with an
  ambiguous code between them, so the compacted stream is the pair;
- KB1 (``radix_kb1_call``, the spaced seed of every other code,
  "1x(k-1)", eps 1e-4): the two seeds interleaved, so the seeds at 0 and
  1 are the pair and the row holds no other.
PROTEIN20 runs at k = 14 (two registers of counts on the card) and
PROTEIN_6 at k = 24.
"""

import contextlib

import numpy as np
import torch

SWAP = [0, 2, 1, 3]  # the code axis with C and G exchanged
SPACING21 = "0x16,1x4"


@contextlib.contextmanager
def swapped_order():
    """The port's plain scheme ``entropy`` adding G's term before C's:
    its code counts come with C's and G's columns exchanged."""
    from bonsai_tpu_torch.core import entropy

    w, s = entropy.window_code_counts, entropy.spaced_code_counts
    entropy.window_code_counts = lambda *a: w(*a)[..., SWAP]
    entropy.spaced_code_counts = lambda *a: s(*a)[..., SWAP]
    try:
        yield
    finally:
        entropy.window_code_counts, entropy.spaced_code_counts = w, s


def kb4_call(codes, lengths):
    """KB4 -k 31 -w 40 canonical under the scheme ``entropy``."""
    from bonsai_tpu_torch.core import encoder as enc

    return enc.compacted_minimizers(codes, lengths, 31, 10, "entropy",
                                    canon=True)


def positions21():
    from bonsai_tpu_torch.core.spacer import Spacer

    return tuple(int(p) for p in Spacer(21, 21, SPACING21).positions)


def kb1_spaced_call(codes, lengths):
    """KB1 -k 21 -S 0x16,1x4 -w 40 under the scheme ``entropy``."""
    from bonsai_tpu_torch.core import encoder as enc

    return enc.minimizers(codes, lengths, 21, 16, False, "entropy",
                          positions21())


def _scores(kmers, counts, k, eps):
    """(true order, swapped order) u64 scores of seeds ``kmers`` (int64
    tensor) with per-code ``counts`` (..., 4)."""
    from bonsai_tpu_torch.core import entropy

    out = []
    for c in (counts, counts[..., SWAP]):
        h = entropy.entropy_value(c, k)
        out.append(entropy.entropy_scores(kmers, h, eps).numpy().view(
            np.uint64))
    return out


def _before(s1, k1, s2, k2):
    """(s1, k1) orders before (s2, k2), unsigned."""
    return (s1 < s2) | ((s1 == s2) & (k1 < k2))


def _pack(codes):
    """u64 k-mers of (M, k) codes, first base high."""
    k = codes.shape[1]
    sh = (2 * np.arange(k - 1, -1, -1)).astype(np.uint64)
    return (codes.astype(np.uint64) << sh).sum(axis=1, dtype=np.uint64)


def _counts(codes):
    return torch.from_numpy(np.stack([(codes == c).sum(1) for c in range(4)],
                                     axis=1))


def _flipping(call, codes, lengths, n):
    """The first n rows on which ``call``'s plain version emits another
    minimizer under ``swapped_order``."""
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    a = call(c, ln)
    with swapped_order():
        b = call(c, ln)
    diff = ((a.values != b.values) | (a.mask != b.mask)).any(-1).numpy()
    keep = np.flatnonzero(diff)[:n]
    assert keep.size == n, f"{keep.size} rows flip, {n} wanted"
    return codes[keep], lengths[keep]


def kb4_rows(n=6, seed=20261017):
    """n rows (codes, lengths) of ``kb4_call`` that flip: see the module."""
    from bonsai_tpu_torch.core.entropy import WINDOWED_EPS

    rng = np.random.default_rng(seed)
    M = 1 << 14
    a = rng.integers(0, 4, (M, 31))
    a[:, 0] = 3  # T first: the largest k-mers, so the smallest scores
    b = a.copy()
    tail = np.argsort(rng.random((M, 6)), axis=1)
    b[:, 25:] = np.take_along_axis(a[:, 25:], tail, axis=1)
    ka, kb = _pack(a), _pack(b)
    cnt = _counts(a)
    s1a, s2a = _scores(torch.from_numpy(ka.view(np.int64)), cnt, 31,
                       WINDOWED_EPS)
    s1b, s2b = _scores(torch.from_numpy(kb.view(np.int64)), cnt, 31,
                       WINDOWED_EPS)
    pick = np.flatnonzero(_before(s1a, ka, s1b, kb)
                          != _before(s2a, ka, s2b, kb))[: 4 * n]
    rows = []
    for i in pick:
        fill = rng.integers(0, 4, (8, 31))
        fill[:, 0] = 0  # A first: scored above both seeds
        segs = np.concatenate([a[i:i + 1], b[i:i + 1], fill])
        rows.append(np.concatenate([segs, np.full((10, 1), -1)],
                                   axis=1).reshape(-1))
    codes = np.array(rows, dtype=np.int8)
    lengths = np.full(len(rows), codes.shape[1], dtype=np.int32)
    return _flipping(kb4_call, codes, lengths, n)


def kb1_spaced_rows(n=4, seed=20261017):
    """n rows (codes, lengths) of ``kb1_spaced_call`` that flip: see the
    module."""
    from bonsai_tpu_torch.core.entropy import FILE_EPS

    pos = np.array(positions21())
    rng = np.random.default_rng(seed)
    picked = []
    for d in range(5, 16):
        M = 1 << 18
        P = rng.integers(0, 4, (M, d))
        P[:, 0] = 3  # the seed at a multiple of d starts with T
        P[:, 24 % d] = 1  # its last base is C
        a = P[:, pos % d]
        cnt = _counts(a)
        ok = (cnt[:, 1] == cnt[:, 0] + 1) & (cnt[:, 2] > 0)
        ok &= (24 % d != 0)
        a, P, cnt = a[ok.numpy()], P[ok.numpy()], cnt[ok]
        ka = _pack(a)
        kb = ka - np.uint64(1)  # the last base C -> A
        cb = cnt.clone()
        cb[:, 0] += 1
        cb[:, 1] -= 1
        s1a, s2a = _scores(torch.from_numpy(ka.view(np.int64)), cnt, 21,
                           FILE_EPS)
        s1b, s2b = _scores(torch.from_numpy(kb.view(np.int64)), cb, 21,
                           FILE_EPS)
        flip = _before(s1a, ka, s1b, kb) != _before(s2a, ka, s2b, kb)
        picked += [(d, P[i]) for i in np.flatnonzero(flip)]
    rows = []
    for d, block in picked:
        L = 2 * 16 + 24 + 3 * d
        row = np.resize(block, L)
        pa = d * ((16 + d - 1) // d)  # a window of 16 ends at pa + d
        row[pa + d + 24] = 0
        rows.append(row[: pa + d + 25])
    L = max(r.size for r in rows)
    codes = np.full((len(rows), L), -1, dtype=np.int8)
    lengths = np.array([r.size for r in rows], dtype=np.int32)
    for i, r in enumerate(rows):
        codes[i, : r.size] = r
    return _flipping(kb1_spaced_call, codes, lengths, n)


# the other alphabets: (input type, k, tail of the first seed permuted)
RADIX = {"PROTEIN20": (14, 2), "PROTEIN_6": (24, 4)}


def _radix_type(name):
    from bonsai_tpu_torch.core.alphabet import InputType

    return InputType[name]


def _in_code_order(t):
    """float64 sum over the last axis in code order (no accumulators)."""
    res = torch.zeros(t.shape[:-1], dtype=t.dtype)
    for i in range(t.shape[-1]):
        res = res + t[..., i]
    return res


@contextlib.contextmanager
def radix_other_order(name):
    """The port's plain scheme ``entropy`` adding the terms of alphabet
    ``name`` in another order: PROTEIN20's in code order, PROTEIN_6's
    with codes 1 and 2 exchanged (see the module)."""
    from bonsai_tpu_torch.core import entropy

    if name == "PROTEIN20":
        s = entropy.numpy_sum
        entropy.numpy_sum = _in_code_order
        try:
            yield
        finally:
            entropy.numpy_sum = s
        return
    perm = [0, 2, 1, 3, 4, 5]
    w, sp = entropy.window_code_counts, entropy.spaced_code_counts
    entropy.window_code_counts = lambda *a: w(*a)[..., perm]
    entropy.spaced_code_counts = lambda *a: sp(*a)[..., perm]
    try:
        yield
    finally:
        entropy.window_code_counts, entropy.spaced_code_counts = w, sp


def radix_positions(k):
    """The spaced seed of every other code: 0, 2, ..., 2k - 2."""
    return tuple(range(0, 2 * k - 1, 2))


def radix_kb4_call(name):
    """KB4 of alphabet ``name`` at its k, W = 2, under the scheme
    ``entropy``: a call (codes, lengths)."""
    from bonsai_tpu_torch.core import encoder as enc

    k, it = RADIX[name][0], _radix_type(name)
    return lambda c, ln: enc.compacted_minimizers(c, ln, k, 2, "entropy",
                                                  it=it)


def radix_kb1_call(name):
    """KB1 of alphabet ``name`` at its k, spaced ``radix_positions``,
    W = 2, under the scheme ``entropy``: a call (codes, lengths)."""
    from bonsai_tpu_torch.core import encoder as enc

    k, it = RADIX[name][0], _radix_type(name)
    return lambda c, ln: enc.minimizers(c, ln, k, 2, False, "entropy",
                                        radix_positions(k), it=it)


def _flipping_radix(name, call, codes, lengths, n):
    """The first n rows on which ``call``'s plain version emits another
    minimizer under ``radix_other_order``."""
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    a = call(c, ln)
    with radix_other_order(name):
        b = call(c, ln)
    diff = ((a.values != b.values) | (a.mask != b.mask)).any(-1).numpy()
    keep = np.flatnonzero(diff)[:n]
    assert keep.size == n, f"{keep.size} rows flip, {n} wanted"
    return codes[keep], lengths[keep]


def radix_rows(name, kernel, n=4, seed=20261018):
    """n rows (codes, lengths) of ``radix_kb4_call`` (``kernel`` "kb4")
    or ``radix_kb1_call`` ("kb1") of alphabet ``name`` that flip: see the
    module."""
    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.core import entropy
    from bonsai_tpu_torch.core.alphabet import radix_of

    k, tail = RADIX[name]
    it = _radix_type(name)
    R = radix_of(it)
    eps = entropy.WINDOWED_EPS if kernel == "kb4" else entropy.FILE_EPS
    rng = np.random.default_rng(seed)
    M = 1 << 15
    a = rng.integers(0, R, (M, k))
    a[:, 0] = R - 1  # the largest k-mers, past 2^53
    b = a.copy()
    perm = np.argsort(rng.random((M, tail)), axis=1)
    b[:, k - tail:] = np.take_along_axis(a[:, k - tail:], perm, axis=1)
    ka, kb = (enc._pack(torch.from_numpy(x.astype(np.int8)), k, None, it)[0]
              [:, 0] for x in (a, b))
    cnt = torch.from_numpy(np.stack([(a == c).sum(1) for c in range(R)],
                                    axis=1))
    scores = []
    for other in (False, True):
        ctx = radix_other_order(name) if other else contextlib.nullcontext()
        with ctx:
            # the counts as the encoder makes them, so a patched
            # window_code_counts permutes them too
            c = entropy.window_code_counts(
                torch.from_numpy(a.astype(np.int8)), k, R)[:, 0]
            assert torch.equal(c.sort(-1).values, cnt.sort(-1).values)
            h = entropy.entropy_value(c, k)
            scores.append([entropy.entropy_scores(x, h, eps).numpy().view(
                np.uint64) for x in (ka, kb)])
    ua, ub = ka.numpy().view(np.uint64), kb.numpy().view(np.uint64)
    (s1a, s1b), (s2a, s2b) = scores
    pick = np.flatnonzero((ua != ub) & (_before(s1a, ua, s1b, ub)
                                        != _before(s2a, ua, s2b, ub)))
    pick = pick[: 4 * n]
    if kernel == "kb4":
        rows = [np.concatenate([a[i], [-1], b[i]]) for i in pick]
    else:
        rows = [np.stack([a[i], b[i]], axis=1).reshape(-1) for i in pick]
    codes = np.array(rows, dtype=np.int8)
    lengths = np.full(len(rows), codes.shape[1], dtype=np.int32)
    call = (radix_kb4_call if kernel == "kb4" else radix_kb1_call)(name)
    return _flipping_radix(name, call, codes, lengths, n)
