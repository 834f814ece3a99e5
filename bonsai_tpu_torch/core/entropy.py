"""Entropy minimizer scores on torch ``int64`` tensors.

Counterpart of ``bonsai_tpu/core/entropy.py``.  Both schemes divide the
k-mer by (H + eps) in double precision and convert the quotient to u64
with the x86-64 gcc semantics of ``f64_to_u64_x86`` (:34): an
out-of-range quotient gives 0x8000000000000000.  u64 bits are carried in
int64 (see ``core/bitops.py``), so the k-mer is converted to float64 as
unsigned: ``int64 -> float64`` would make a k = 32 k-mer with bit 63 set
negative.

* ``"entropy-file"``, the scheme ``build -e`` runs: H is pinned at
  NOT_FULL = -1 and eps = 1e-4 (``entropy_scores`` :91), so the divisor
  is one constant.
* ``"entropy"``, the windowed Shannon entropy of the Python API: H is
  sum_c p_c ln p_c over the codes of each seed window, p_c = count / k
  (``window_code_counts`` :47 over k contiguous codes,
  ``spaced_code_counts`` :67 over a spaced seed's k included codes,
  ``entropy_value`` :82).  A count takes one of k + 1 values, so
  ``shannon_terms`` makes the k + 1 terms p ln p on the host with numpy,
  as :86-87 make them, and the same bits serve the plain version and the
  kernels.  The terms are added in numpy's order (``numpy_sum``), which
  ``torch.sum`` does not keep.

The CUDA kernels compute both scores inline (``csrc/scores.cuh``), so a
score never makes a round trip through device memory.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitops import SIGN, shr

INT64_MIN_U = 0x8000000000000000
TWO63 = 2.0 ** 63
ENTROPY_NOT_FULL = -1.0  # CircusEnt::NOT_FULL: the tracker is never full
FILE_EPS = 1e-4  # the generic scorer's eps (encoder.h:56-58)
FILE_DENOM = ENTROPY_NOT_FULL + FILE_EPS  # the divisor of every file score
WINDOWED_EPS = 1e-3  # the fused unspaced windowed path's eps (encoder.h:340)
PW_BLOCK = 128  # numpy's pairwise-summation block (PW_BLOCKSIZE)


def u64_to_f64(x: torch.Tensor) -> torch.Tensor:
    """int64-held u64 -> float64, rounded once to nearest even (numpy's
    uint64 -> float64): the high half times 2^32 is exact, so the one
    addition is the only rounding."""
    return shr(x, 32).to(torch.float64) * 2.0 ** 32 + (x & 0xFFFFFFFF).to(
        torch.float64)


def f64_to_u64_x86(x: torch.Tensor) -> torch.Tensor:
    """C-style (uint64_t)double with x86-64 gcc semantics -> int64-held
    u64: values at or above 2^63 subtract 2^63 and set bit 63 again;
    anything else outside [-2^63, 2^63), NaN included, gives
    0x8000000000000000."""
    big = x >= TWO63
    xm = torch.where(big, x - TWO63, x)
    in_range = (xm >= -TWO63) & (xm < TWO63)
    u = torch.trunc(torch.where(in_range, xm, 0.0)).to(torch.int64)
    u = torch.where(in_range, u, SIGN)
    return torch.where(big, u ^ SIGN, u)


def entropy_scores(kmers: torch.Tensor, H, eps: float) -> torch.Tensor:
    """score = u64(kmer / (H + eps)) with x86 conversion semantics; H is
    a float or a float64 tensor shaped as ``kmers``."""
    return f64_to_u64_x86(u64_to_f64(kmers) / (H + eps))


def file_scores(kmers: torch.Tensor) -> torch.Tensor:
    """The ``entropy-file`` score of every k-mer: kmer / (-1 + 1e-4)."""
    return entropy_scores(kmers, ENTROPY_NOT_FULL, FILE_EPS)


def window_code_counts(codes: torch.Tensor, k: int, n_codes: int):
    """Counts of each code over every contiguous window of k characters:
    (..., L) int8 -> (..., L-k+1, n_codes) int32 by cumulative sums.
    Codes widen first: an int8 tensor equals a Python int past 127
    wrapped to int8 (BYTES's codes past 127 are -128..-1, ambiguous)."""
    codes = codes.to(torch.int16)
    P = codes.shape[-1] - k + 1
    outs = []
    for c in range(n_codes):
        cum = (codes == c).to(torch.int32).cumsum(-1, dtype=torch.int32)
        lead = cum[..., k - 1:]
        outs.append(torch.cat([lead[..., :1], lead[..., 1:] - cum[..., :P - 1]],
                              dim=-1))
    return torch.stack(outs, dim=-1)


def spaced_code_counts(codes: torch.Tensor, positions, n_codes: int):
    """Counts of each code over a spaced seed's k included positions
    (the entropy tracker pushes each included character,
    encoder.h:557-575): (..., L) int8 -> (..., L-c+1, n_codes) int32."""
    codes = codes.to(torch.int16)
    P = codes.shape[-1] - int(positions[-1])
    cnt = None
    for pos in positions:
        sl = codes[..., int(pos):int(pos) + P]
        onehot = torch.stack([(sl == c).to(torch.int32)
                              for c in range(n_codes)], dim=-1)
        cnt = onehot if cnt is None else cnt + onehot
    return cnt


def shannon_terms(k: int) -> np.ndarray:
    """The k + 1 terms p ln p of a count c = 0..k, p = c / k, as float64
    made exactly as ``entropy_value`` (:86-87) makes each: p first, then
    p * log(p), and 0.0 for c = 0."""
    p = np.arange(k + 1).astype(np.float64) / float(k)
    c = np.arange(k + 1)
    return np.where(c > 0, p * np.log(np.where(c > 0, p, 1.0)), 0.0)


def numpy_sum(t: torch.Tensor) -> torch.Tensor:
    """float64 sum over the last axis in the order of numpy's pairwise
    summation (``a.sum(axis=-1)`` of a contiguous array): in order below
    8 terms; up to 128 terms, eight strided accumulators combined as
    ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)), then the
    remainder in order; above 128, the two halves (the first cut to a
    multiple of 8) summed alike and added."""
    n = t.shape[-1]
    if n < 8:
        res = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
        for i in range(n):
            res = res + t[..., i]
        return res
    if n <= PW_BLOCK:
        m = n - n % 8
        r = t[..., :8]
        for i in range(8, m, 8):
            r = r + t[..., i:i + 8]
        res = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
               + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
        for i in range(m, n):
            res = res + t[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return numpy_sum(t[..., :n2]) + numpy_sum(t[..., n2:])


_TERMS = {}


def terms_on(k: int, dev) -> torch.Tensor:
    """``shannon_terms(k)`` on ``dev``, made once (a CUDA graph can then
    capture the calls that read them)."""
    key = (k, torch.device(dev))
    if key not in _TERMS:
        _TERMS[key] = torch.from_numpy(shannon_terms(k)).to(key[1])
    return _TERMS[key]


def entropy_value(counts: torch.Tensor, k: int) -> torch.Tensor:
    """H = sum_c p ln p of per-code counts (..., R) -> (...) float64, the
    terms from ``shannon_terms`` added in numpy's order (entropy.h:44-48;
    natural log, non-positive)."""
    terms = terms_on(k, counts.device)
    return 0.0 + numpy_sum(terms[counts.to(torch.int64)])


def shannon_scores(kmers: torch.Tensor, codes: torch.Tensor, k: int,
                   n_codes: int, eps: float, positions=None) -> torch.Tensor:
    """The scheme ``entropy``'s score of each seed: kmers (..., P) of the
    seeds of ``codes`` (..., L), contiguous or at ``positions``."""
    if positions is None:
        counts = window_code_counts(codes, k, n_codes)
    else:
        counts = spaced_code_counts(codes, positions, n_codes)
    return entropy_scores(kmers, entropy_value(counts, k), eps)
