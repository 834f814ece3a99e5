"""The entropy-file minimizer score on torch ``int64`` tensors.

Counterpart of ``bonsai_tpu/core/entropy.py`` for the scheme
``"entropy-file"``, the one ``build -e`` runs: every seed scores
u64(kmer / (NOT_FULL + 1e-4)) with NOT_FULL = -1 (``entropy_scores`` :91
with H = -1), and the double is converted to u64 with the x86-64 gcc
semantics of ``f64_to_u64_x86`` (:34): an out-of-range quotient gives
0x8000000000000000.  u64 bits are carried in int64 (see
``core/bitops.py``), so the k-mer is converted to float64 as unsigned:
``int64 -> float64`` would make a k = 32 k-mer with bit 63 set negative.

The windowed Shannon entropy of the scheme ``"entropy"``
(``window_code_counts``, ``spaced_code_counts``, ``entropy_value``) is
not ported (ROADMAP queue A, item 8.3b).  The CUDA kernels compute this
score inline (``csrc/scores.cuh``), so it never makes a round trip
through device memory.
"""

from __future__ import annotations

import torch

from .bitops import SIGN, shr

INT64_MIN_U = 0x8000000000000000
TWO63 = 2.0 ** 63
ENTROPY_NOT_FULL = -1.0  # CircusEnt::NOT_FULL: the tracker is never full
FILE_EPS = 1e-4  # the generic scorer's eps (encoder.h:56-58)
FILE_DENOM = ENTROPY_NOT_FULL + FILE_EPS  # the divisor of every file score


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


def entropy_scores(kmers: torch.Tensor, H: float, eps: float) -> torch.Tensor:
    """score = u64(kmer / (H + eps)) with x86 conversion semantics, for a
    scalar H (the file scheme's NOT_FULL)."""
    return f64_to_u64_x86(u64_to_f64(kmers) / (H + eps))


def file_scores(kmers: torch.Tensor) -> torch.Tensor:
    """The ``entropy-file`` score of every k-mer: kmer / (-1 + 1e-4)."""
    return entropy_scores(kmers, ENTROPY_NOT_FULL, FILE_EPS)
