"""Windowed minimizer selection as data-parallel sliding minimums.

Counterpart of ``bonsai_tpu/core/minimize.py`` for the positional
discipline (``_min2`` :35, ``sliding_min`` :41, ``positional_minimizers``
:65): every seed position is pushed, and slot j emits the (score, kmer)
minimum of the window [j, j + W - 1].  Scores and k-mers are u64 bits
held in int64, so every compare is unsigned (bit 63 flipped before the
signed compare).  The compacted discipline (``compact_valid``,
``compacted_minimizers``) belongs to the uncanonical windowed encoder,
which is not ported yet (ROADMAP queue A, item 8).
"""

from __future__ import annotations

import torch

from .bitops import SIGN


def _min2(s1, k1, s2, k2):
    """Unsigned lexicographic min of (s1, k1) and (s2, k2); ties keep
    the first (``s1 < s2 || (s1 == s2 && k1 <= k2)``)."""
    take1 = ((s1 ^ SIGN) < (s2 ^ SIGN)) | ((s1 == s2) & ((k1 ^ SIGN) <= (k2 ^ SIGN)))
    return torch.where(take1, s1, s2), torch.where(take1, k1, k2)


def sliding_min(scores: torch.Tensor, kmers: torch.Tensor, W: int):
    """Minimum of (score, kmer) over each window of W consecutive
    positions: (..., P) -> (..., P - W + 1), by a sparse table of
    log2(W) doubling steps and one overlapping combine."""
    P = scores.shape[-1]
    if W < 1 or P < W:
        raise ValueError(f"window {W} over {P} positions")
    if W == 1:
        return scores, kmers
    p = W.bit_length() - 1
    s, k = scores, kmers
    for j in range(p):
        h = 1 << j
        s, k = _min2(s[..., :-h], k[..., :-h], s[..., h:], k[..., h:])
    off = W - (1 << p)
    if off == 0:
        return s, k
    return _min2(s[..., :-off], k[..., :-off], s[..., off:], k[..., off:])


def positional_minimizers(scores: torch.Tensor, kmers: torch.Tensor, W: int,
                          n_push: torch.Tensor):
    """Every position pushed: (B, P) scores and k-mers, (B,) real seed
    positions per row -> (kmers (B, P - W + 1), valid), slot j valid iff
    j + W <= n_push."""
    _, out_k = sliding_min(scores, kmers, W)
    idx = torch.arange(out_k.shape[-1], device=out_k.device)
    out_valid = idx[None, :] < (n_push[:, None].to(torch.int64) - (W - 1))
    return out_k, out_valid
