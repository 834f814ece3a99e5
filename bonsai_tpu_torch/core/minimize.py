"""Windowed minimizer selection as data-parallel sliding minimums.

Counterpart of ``bonsai_tpu/core/minimize.py`` (``_min2`` :35,
``sliding_min`` :41, ``positional_minimizers`` :65, ``compact_valid``
:84, ``compacted_minimizers`` :109).  Two disciplines:

* positional (canonical and spaced seeds): every seed position is
  pushed, and slot j emits the (score, kmer) minimum of the window
  [j, j + W - 1];
* compacted (uncanonical contiguous seeds): only valid seeds are pushed,
  the window slides over the subsequence of valid seeds, and a final
  partial window emits its best element once.

Scores and k-mers are u64 bits held in int64, so every compare is
unsigned (bit 63 flipped before the signed compare); the compaction's
U64_MAX sentinel, int64 -1, therefore orders last.
"""

from __future__ import annotations

import torch

from .bitops import SIGN

SENTINEL = -1  # U64_MAX as int64: the compaction's score and k-mer pad


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


def compact_valid(scores: torch.Tensor, kmers: torch.Tensor,
                  valid: torch.Tensor):
    """Stable-compact each row's valid entries to its front; the tail
    holds the sentinel (score = kmer = U64_MAX)."""
    B, P = scores.shape
    dest = valid.to(torch.int64).cumsum(-1) - 1
    dest = torch.where(valid, dest, P)  # dropped into a spare column
    out = []
    for x in (scores, kmers):
        c = torch.full((B, P + 1), SENTINEL, dtype=torch.int64,
                       device=x.device)
        c.scatter_(1, dest, torch.where(valid, x, SENTINEL))
        out.append(c[:, :P])
    return tuple(out)


def row_min(scores: torch.Tensor, kmers: torch.Tensor):
    """The unsigned (score, kmer) minimum of each row: (B, P) -> (B,)."""
    s = (scores ^ SIGN).min(dim=-1).values ^ SIGN
    k = torch.where(scores == s[:, None], kmers ^ SIGN, SENTINEL ^ SIGN)
    return s, k.min(dim=-1).values ^ SIGN


def compacted_minimizers(scores: torch.Tensor, kmers: torch.Tensor,
                         valid: torch.Tensor, W: int):
    """Only valid seeds pushed: (B, P) scores, k-mers and flags ->
    (out_kmers (B, P - W + 1), out_valid, tail_kmer (B,), tail_valid):
    slot j is the minimum of compacted seeds [j, j + W - 1], valid iff
    j + W <= n_valid; the tail is the minimum of every pushed seed (the
    sentinel when none is), valid iff 0 < n_valid < W."""
    n_valid = valid.sum(dim=-1)
    cs, ck = compact_valid(scores, kmers, valid)
    P = cs.shape[-1]
    if P >= W:
        _, out_k = sliding_min(cs, ck, W)
        idx = torch.arange(out_k.shape[-1], device=out_k.device)
        out_valid = idx[None, :] < (n_valid[:, None] - (W - 1))
    else:
        out_k = torch.zeros((cs.shape[0], 0), dtype=torch.int64,
                            device=cs.device)
        out_valid = torch.zeros((cs.shape[0], 0), dtype=torch.bool,
                                device=cs.device)
    _, tail_k = row_min(cs, ck)
    return out_k, out_valid, tail_k, (n_valid > 0) & (n_valid < W)
