"""Bit-parallel k-mer composition on torch tensors.

Counterpart of ``bonsai_tpu/util.py`` ``nuccount``, ``gccount`` and
``kmer_entropy`` (:31,49,55; the reference's util.h:398-486,1201-1239):
the counts come from ``core/bitops.py`` ``nuccount`` (the CUDA kernel KS4
on a CUDA tensor, its plain torch version on a CPU one), (..., 4) int64 in
code order A, C, G, T.  ``kmer_entropy`` evaluates the JAX package's
numpy expression on the host over those counts, so its doubles are
numpy's bit for bit, and returns them on the k-mers' device.  The Timer
and logging helpers of that module are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import bitops


def nuccount(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """Per-base counts of packed 2-bit k-mers: (..., 4) int64, code order
    A, C, G, T (util.h:398-443)."""
    return bitops.nuccount(kmer, k)


def gccount(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """G+C count of packed k-mers (util.h:1217-1239)."""
    nc = nuccount(kmer, k)
    return nc[..., 1] + nc[..., 2]


def kmer_entropy(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """Shannon entropy of each k-mer's base composition, -sum p log2 p with
    0 log 0 = 0, as the JAX package returns it (the reference's util.h
    returns the signed sum and nan for an absent base)."""
    counts = nuccount(kmer, k).cpu().numpy()
    p = counts / float(k)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(p > 0, p * np.log2(np.where(p > 0, p, 1.0)), 0.0)
    return torch.from_numpy(-t.sum(-1)).to(kmer.device)
