"""Exact set comparison over sorted u64 sets, on a torch device.

Counterpart of ``bonsai_tpu/sketch/compare.py`` (setcmp.h's
intersection_size / jaccard_index / union_size over khash sets, and the
cmpshs tool, bin/cmpshs.cpp): a sorted-array intersection by
``torch.searchsorted`` in unsigned order (bit 63 flipped), on the sets'
device.  A set is a sorted distinct int64-held u64 tensor, or a numpy
uint64 array (taken as a CPU tensor).  The values are the JAX package's:
integer counts, and the same Python float divisions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.bitops import SIGN, as_keys
from ..db.build_device import as_device


def _set(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else as_keys(a, "cpu")


def intersection_size(a, b) -> int:
    """|A n B| for sorted unique u64 sets."""
    a, b = _set(a), _set(b)
    if a.numel() > b.numel():
        a, b = b, a
    if a.numel() == 0:
        return 0
    sb = b.to(a.device) ^ SIGN
    sa = a ^ SIGN
    idx = torch.searchsorted(sb, sa).clamp_(max=sb.numel() - 1)
    return int((sb[idx] == sa).sum())


def union_size(a, b) -> int:
    return int(_set(a).numel() + _set(b).numel() - intersection_size(a, b))


def jaccard_index(a, b) -> float:
    i = intersection_size(a, b)
    u = _set(a).numel() + _set(b).numel() - i
    return i / u if u else 0.0


def containment(a, b) -> float:
    """|A n B| / |A|."""
    n = _set(a).numel()
    return intersection_size(a, b) / n if n else 0.0


def pairwise_matrix(sets: Sequence, metric: str = "jaccard") -> np.ndarray:
    """Dense pairwise comparison (the cmpshs output)."""
    sets = [_set(s) for s in sets]
    n = len(sets)
    out = np.zeros((n, n), dtype=np.float64)
    fn = {
        "jaccard": jaccard_index,
        "intersection": lambda a, b: float(intersection_size(a, b)),
        "union": lambda a, b: float(union_size(a, b)),
        "containment": containment,
    }[metric]
    for i in range(n):
        out[i, i] = fn(sets[i], sets[i])
        for j in range(i + 1, n):
            v = fn(sets[i], sets[j])
            out[i, j] = v
            out[j, i] = (
                v if metric != "containment" else fn(sets[j], sets[i])
            )
    return out


class Counter:
    """Hash multiset with histogram printing (count::Counter<T>,
    counter.h:76+), on ``device``: "cuda" (the default; raises without a
    card) or "cpu"."""

    def __init__(self, device="cuda"):
        self.device = as_device(device)
        self._keys = torch.empty(0, dtype=torch.int64, device=self.device)
        self._counts = torch.empty(0, dtype=torch.int64, device=self.device)

    def add(self, values):
        v = as_keys(values, self.device)
        keys = torch.cat([self._keys, v]) ^ SIGN
        counts = torch.cat([self._counts, torch.ones_like(v)])
        u, inv = torch.unique(keys, sorted=True, return_inverse=True)
        agg = torch.zeros(u.numel(), dtype=torch.int64, device=self.device)
        agg.index_add_(0, inv, counts)
        self._keys, self._counts = u ^ SIGN, agg

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        """(sorted keys uint64, counts int64) on the host."""
        return (self._keys.cpu().numpy().view(np.uint64),
                self._counts.cpu().numpy())

    def histogram(self) -> Tuple[np.ndarray, np.ndarray]:
        """count-of-counts: (multiplicity, #keys with it), ascending."""
        return np.unique(self._counts.cpu().numpy(), return_counts=True)

    def print_hist(self, fh):
        fh.write("#Count\tNumber of occurrences\n")
        for mult, n in zip(*self.histogram()):
            fh.write(f"{mult}\t{n}\n")
