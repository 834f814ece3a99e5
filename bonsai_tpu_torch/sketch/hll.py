"""HyperLogLog with the Ertl improved raw estimator, registers on a torch
device.

Counterpart of ``bonsai_tpu/sketch/hll.py`` (the dnbaker/sketch hll_t of
the reference: p-bit register index, max-of-rho registers, merge by
register max, inclusion-exclusion Jaccard).  The registers live on the
sketch's device as 2^p int32 (``hll_fill``, the CUDA kernel KS1
``csrc/hll.cu``, raises them with 32-bit atomics) and become the JAX
package's uint8 registers when fetched (``registers``).  ``counts``,
``report`` and the Ertl helpers run on the host with the JAX package's
Python float code, copied, so an estimate is that package's bit for bit
wherever the registers are equal.

``merge`` raises this sketch's registers in place and returns it, as the
JAX package's does; ``union_estimate`` leaves both sketches as they are.
"""

from __future__ import annotations

import math
from typing import Iterable

import numpy as np
import torch

from .. import kernels
from ..core.bitops import as_keys, shr
from ..core.hashes import wang_hash_plain
from ..db.build_device import as_device

MAX_SHARED_P = 15  # KS1 keeps a u32 copy a block in shared memory up to here
GLOBAL_BELOW = 32  # from GLOBAL_BELOW x 2^p keys (csrc/hll.cu kGlobalBelow)


def _bitlen(w: torch.Tensor) -> torch.Tensor:
    """Position of the highest set bit of int64-held u64 values (0 for
    0)."""
    r = torch.zeros_like(w)
    v = w
    for s in (32, 16, 8, 4, 2, 1):
        big = shr(v, s) != 0
        r = r + torch.where(big, s, 0)
        v = torch.where(big, shr(v, s), v)
    return r + (w != 0).to(torch.int64)


def hll_fill_plain(keys: torch.Tensor, regs: torch.Tensor, p: int,
                   wang: bool) -> None:
    """Plain torch KS1: raise the (2^p,) int32 registers ``regs`` to each
    key's rho (``add_hashes``, hll.py:37-59), the keys hashed with
    wang_hash first under ``wang``."""
    h = wang_hash_plain(keys) if wang else keys
    q = 64 - p
    idx = shr(h, q)
    w = h << p
    rho = torch.where(w == 0, q + 1, 65 - _bitlen(w)).to(torch.int32)
    regs.scatter_reduce_(0, idx, rho, reduce="amax")


def hll_fill(keys: torch.Tensor, regs: torch.Tensor, p: int,
             wang: bool) -> None:
    """KS1 (``csrc/hll.cu``): see ``hll_fill_plain``, which serves CPU
    tensors.  For p <= MAX_SHARED_P and at least GLOBAL_BELOW x 2^p keys,
    each block raises a u32 copy of the registers in shared memory and
    flushes it; otherwise atomics on the card's registers.  ``keys`` may
    start at any 8-B offset (a slice)."""
    if keys.device.type == "cpu":
        return hll_fill_plain(keys, regs, p, wang)
    if keys.device.type != "cuda":
        raise ValueError(f"hll_fill: no kernel for device {keys.device}")
    if not 4 <= p <= 30:
        raise ValueError("p out of range")
    dev = keys.device
    kernels.check(keys, "keys", torch.int64, dev, (keys.numel(),))
    kernels.check(regs, "regs", torch.int32, dev, (1 << p,))
    if regs.data_ptr() % 16:
        raise ValueError("regs: the kernel flushes 16-B words, so it takes "
                         "16-B aligned registers")
    if keys.numel():
        kernels.launch("bk_hll_fill", dev, keys.data_ptr(), keys.numel(), p,
                       int(wang), regs.data_ptr())
        hll_fill.launches += 1


hll_fill.launches = 0


class HyperLogLog:
    def __init__(self, p: int = 14, device="cuda"):
        if not 4 <= p <= 30:
            raise ValueError("p out of range")
        self.p = p
        self.m = 1 << p
        self.q = 64 - p
        self.device = as_device(device)
        self.regs = torch.zeros(self.m, dtype=torch.int32, device=self.device)

    @property
    def registers(self) -> np.ndarray:
        """The registers as the JAX package's (2^p,) uint8, fetched."""
        return self.regs.cpu().numpy().astype(np.uint8)

    # -- filling -----------------------------------------------------------
    def add_hashes(self, h):
        """Add pre-hashed u64 values."""
        hll_fill(as_keys(h, self.device), self.regs, self.p, False)

    def addh(self, values):
        """Hash with wang_hash (the reference sketch's default), then add;
        one pass on the card."""
        hll_fill(as_keys(values, self.device), self.regs, self.p, True)

    # -- merging ------------------------------------------------------------
    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        if other.p != self.p:
            raise ValueError("incompatible precisions")
        self.regs = torch.maximum(self.regs, other.regs.to(self.device))
        return self

    __iadd__ = merge

    def clone(self) -> "HyperLogLog":
        h = HyperLogLog(self.p, self.device)
        h.regs = self.regs.clone()
        return h

    # -- estimation -----------------------------------------------------
    def counts(self) -> np.ndarray:
        return np.bincount(self.registers, minlength=self.q + 2)

    def report(self) -> float:
        return _ertl_estimate(self.counts(), self.m, self.q)

    def est_err(self) -> float:
        """Approximate relative standard error * cardinality."""
        return 1.03896 / math.sqrt(self.m) * max(self.report(), 1.0)

    def union_estimate(self, other: "HyperLogLog") -> float:
        return self.clone().merge(other).report()

    def jaccard(self, other: "HyperLogLog") -> float:
        a = self.report()
        b = other.report()
        u = self.union_estimate(other)
        if u <= 0:
            return 0.0
        inter = max(a + b - u, 0.0)
        return inter / u


def _ertl_sigma(x: float) -> float:
    """Ertl 2017 algorithm 6 helper: sigma(x) = x + sum 2^(k-1) x^(2^k)."""
    if x == 1.0:
        return math.inf
    y = 1.0
    z = x
    while True:
        x = x * x
        z_prev = z
        z += x * y
        y += y
        if z == z_prev:
            return z


def _ertl_tau(x: float) -> float:
    """Ertl 2017 algorithm 6 helper."""
    if x == 0.0 or x == 1.0:
        return 0.0
    y = 1.0
    z = 1.0 - x
    while True:
        x = math.sqrt(x)
        z_prev = z
        y *= 0.5
        z -= (1.0 - x) ** 2 * y
        if z == z_prev:
            return z / 3.0


def _ertl_estimate(C: np.ndarray, m: int, q: int) -> float:
    """Ertl 2017, algorithm 6: the improved raw estimator."""
    z = m * _ertl_tau(1.0 - float(C[q + 1]) / m)
    for k in range(q, 0, -1):
        z = 0.5 * (z + float(C[k]))
    z = z + m * _ertl_sigma(float(C[0]) / m)
    if not math.isfinite(z) or z <= 0:
        return 0.0
    alpha_inf = 1.0 / (2.0 * math.log(2.0))
    return alpha_inf * m * m / z


def estimate_cardinality(kmer_arrays: Iterable, p: int = 14,
                         device="cuda") -> float:
    """Union cardinality of k-mer streams (estimate_cardinality,
    bin/bonsai.cpp:100-105)."""
    h = HyperLogLog(p, device)
    for arr in kmer_arrays:
        h.addh(arr)
    return h.report()


def count_cardinality(paths, sp=None, canonicalize: bool = True,
                      k: int = 31) -> int:
    """EXACT distinct k-mer count across files (count_cardinality,
    encoder.h:1052-1094): per-file sorted sets (the host build's) ->
    merged unique."""
    from ..core.spacer import Spacer
    from ..db.build import genome_kmer_set
    from ..db.table import unique_u64

    if sp is None:
        sp = Spacer(k, k)
    sets = [genome_kmer_set(p, sp, canonicalize) for p in paths]
    if not sets:
        return 0
    return int(unique_u64(np.concatenate(sets)).size)
