"""Continuous SetSketch (CSetSketch), registers on a torch device, and the
b-bit packed SetSketch.

Counterpart of ``bonsai_tpu/sketch/setsketch.py`` (sketch::setsketch::
CSetSketch<double> of bin/setsketcher.cpp, after Ertl 2021).  Per element
x, a rate-m Poisson arrival process keyed on h = mix(x) lands each arrival
on a register; a register keeps its smallest arrival time, and
(m - 1) / sum(registers) estimates the cardinality.  ``update`` runs
``csetsketch_update``: the CUDA kernel KS2 (``csrc/setsketch.cu``) on a
CUDA sketch, its plain torch version (the JAX package's loop, in torch)
on a CPU one.  Both take the values in chunks of 2^16 elements and each
element's arrivals in rounds of 16, the times t + cumsum(gaps), as that
package does, so ids (-S), idcounts (-s) and n_updates are its own (of
tied arrivals at a register, the smallest element's, as its lexsort
keeps); a register may differ from numpy's in its last bits where the
card's ``log`` does.

The estimators, ``max``, ``min``, ``jaccard``, the packing and the
``BTPUCSS1`` files run on the host over the fetched registers, with the
JAX package's numpy code.
"""

from __future__ import annotations

import gzip
import math
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..core.bitops import as_keys, i64, shr
from ..db.build_device import as_device

MAGIC = b"BTPUCSS1"
PACKED_MAGIC = b"BTPUPSS1"
CHUNK = 1 << 16  # elements a chunk (CSetSketch.update's default)
STEPS = 16  # arrivals a round

_MIX1 = i64(0x9E3779B97F4A7C15)
_MIX2 = i64(0xBF58476D1CE4E5B9)
_MIX3 = i64(0x94D049BB133111EB)


def _mix(z: torch.Tensor) -> torch.Tensor:
    z = (z ^ shr(z, 30)) * _MIX2
    z = (z ^ shr(z, 27)) * _MIX3
    return z ^ shr(z, 31)


def _umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """Unsigned x % m of int64-held u64 values, 0 < m < 2^62."""
    return (((shr(x, 1) % m) * 2) + (x & 1)) % m


def _arrivals(h: torch.Tensor, ctr0: torch.Tensor, m: int):
    """The next STEPS (gap, register) pairs of each element's rate-m
    Poisson process (_arrivals, setsketch.py:52-61)."""
    c = ctr0[:, None] + torch.arange(STEPS, dtype=torch.int64,
                                     device=h.device)[None, :]
    z = _mix(h[:, None] + _MIX1 * (c + 1))
    u = (shr(z, 11).to(torch.float64) + 1.0) * (2.0 ** -53)
    gaps = -torch.log(u) / m
    return gaps, _umod(_mix(z + _MIX3), m)


def _update_chunk_plain(v, regs, ids, idcounts, m):
    """One chunk (_update_chunk, setsketch.py:86-121), in torch."""
    h = _mix(v)
    n = v.numel()
    t = torch.zeros(n, dtype=torch.float64, device=v.device)
    ctr = torch.zeros(n, dtype=torch.int64, device=v.device)
    alive = torch.arange(n, device=v.device)
    while alive.numel():
        live = alive.numel()
        csetsketch_update_plain.arrivals += STEPS * live
        thresh = regs.max()
        gaps, idx = _arrivals(h[alive], ctr[alive], m)
        times = t[alive, None] + torch.cumsum(gaps, dim=1)
        ok = times < thresh
        fi, ft = idx[ok], times[ok]
        if fi.numel():
            if ids is not None:
                # each register's smallest arrival of the round, and of the
                # elements that reach it the first (lexsort's tie rule)
                rmin = torch.full((m,), math.inf, dtype=torch.float64,
                                  device=v.device)
                rmin.scatter_reduce_(0, fi, ft, reduce="amin")
                fel = alive[:, None].expand_as(idx)[ok]
                arg = ft == rmin[fi]
                rarg = torch.full((m,), n, dtype=torch.int64, device=v.device)
                rarg.scatter_reduce_(0, fi[arg], fel[arg], reduce="amin")
                ri = torch.nonzero(torch.isfinite(rmin)).reshape(-1)
                rt, re = rmin[ri], v[rarg[ri]]
                better = rt < regs[ri]
                if idcounts is not None:
                    same = ~better & (rt == regs[ri]) & (re == ids[ri])
                    idcounts[ri[same]] += 1
                    idcounts[ri[better]] = 1
                ids[ri[better]] = re[better]
                regs[ri[better]] = rt[better]
            else:
                regs.scatter_reduce_(0, fi, ft, reduce="amin")
        t[alive] = times[:, -1]
        ctr[alive] += STEPS
        alive = alive[times[:, -1] < thresh]
        # below the threshold, and one for each element this round ends
        csetsketch_update_plain.required += fi.numel() + live - alive.numel()


def csetsketch_update_plain(values: torch.Tensor, regs: torch.Tensor,
                            ids: Optional[torch.Tensor],
                            idcounts: Optional[torch.Tensor],
                            chunk: int = CHUNK) -> None:
    """Plain torch KS2: ``values`` (n,) int64-held u64 into the (m,)
    float64 registers ``regs`` and, where the sketch keeps them, the ids
    (m,) int64 and idcounts (m,) int32, chunk by chunk."""
    m = regs.numel()
    for lo in range(0, values.numel(), chunk):
        _update_chunk_plain(values[lo: lo + chunk], regs, ids, idcounts, m)


# The arrivals the plain version evaluates (16 a live element a round, the
# JAX package's schedule), and those any exact schedule must evaluate: the
# arrivals below their round's threshold, and for each element the one
# that ends it (its first at or past the threshold, by the monotone times).
# KS2's bound counts the required ones.
csetsketch_update_plain.arrivals = 0
csetsketch_update_plain.required = 0


def csetsketch_update(values: torch.Tensor, regs: torch.Tensor,
                      ids: Optional[torch.Tensor],
                      idcounts: Optional[torch.Tensor],
                      chunk: int = CHUNK) -> None:
    """KS2 (``csrc/setsketch.cu``): see ``csetsketch_update_plain``, which
    serves CPU tensors.  A memset and one cooperative launch a call, which
    never waits for the host."""
    if values.device.type == "cpu":
        return csetsketch_update_plain(values, regs, ids, idcounts, chunk)
    if values.device.type != "cuda":
        raise ValueError(f"csetsketch_update: no kernel for device "
                         f"{values.device}")
    dev = values.device
    m = regs.numel()
    n = values.numel()
    if not 0 < m < 1 << 62:
        raise ValueError(f"csetsketch_update: {m} registers")
    if not 0 < chunk < 1 << 32:
        raise ValueError(f"csetsketch_update: chunks of {chunk} elements")
    if idcounts is not None and ids is None:
        raise ValueError("idcounts are kept only with ids")
    kernels.check(values, "values", torch.int64, dev, (n,))
    kernels.check(regs, "regs", torch.float64, dev, (m,))
    if ids is not None:
        kernels.check(ids, "ids", torch.int64, dev, (m,))
    if idcounts is not None:
        kernels.check(idcounts, "idcounts", torch.int32, dev, (m,))
    if not n:
        return
    scratch = kernels.scratch("bk_csetsketch_update", (n, chunk, m), dev)
    kernels.launch("bk_csetsketch_update", dev, values.data_ptr(), n, chunk,
                   m, regs.data_ptr(), kernels.ptr(ids), kernels.ptr(idcounts),
                   scratch.data_ptr())
    csetsketch_update.launches += 1


csetsketch_update.launches = 0


class CSetSketch:
    def __init__(self, m: int = 4096, save_kmers: bool = False,
                 save_kmer_counts: bool = False,
                 startmax: float = math.inf, device="cuda"):
        self.m = int(m)
        self.device = as_device(device)
        self.regs = torch.full((self.m,), startmax, dtype=torch.float64,
                               device=self.device)
        self.save_kmers = bool(save_kmers or save_kmer_counts)
        self.save_kmer_counts = bool(save_kmer_counts)
        self._ids = (torch.zeros(self.m, dtype=torch.int64, device=self.device)
                     if self.save_kmers else None)
        self._idcounts = (torch.zeros(self.m, dtype=torch.int32,
                                      device=self.device)
                          if self.save_kmer_counts else None)
        self.n_updates = 0

    @property
    def registers(self) -> np.ndarray:
        """The (m,) float64 registers, fetched."""
        return self.regs.cpu().numpy()

    # -- filling ----------------------------------------------------------
    def update(self, values, chunk: int = CHUNK):
        """Batched update with raw u64 values (already-hashed k-mers)."""
        v = as_keys(values, self.device)
        self.n_updates += int(v.numel())
        csetsketch_update(v, self.regs, self._ids, self._idcounts, chunk)

    # -- API parity with the reference call sites --------------------------
    def total_updates(self) -> int:
        return self.n_updates

    def clear(self):
        self.regs.fill_(math.inf)
        self.n_updates = 0
        if self._ids is not None:
            self._ids.zero_()
        if self._idcounts is not None:
            self._idcounts.zero_()

    def cardinality(self) -> float:
        regs = self.registers
        s = float(np.sum(regs[np.isfinite(regs)]))
        nfin = int(np.isfinite(regs).sum())
        if s <= 0 or nfin == 0:
            return 0.0
        if nfin < self.m:  # not all registers touched: tiny set
            return float(nfin)
        return (self.m - 1) / s

    def merge(self, other: "CSetSketch") -> "CSetSketch":
        if other.m != self.m:
            raise ValueError("incompatible sketch sizes")
        oregs = other.regs.to(self.device)
        if self.save_kmers:
            take = oregs < self.regs
            self._ids[take] = other._ids.to(self.device)[take]
            if self.save_kmer_counts and other._idcounts is not None:
                self._idcounts[take] = other._idcounts.to(self.device)[take]
        torch.minimum(self.regs, oregs, out=self.regs)
        self.n_updates += other.n_updates
        return self

    __iadd__ = merge

    def max(self) -> float:
        regs = self.registers
        fin = regs[np.isfinite(regs)]
        return float(fin.max()) if fin.size else 0.0

    def min(self) -> float:
        regs = self.registers
        fin = regs[np.isfinite(regs)]
        return float(fin.min()) if fin.size else 0.0

    def ids(self) -> np.ndarray:
        if self._ids is None:
            raise ValueError("sketch built without save_kmers")
        return self._ids.cpu().numpy().view(np.uint64)

    def idcounts(self) -> np.ndarray:
        if self._idcounts is None:
            raise ValueError("sketch built without save_kmer_counts")
        return self._idcounts.cpu().numpy().view(np.uint32)

    # -- similarity ---------------------------------------------------------
    def jaccard(self, other: "CSetSketch") -> float:
        """P(register equal) = |A n B| / |A u B| for min-of-Exp registers."""
        a, b = self.registers, other.registers
        both = np.isfinite(a) & np.isfinite(b)
        if not both.any():
            return 0.0
        eq = both & (a == b)
        return float(eq.sum()) / float(self.m)

    # -- packing ------------------------------------------------------------
    def optimal_parameters(self, maxv: Optional[float] = None,
                           minv: Optional[float] = None,
                           qmax: int = 65535) -> Tuple[float, float]:
        """(b, a) such that K = clamp(1 + floor(log_b(1/(a*r))), 0, qmax)
        spans the register range (setsketcher.cpp:247-256)."""
        maxv = self.max() if maxv is None else maxv
        minv = self.min() if minv is None else minv
        if not (maxv > 0 and minv > 0) or maxv == minv:
            return (1.001, 1.0 / max(maxv, 1e-300))
        b = (maxv / minv) ** (1.0 / max(qmax - 1, 1))
        a = 1.0 / maxv
        return (b, a)

    def to_packed(self, b: float, a: float, bits: int = 16) -> "SetSketch":
        q = (1 << bits) - 1
        r = np.clip(self.registers, 1e-300, None)
        with np.errstate(over="ignore"):
            k = 1 + np.floor(-np.log(a * r) / math.log(b))
        k = np.clip(np.nan_to_num(k, posinf=q, neginf=0), 0, q)
        return SetSketch(k.astype(np.uint32), b=b, a=a, bits=bits)

    # -- serialization -------------------------------------------------------
    def write(self, path: str):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "wb") as fh:
            fh.write(MAGIC)
            fh.write(struct.pack("<QQ", self.m, self.n_updates))
            flags = (1 if self.save_kmers else 0) | (
                2 if self.save_kmer_counts else 0
            )
            fh.write(struct.pack("<Q", flags))
            fh.write(self.registers.tobytes())
            if self.save_kmers:
                fh.write(self.ids().tobytes())
            if self.save_kmer_counts:
                fh.write(self.idcounts().tobytes())

    @classmethod
    def read(cls, path: str, device="cuda") -> "CSetSketch":
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as fh:
            magic = fh.read(8)
            if magic != MAGIC:
                raise ValueError(f"{path}: not a CSetSketch file")
            m, nup = struct.unpack("<QQ", fh.read(16))
            (flags,) = struct.unpack("<Q", fh.read(8))
            s = cls(m, save_kmers=bool(flags & 1),
                    save_kmer_counts=bool(flags & 2), device=device)

            def up(nbytes, dt, tdt):
                a = np.frombuffer(fh.read(nbytes), dtype=dt).copy()
                return torch.from_numpy(a.view(tdt)).to(s.device)

            s.regs = up(8 * m, np.float64, np.float64)
            s.n_updates = nup
            if flags & 1:
                s._ids = up(8 * m, np.uint64, np.int64)
            if flags & 2:
                s._idcounts = up(4 * m, np.uint32, np.int32)
            return s


class SetSketch:
    """b-bit packed SetSketch (integer registers + (a, b) parameters), the
    css2ss / shs2sketch target format; host code."""

    def __init__(self, registers: np.ndarray, b: float, a: float, bits: int):
        self.registers = np.asarray(registers, dtype=np.uint32)
        self.m = int(self.registers.size)
        self.b = float(b)
        self.a = float(a)
        self.bits = int(bits)

    def jaccard(self, other: "SetSketch") -> float:
        if other.m != self.m:
            raise ValueError("incompatible sketch sizes")
        return float((self.registers == other.registers).sum()) / self.m

    def cardinality(self) -> float:
        k = self.registers.astype(np.float64)
        r = np.power(self.b, 1.0 - k) / self.a
        s = float(r.sum())
        return (self.m - 1) / s if s > 0 else 0.0

    def write(self, path: str):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "wb") as fh:
            fh.write(PACKED_MAGIC)
            fh.write(struct.pack("<QddQ", self.m, self.b, self.a, self.bits))
            if self.bits <= 8:
                fh.write(self.registers.astype(np.uint8).tobytes())
            elif self.bits <= 16:
                fh.write(self.registers.astype(np.uint16).tobytes())
            else:
                fh.write(self.registers.tobytes())

    @classmethod
    def read(cls, path: str) -> "SetSketch":
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as fh:
            if fh.read(8) != PACKED_MAGIC:
                raise ValueError(f"{path}: not a packed SetSketch file")
            m, b, a, bits = struct.unpack("<QddQ", fh.read(32))
            dt = np.uint8 if bits <= 8 else np.uint16 if bits <= 16 else np.uint32
            regs = np.frombuffer(fh.read(m * dt().itemsize), dtype=dt)
            return cls(regs.astype(np.uint32), b=b, a=a, bits=int(bits))
