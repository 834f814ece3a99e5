"""Peaks of one NVIDIA H100 and the least time a kernel's work could take.

A bound is the larger of the bytes the work must move over the memory
rate and its int32 operations over the int32 peak; a roofline share is
the bound over the time the trace gives the kernel.  The work is counted
from the traffic's own reads and from what a correct answer holds, never
from what the program's kernels happen to move, so the yardstick reads
the same work whatever implements a kernel.  The peaks are those of
``tools/bounds.py`` of the program, frozen here.
"""

from __future__ import annotations

import numpy as np

# HBM3 at 3.35 TB/s (NVIDIA H100 SXM data sheet) and int32 ALU work at
# 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7 TOP/s (Hopper architecture
# white paper); both at 700 W.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SLOT_ROW_BYTES = 32  # one bucket of four 8-byte slots
HASH_OPS = 40  # two splitmix64 hashes of a probe, in int32 operations


def bound_s(nbytes, ops) -> np.ndarray:
    """Per call, the least seconds: bytes over HBM, operations over int32."""
    return np.maximum(np.asarray(nbytes, np.float64) / HBM_BYTES_PER_S,
                      np.asarray(ops, np.float64) / INT32_OPS_PER_S)


def per_batch(values: np.ndarray, batch: int) -> np.ndarray:
    """Sums of ``values`` over consecutive batches of ``batch`` reads."""
    n = values.size
    return np.add.reduceat(values, np.arange(0, n, batch)) if n else values


def k1_bound_s(lengths: np.ndarray, valid: np.ndarray, k: int,
               batch: int) -> float:
    """K1 (encode + probe) over one pass: per batch, 2 bits a base in, one
    32-B slot row and two hashes a valid k-mer, a 4-B taxon out a position
    of the read."""
    pos = np.maximum(lengths - k + 1, 0)
    nbytes = lengths / 4 + SLOT_ROW_BYTES * valid + 4 * pos
    ops = HASH_OPS * valid
    return float(bound_s(per_batch(nbytes, batch),
                         per_batch(ops.astype(np.float64), batch)).sum())


def k2_bound_s(lengths: np.ndarray, distinct: np.ndarray, k: int,
               batch: int) -> float:
    """K2 (resolve) over one pass: per batch, a 4-B taxon in a position of
    the read, 8 B of the taxonomy (its interval) a distinct hit taxon, a
    4-B taxon out a read; d^2 pairs of two compares and an add a read of d
    distinct hit taxa."""
    pos = np.maximum(lengths - k + 1, 0)
    d = distinct.astype(np.float64)
    nbytes = 4 * pos + 8 * d + 4
    ops = 3 * d * d
    return float(bound_s(per_batch(nbytes.astype(np.float64), batch),
                         per_batch(ops, batch)).sum())
