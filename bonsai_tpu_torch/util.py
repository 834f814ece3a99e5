"""Bit-parallel k-mer composition on torch tensors, and host helpers.

Counterpart of ``bonsai_tpu/util.py`` ``nuccount``, ``gccount`` and
``kmer_entropy`` (:31,49,55; the reference's util.h:398-486,1201-1239):
the counts come from ``core/bitops.py`` ``nuccount`` (the CUDA kernel KS4
on a CUDA tensor, its plain torch version on a CPU one), (..., 4) int64 in
code order A, C, G, T.  ``kmer_entropy`` evaluates the JAX package's
numpy expression on the host over those counts, so its doubles are
numpy's bit for bit, and returns them on the k-mers' device.  The host
helpers ``bitvec2str``, ``Timer``, ``time_code`` and ``get_logger``
(:67-143 there) are copies; ``time_code`` marks its block in an active
``torch.profiler`` trace where the JAX package marks a ``jax.profiler``
one.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time
from typing import Iterator, Optional

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


def bitvec2str(row) -> str:
    """util.h:1190-1196: MSB-first bit string of a packed-u64 vector."""
    return "".join(
        format(int(w), "064b") for w in np.asarray(row, dtype=np.uint64)
    )


# -- timing -----------------------------------------------------------------
class Timer:
    """RAII timer (util.h:96-102): prints ns to stderr on stop/exit."""

    def __init__(self, msg: Optional[str] = None, fh=None):
        self.msg = msg
        self.fh = fh if fh is not None else sys.stderr
        self.start = time.perf_counter_ns()
        self.elapsed_ns = None

    def restart(self, msg: Optional[str] = None):
        if msg is not None:
            self.msg = msg
        self.start = time.perf_counter_ns()

    def stop(self):
        self.elapsed_ns = time.perf_counter_ns() - self.start
        return self.elapsed_ns

    def report(self):
        if self.elapsed_ns is None:
            self.stop()
        label = self.msg or "Timer"
        print(f"[{label}] {self.elapsed_ns} ns", file=self.fh)

    def __enter__(self):
        self.restart()
        return self

    def __exit__(self, *exc):
        self.stop()
        self.report()
        return False


@contextlib.contextmanager
def time_code(msg: str, fh=None) -> Iterator[Timer]:
    """TIME_CODE macro (util.h:142-153) as a context manager; the block
    is also a ``record_function`` range of an active torch.profiler
    trace."""
    with torch.profiler.record_function(msg):
        with Timer(msg, fh) as t:
            yield t


# -- logging ----------------------------------------------------------------
_LOGGER = None


def get_logger() -> logging.Logger:
    """logutil.h-style logger: level, func:line prefix, stderr."""
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("bonsai_tpu_torch")
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(
                logging.Formatter(
                    "[%(levelname)s] [%(funcName)s:%(lineno)d] %(message)s"
                )
            )
            logger.addHandler(h)
            logger.setLevel(logging.INFO)
        _LOGGER = logger
    return _LOGGER
