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
one.  ``span`` is the port's own: the one helper that marks the
classifier's and the build's phases (``SPANS``) in such a trace.
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


# -- spans --------------------------------------------------------------------
# Every span the program opens (``span``).  Classify
# (``Classifier.process_dataset``): ``pass``, the whole call, in the main
# thread; ``read`` and ``parse`` in the producer, ``dispatch`` in the main
# thread, ``materialize`` (``device_wait`` and ``full_fetch`` inside it)
# and ``format`` in the writer.  ``name_join``, inside ``format``, joins a
# batch's names into the formatter's arena where they came as a list and
# not as the C++ parser's ``io.fastx.Strings``: its count is the batches
# that missed the arena (paired input, whose mates are interleaved
# lists).  ``STAGES`` are ``stage_seconds``' keys;
# ``WAITS`` are the blocking queue calls and the writer's wait on the
# card.  Build: ``db/build_device.py``'s genome stream, fold and fetch,
# ``db/table.py``'s placement and slot image, ``db/formats.py``'s payload.
STAGES = ("parse", "dispatch", "materialize", "format")
WAITS = ("producer_blocked", "dispatch_starved", "dispatch_blocked",
         "writer_starved", "device_wait")
BUILD_SPANS = ("genome_read", "fold", "fold_fetch", "placement", "image",
               "payload")
CLASSIFY_SPANS = (("pass", "read") + STAGES + ("full_fetch", "name_join")
                  + WAITS)
SPANS = CLASSIFY_SPANS + BUILD_SPANS


# the user-scope range that ``torch.profiler.record_function`` opens, entered
# without its round trip through the operator dispatcher: a third of its
# cost a span, and less of a thread's time left between two spans
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit


class span:
    """``with span(name, acc):`` a range named ``name`` (one of ``SPANS``)
    in an active ``torch.profiler`` trace: the ``user_annotation`` event
    that ``record_function`` makes, on the profiler's clock beside the
    card's kernels and copies.  With ``acc``, the block's wall seconds
    (``perf_counter``), its thread's CPU seconds (``thread_time``) and one
    count are added to ``acc[name]``, a list [wall_s, cpu_s, count]: CPU
    below wall is time the thread spent off the CPU, waiting on the GIL, a
    lock, the card or I/O."""

    __slots__ = ("name", "acc", "_range", "_wall", "_cpu")

    def __init__(self, name: str, acc: Optional[dict] = None):
        self.name = name
        self.acc = acc

    def __enter__(self) -> "span":
        self._range = _range_enter(self.name)
        if self.acc is not None:
            self._wall, self._cpu = time.perf_counter(), time.thread_time()
        return self

    def __exit__(self, *exc) -> bool:
        if self.acc is not None:
            row = self.acc.setdefault(self.name, [0.0, 0.0, 0])
            row[0] += time.perf_counter() - self._wall
            row[1] += time.thread_time() - self._cpu
            row[2] += 1
        _range_exit(self._range)
        return False


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
