"""Device-trace arithmetic of the benchmark's traced runs.

A ``--trace 1`` run records its window under ``torch.profiler`` (CPU and
CUDA activity, every thread) and reads the Chrome trace it exports.  The
arithmetic is a frozen copy of the program's ``tools/trace_summary.py``
(``short_name``, the busy union and its gaps, the stage ranges over a
gap), so that a change to the program cannot change how it is measured:

* device busy time is the union of the kernel, copy and memset intervals
  inside the traced span, never their sum; ``gpu_user_annotation`` spans
  (the device-side shadows of ``record_function`` ranges) are not work;
* a kernel's time is the sum of its events' durations.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STAGES = ("parse", "dispatch", "materialize", "format")


def spans(events, cats) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def short_name(name: str) -> str:
    """A kernel's demangled name without its return type, namespaces and
    parameters (its template arguments kept)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, end = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            end = i
            break
    name, depth, cut = name[:end], 0, 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0 and name.startswith("::", i):
            cut = i + 2
    return name[cut:]


def window(events) -> Tuple[float, float]:
    """(start, end) microseconds of the profiler's own span."""
    for e in spans(events, ("Trace",)):
        return e["ts"], e["ts"] + e["dur"]
    raise ValueError("the trace holds no profiler span")


def busy(events, t0: float, t1: float):
    """(device-busy microseconds, idle gaps [(start, end)] longest first)
    inside [t0, t1]."""
    ivs = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                 for e in spans(events, DEVICE_CATS))
    merged: List[List[float]] = []
    for a, b in ivs:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps, at = [], t0
    for a, b in merged:
        if a > at:
            gaps.append((at, a))
        at = b
    if t1 > at:
        gaps.append((at, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    return sum(b - a for a, b in merged), gaps


def overlapping(events, a: float, b: float) -> Dict[str, float]:
    """{stage: microseconds of its ranges inside [a, b)}."""
    out: Dict[str, float] = {}
    for e in spans(events, ("user_annotation",)):
        if e["name"] not in STAGES:
            continue
        lo, hi = max(e["ts"], a), min(e["ts"] + e["dur"], b)
        if hi > lo:
            out[e["name"]] = out.get(e["name"], 0.0) + hi - lo
    return out


class Trace:
    """A traced window's events with the sums the metric readers take."""

    def __init__(self, events: List[dict]):
        self.events = events
        self.t0, self.t1 = window(events)
        self.busy_us, self.gaps = busy(events, self.t0, self.t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return self.busy_us * 1e-6

    def device_ops(self) -> Dict[str, float]:
        """{kernel short name, or copy/memset name: seconds}."""
        out: Dict[str, float] = {}
        for e in spans(self.events, DEVICE_CATS):
            name = (short_name(e["name"]) if e["cat"] == "kernel"
                    else e["name"])
            out[name] = out.get(name, 0.0) + e["dur"] * 1e-6
        return out

    def kernel_seconds(self, patterns: Sequence[str]) -> Tuple[int, float]:
        """(events, seconds) of the kernels whose name matches any of the
        regular expressions ``patterns``."""
        rx = [re.compile(p) for p in patterns]
        n, us = 0, 0.0
        for e in spans(self.events, ("kernel",)):
            if any(r.search(e["name"]) for r in rx):
                n += 1
                us += e["dur"]
        return n, us * 1e-6

    def idle_gaps(self, top: int = 10) -> List[List]:
        """[[the stages over the gap, longest first, or "no stage",
        seconds]] of the ``top`` longest idle gaps."""
        out = []
        for a, b in self.gaps[:top]:
            over = overlapping(self.events, a, b)
            name = "+".join(sorted(over, key=lambda s: -over[s])) or "no stage"
            out.append([name, (b - a) * 1e-6])
        return out


def record(prof) -> Trace:
    """The events of a finished ``torch.profiler.profile``, through a
    Chrome trace written under the temporary directory and removed."""
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events)
