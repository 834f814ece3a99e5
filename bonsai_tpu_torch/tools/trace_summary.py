"""Read a ``torch.profiler`` trace of ``classify --trace-dir``.

``python -m bonsai_tpu_torch classify ... --trace-dir DIR`` writes one
``*.pt.trace.json`` (Chrome trace format) into DIR: the four stage ranges
of ``Classifier.process_dataset`` (``parse`` in the producer thread,
``dispatch`` in the main thread, ``materialize`` and ``format`` in the
writer thread), the host's torch operators and, on a card, its kernels,
copies and memsets.  This module sums such a trace:

* each stage's ranges by thread (count and microseconds);
* each kernel by name, and K1-K3's events by the wrapper variant that
  launched them (``classify_kernels``), matched by the ``__global__``
  functions of ``csrc/encode_probe.cu``, ``resolve.cu`` and
  ``step_outputs.cu``;
* the copies by direction (count, bytes, microseconds);
* the device's busy share (the union of kernel, copy and memset
  intervals over the traced span) and its longest idle gaps, each with
  the stage ranges that overlap it.

``chip_smoke.py`` phase 5c prints ``summary(load(DIR))``.  Times are the
trace's own, taken under the profiler: a traced run is slower than an
untraced one.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Tuple

STAGES = ("parse", "dispatch", "materialize", "format")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# K1's template <bool kSpaced, int kMode> (csrc/encode_probe.cu, enum Mode)
# to the variant its wrapper counts (classify/pipeline.py encode_probe)
K1_VARIANTS = {
    (False, 0): "contiguous", (True, 0): "spaced",
    (False, 1): "range", (True, 1): "spaced range",
    (False, 2): "encode", (True, 2): "spaced encode",
    (False, 3): "sparse", (True, 3): "spaced sparse",
}
_K1 = re.compile(r"encode_probe_kernel<(false|true), (\d+)>")
_K2 = ("resolve_warp", "resolve_block")
_K3 = "step_outputs_kernel"


def load(trace_dir: str) -> List[dict]:
    """The events of the one ``*.pt.trace.json`` in ``trace_dir``."""
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise ValueError(f"{trace_dir}: {len(files)} *.pt.trace.json files, "
                         "one expected")
    with open(files[0]) as fh:
        return json.load(fh)["traceEvents"]


def _spans(events, cats) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def stage_threads(events) -> Dict[str, Dict[int, List[float]]]:
    """{stage: {thread id: [ranges, microseconds]}}."""
    out: Dict[str, Dict[int, List[float]]] = {s: {} for s in STAGES}
    for e in _spans(events, ("user_annotation",)):
        if e["name"] in out:
            row = out[e["name"]].setdefault(e["tid"], [0, 0.0])
            row[0] += 1
            row[1] += e["dur"]
    return out


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


def kernels_by_name(events) -> Dict[str, List[float]]:
    """{kernel's short name: [launches, microseconds]}."""
    out: Dict[str, List[float]] = {}
    for e in _spans(events, ("kernel",)):
        row = out.setdefault(short_name(e["name"]), [0, 0.0])
        row[0] += 1
        row[1] += e["dur"]
    return out


def classify_row(name: str):
    """The K1-K3 row of a kernel event's name: ("encode_probe", variant),
    ("resolve", None), ("step_outputs", None), or None."""
    m = _K1.search(name)
    if m:
        return "encode_probe", K1_VARIANTS[(m.group(1) == "true",
                                            int(m.group(2)))]
    if any(k in name for k in _K2):
        return "resolve", None
    if _K3 in name:
        return "step_outputs", None
    return None


def classify_kernels(events) -> Dict[str, List[float]]:
    """{"encode_probe <variant>" | "resolve" | "step_outputs": [launches,
    microseconds]} of K1-K3's events."""
    out: Dict[str, List[float]] = {}
    for e in _spans(events, ("kernel",)):
        row = classify_row(e["name"])
        if row is not None:
            key = row[0] if row[1] is None else f"{row[0]} {row[1]}"
            acc = out.setdefault(key, [0, 0.0])
            acc[0] += 1
            acc[1] += e["dur"]
    return out


def copies(events) -> Dict[str, List[float]]:
    """{"HtoD" | "DtoH" | "DtoD" | ...: [copies, bytes, microseconds]}."""
    out: Dict[str, List[float]] = {}
    for e in _spans(events, ("gpu_memcpy",)):
        m = re.search(r"Memcpy (\w+)", e["name"])
        row = out.setdefault(m.group(1) if m else e["name"], [0, 0, 0.0])
        row[0] += 1
        row[1] += int(e.get("args", {}).get("bytes", 0))
        row[2] += e["dur"]
    return out


def span(events) -> Tuple[float, float]:
    """(start, end) microseconds of the traced run, the profiler's own
    span."""
    for e in _spans(events, ("Trace",)):
        return e["ts"], e["ts"] + e["dur"]
    raise ValueError("the trace holds no profiler span")


def busy(events):
    """(span (start, end), device-busy microseconds, idle gaps
    [(start, end)] longest first): the union of the kernel, copy and
    memset intervals inside the span, and the gaps it leaves there."""
    t0, t1 = span(events)
    ivs = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                 for e in _spans(events, DEVICE_CATS))
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
    return (t0, t1), sum(b - a for a, b in merged), gaps


def overlapping(events, a: float, b: float) -> Dict[str, float]:
    """{"stage@tid": microseconds of its ranges inside [a, b)}."""
    out: Dict[str, float] = {}
    for e in _spans(events, ("user_annotation",)):
        if e["name"] not in STAGES:
            continue
        lo, hi = max(e["ts"], a), min(e["ts"] + e["dur"], b)
        if hi > lo:
            key = f"{e['name']}@{e['tid']}"
            out[key] = out.get(key, 0.0) + hi - lo
    return out


def summary(events) -> dict:
    """The trace's sums as one JSON-ready dict (microseconds), with the
    three longest idle gaps."""
    (t0, t1), busy_us, gaps = busy(events)
    return {
        "span_us": t1 - t0,
        "device_busy_us": busy_us,
        "device_busy_share": busy_us / (t1 - t0) if t1 > t0 else 0.0,
        "stages": {s: {str(t): v for t, v in rows.items()}
                   for s, rows in stage_threads(events).items()},
        "classify_kernels": classify_kernels(events),
        "kernels": kernels_by_name(events),
        "copies": copies(events),
        "idle_gaps": [{"at_us": a - t0, "us": b - a,
                       "host": overlapping(events, a, b)}
                      for a, b in gaps[:3]],
    }

