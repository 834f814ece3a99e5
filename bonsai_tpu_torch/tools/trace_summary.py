"""Read a ``torch.profiler`` trace of ``classify --trace-dir``.

``python -m bonsai_tpu_torch classify ... --trace-dir DIR`` writes one
``*.pt.trace.json`` (Chrome trace format) into DIR: the program's spans
(``util.SPANS``: ``Classifier.process_dataset``'s stages and waits in
the thread that runs each, the build's phases), the host's torch
operators and, on a card, its kernels, copies and memsets.  This module
sums such a trace, or any trace of a run that opens those spans:

* each span's ranges by thread (count and microseconds);
* each kernel by name, and K1-K3's events by the wrapper variant that
  launched them (``classify_kernels``), matched by the ``__global__``
  functions of ``csrc/encode_probe.cu``, ``resolve.cu`` and
  ``step_outputs.cu``;
* the copies by direction (count, bytes, microseconds);
* the device's busy share (the union of kernel, copy and memset
  intervals over the traced span) and its longest idle gaps, each with
  the working spans that overlap it (``WORKING``: not the waits
  ``util.WAITS``, which only say that a thread stood still, nor
  ``pass``), and the share of all its idle time under some working span;
* each thread's share of its life that its spans cover (``threads``).

``python -m bonsai_tpu_torch.tools.trace_summary DIR`` prints its
``report``; ``chip_smoke.py`` phase 5c prints ``summary(load(DIR))``.
Times are the trace's own, taken under the profiler: a traced run may be
slower than an untraced one.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Tuple

from ..util import SPANS, STAGES, WAITS

# the spans over which an idle device waits on a thread's work
WORKING = tuple(s for s in SPANS if s not in WAITS and s != "pass")
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
    """{span: {thread id: [ranges, microseconds]}} of the four stages and
    of every other span of ``SPANS`` the trace holds."""
    out: Dict[str, Dict[int, List[float]]] = {s: {} for s in STAGES}
    for e in _spans(events, ("user_annotation",)):
        if e["name"] in SPANS:
            row = out.setdefault(e["name"], {}).setdefault(e["tid"], [0, 0.0])
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


def _union(ivs) -> List[List[float]]:
    """The union of intervals [(start, end)], as sorted disjoint ones."""
    merged: List[List[float]] = []
    for a, b in sorted(ivs):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _inside(ivs, within) -> float:
    """Microseconds of the disjoint sorted intervals ``ivs`` that lie inside
    the disjoint sorted intervals ``within``."""
    total, j = 0.0, 0
    for a, b in ivs:
        while j < len(within) and within[j][1] <= a:
            j += 1
        k = j
        while k < len(within) and within[k][0] < b:
            total += max(0.0, min(b, within[k][1]) - max(a, within[k][0]))
            k += 1
    return total


def busy(events):
    """(span (start, end), device-busy microseconds, idle gaps
    [(start, end)] longest first): the union of the kernel, copy and
    memset intervals inside the span, and the gaps it leaves there."""
    t0, t1 = span(events)
    merged = _union((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                    for e in _spans(events, DEVICE_CATS))
    gaps, at = [], t0
    for a, b in merged:
        if a > at:
            gaps.append((at, a))
        at = b
    if t1 > at:
        gaps.append((at, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    return (t0, t1), sum(b - a for a, b in merged), gaps


def working(events) -> List[dict]:
    """The ranges of the working spans (``WORKING``)."""
    return [e for e in _spans(events, ("user_annotation",))
            if e["name"] in WORKING]


def overlapping(events, a: float, b: float) -> Dict[str, float]:
    """{"span@tid": microseconds of its ranges inside [a, b)}, of the
    working spans."""
    out: Dict[str, float] = {}
    for e in working(events):
        lo, hi = max(e["ts"], a), min(e["ts"] + e["dur"], b)
        if hi > lo:
            key = f"{e['name']}@{e['tid']}"
            out[key] = out.get(key, 0.0) + hi - lo
    return out


def idle_under(events, gaps) -> Dict[str, float]:
    """{working span: microseconds of the idle ``gaps`` under its ranges},
    and under "any" of them (their union, counted once)."""
    idle = _union(gaps)
    by: Dict[str, List[Tuple[float, float]]] = {}
    for e in working(events):
        by.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    out = {n: _inside(_union(ivs), idle) for n, ivs in by.items()}
    out["any"] = _inside(_union([iv for ivs in by.values() for iv in ivs]),
                         idle)
    return out


def threads(events) -> Dict[str, dict]:
    """{thread id: {"spans", "life_us", "covered_us", "share"}}: each
    thread that opens a span, the names it opens, its life (its first
    span's start to its last span's end, inside the ``pass`` ranges where
    the trace has any: between two passes no thread of the pipeline
    runs) and the share of that life under its spans, working or
    waiting."""
    spans = [e for e in _spans(events, ("user_annotation",))
             if e["name"] in SPANS]
    passes = _union((e["ts"], e["ts"] + e["dur"]) for e in spans
                    if e["name"] == "pass")
    out: Dict[str, dict] = {}
    for tid in sorted({e["tid"] for e in spans}, key=str):
        mine = [e for e in spans if e["tid"] == tid]
        life = [[min(e["ts"] for e in mine),
                 max(e["ts"] + e["dur"] for e in mine)]]
        if passes:
            life = [[max(a, life[0][0]), min(b, life[0][1])]
                    for a, b in passes if b > life[0][0] and a < life[0][1]]
        life_us = sum(b - a for a, b in life)
        covered = _inside(_union((e["ts"], e["ts"] + e["dur"]) for e in mine
                                 if e["name"] != "pass"), life)
        out[str(tid)] = {
            "spans": sorted({e["name"] for e in mine}),
            "life_us": life_us, "covered_us": covered,
            "share": covered / life_us if life_us else 0.0}
    return out


def summary(events) -> dict:
    """The trace's sums as one JSON-ready dict (microseconds), with the
    three longest idle gaps and the idle time under each working span."""
    (t0, t1), busy_us, gaps = busy(events)
    idle_us = sum(b - a for a, b in gaps)
    under = idle_under(events, gaps)
    return {
        "span_us": t1 - t0,
        "device_busy_us": busy_us,
        "device_busy_share": busy_us / (t1 - t0) if t1 > t0 else 0.0,
        "stages": {s: {str(t): v for t, v in rows.items()}
                   for s, rows in stage_threads(events).items()},
        "threads": threads(events),
        "idle_us": idle_us,
        "idle_under": under,
        "idle_under_share": under["any"] / idle_us if idle_us else 0.0,
        "classify_kernels": classify_kernels(events),
        "kernels": kernels_by_name(events),
        "copies": copies(events),
        "idle_gaps": [{"at_us": a - t0, "us": b - a,
                       "host": overlapping(events, a, b)}
                      for a, b in gaps[:3]],
    }



def report(s: dict) -> str:
    """The lines ``main`` prints of a ``summary``: the device's busy share,
    the idle time under the working spans, each thread's covered share
    and its spans, the longest idle gaps."""
    idle = s["idle_us"] or 1.0
    lines = [
        f"device busy {s['device_busy_us']:.1f} us of {s['span_us']:.1f} us "
        f"({100 * s['device_busy_share']:.3f}%); idle {s['idle_us']:.1f} us, "
        f"{100 * s['idle_under_share']:.2f}% of it under a working span",
        "idle under each working span (us, share of idle): " + "; ".join(
            f"{n} {us:.1f} {100 * us / idle:.2f}%" for n, us in sorted(
                s["idle_under"].items(), key=lambda kv: -kv[1])
            if n != "any"),
    ]
    for tid, t in s["threads"].items():
        lines.append(f"thread {tid}: spans cover {100 * t['share']:.2f}% of "
                     f"its {t['life_us']:.1f} us ({', '.join(t['spans'])})")
    for name, rows in s["stages"].items():
        for tid, (n, us) in rows.items():
            lines.append(f"span {name} @ {tid}: {n} ranges, {us:.1f} us")
    for g in s["idle_gaps"]:
        lines.append(f"idle gap at +{g['at_us']:.1f} us, {g['us']:.1f} us, "
                     "under " + (", ".join(
                         f"{k} {v:.1f}" for k, v in g["host"].items())
                         or "no span"))
    return "\n".join(lines)


def main(argv=None) -> int:
    """``python -m bonsai_tpu_torch.tools.trace_summary DIR``: print the
    ``report`` of the one trace in DIR."""
    import sys

    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: python -m bonsai_tpu_torch.tools.trace_summary DIR",
              file=sys.stderr)
        return 2
    print(report(summary(load(args[0]))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
