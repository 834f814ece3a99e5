"""The program's spans in a traced window, for the per-layer metrics that
read them.

The program marks its phases with ``torch.profiler.record_function``
ranges (``bonsai_tpu_torch/util.py`` ``span``; ``SPANS`` there names them
all).  A ``--trace 1`` run's Chrome trace holds each range as an
``X`` event of category ``user_annotation`` under the span's name, on the
profiler's clock beside the card's kernels and copies.  The trace drops a
range's arguments, so a span's name is its only label, and a count is
the number of its events.  Every sum here takes the events of the
window, each clipped to the profiler's own span (``trace.window``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def ranges(rec, name: str) -> List[Tuple[float, float]]:
    """[(start, end)] microseconds of the span ``name``'s events inside the
    traced window, clipped to it, in start order ([] without a trace)."""
    if rec.trace is None:
        return []
    t0, t1 = rec.trace.t0, rec.trace.t1
    out = []
    for e in rec.trace.events:
        if (e.get("ph") != "X" or e.get("cat") != "user_annotation"
                or e.get("name") != name):
            continue
        if e["ts"] + e["dur"] < t0 or e["ts"] > t1:
            continue
        out.append((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)))
    out.sort()
    return out


def seconds(rec, *names: str) -> Optional[float]:
    """The summed seconds of the spans ``names`` in the window, or None
    where the trace holds none of them."""
    got = [r for n in names for r in ranges(rec, n)]
    if not got:
        return None
    return sum(b - a for a, b in got) * 1e-6


def ms_per_mbase(rec, *names: str) -> Optional[float]:
    """Milliseconds of the spans ``names`` a million bases classified, in a
    classify cell."""
    if rec.kind != "classify" or not rec.mbases:
        return None
    sec = seconds(rec, *names)
    return None if sec is None else 1e3 * sec / rec.mbases


def ms_per_mkmer(rec, *names: str) -> Optional[float]:
    """Milliseconds of the spans ``names`` a million k-mers placed by the
    window's builds, in a build cell."""
    if rec.kind != "build" or not rec.units or not rec.kmers:
        return None
    sec = seconds(rec, *names)
    return None if sec is None else 1e3 * sec / (rec.units * rec.kmers / 1e6)


def batch_latencies(rec) -> Optional[List[float]]:
    """Each batch's seconds from the start of its ``parse`` to the end of
    its ``format``: the queues between the classifier's threads are FIFO
    and its passes run one after another, so the k-th ``parse`` of the
    window and its k-th ``format`` are one batch.  None where the counts
    differ or there is no batch."""
    parse, fmt = ranges(rec, "parse"), ranges(rec, "format")
    if not parse or len(parse) != len(fmt):
        return None
    return [(f[1] - p[0]) * 1e-6 for p, f in zip(parse, fmt)]
