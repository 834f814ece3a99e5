"""full_fetch_pct: the share of the traced window's batches whose compact
output overflowed its run capacity (or was forced full), so that the
writer fetched and unpacked the full positional matrix: 100 times the
program's ``full_fetch`` spans over its ``parse`` spans (one a batch).
A program without the span (its ``device_wait``, one a batch, absent
too) reads nothing."""

from benchmark import spans

MOVES = "mbases_per_s"


def read(rec):
    if rec.kind != "classify":
        return None
    batches = spans.ranges(rec, "parse")
    if not batches or not spans.ranges(rec, "device_wait"):
        return None
    return 100.0 * len(spans.ranges(rec, "full_fetch")) / len(batches)
