"""batch_latency_ms: the median over the traced window's batches of a
batch's milliseconds from the start of its ``parse`` span (producer
thread) to the end of its ``format`` span (writer thread), paired in
order (``spans.batch_latencies``)."""

import statistics

from benchmark import spans

MOVES = "mbases_per_s"


def read(rec):
    if rec.kind != "classify":
        return None
    lat = spans.batch_latencies(rec)
    return None if lat is None else 1e3 * statistics.median(lat)
