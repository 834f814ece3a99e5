"""read_ms_per_mbase: milliseconds of the program's ``read`` span (the
producer thread's ``next()`` of ``fastx.batch_reads``: the native parse
and the LUT encode of a batch) in the traced window, a million bases
classified."""

from benchmark import spans

MOVES = "mbases_per_s"


def read(rec):
    return spans.ms_per_mbase(rec, "read")
