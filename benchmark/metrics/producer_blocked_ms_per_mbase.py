"""producer_blocked_ms_per_mbase: milliseconds of the program's
``producer_blocked`` span (the producer's ``put`` into the full queue to
the main thread: the main thread is behind) in the traced window, a
million bases classified."""

from benchmark import spans

MOVES = "mbases_per_s"


def read(rec):
    return spans.ms_per_mbase(rec, "producer_blocked")
