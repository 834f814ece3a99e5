"""dispatch_starved_ms_per_mbase: milliseconds of the program's
``dispatch_starved`` span (the main thread's ``get`` from the empty queue
of prepared batches: the producer is behind) in the traced window, a
million bases classified."""

from benchmark import spans

MOVES = "mbases_per_s"


def read(rec):
    return spans.ms_per_mbase(rec, "dispatch_starved")
