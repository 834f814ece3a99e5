"""writer_starved_ms_per_mbase: milliseconds of the program's
``writer_starved`` span (the writer's ``get`` from the empty queue of
dispatched batches: the main thread is behind) in the traced window, a
million bases classified."""

from benchmark import spans

MOVES = "mbases_per_s"


def read(rec):
    return spans.ms_per_mbase(rec, "writer_starved")
