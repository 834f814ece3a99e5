"""dispatch_blocked_ms_per_mbase: milliseconds of the program's
``dispatch_blocked`` span (the main thread's ``put`` into the full queue
to the writer, and its wait for the writer's end: the writer is behind) in
the traced window, a million bases classified."""

from benchmark import spans

MOVES = "mbases_per_s"


def read(rec):
    return spans.ms_per_mbase(rec, "dispatch_blocked")
