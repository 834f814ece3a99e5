"""device_wait_ms_per_mbase: milliseconds of the program's ``device_wait``
span (inside the writer's ``materialize``, its wait on the batch's event:
K1-K3 and the compact matrix's copy to the host not done yet) in the
traced window, a million bases classified."""

from benchmark import spans

MOVES = "mbases_per_s"


def read(rec):
    return spans.ms_per_mbase(rec, "device_wait")
