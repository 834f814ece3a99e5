"""genome_read_ms_per_mkmer: milliseconds of the program's ``genome_read``
span (``db/build_device.py``: each genome record's read, each chunk's LUT
encode and host tensor) in the traced window, a million distinct k-mers
placed by the window's builds."""

from benchmark import spans

MOVES = "build_mkmers_per_s"


def read(rec):
    return spans.ms_per_mkmer(rec, "genome_read")
