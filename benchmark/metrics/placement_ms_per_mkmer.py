"""placement_ms_per_mkmer: milliseconds of the program's ``placement`` span
(``db/table.py`` ``KmerTable``: the sort check, the hash and the host
cuckoo placer) in the traced window, a million distinct k-mers placed by
the window's builds."""

from benchmark import spans

MOVES = "build_mkmers_per_s"


def read(rec):
    return spans.ms_per_mkmer(rec, "placement")
