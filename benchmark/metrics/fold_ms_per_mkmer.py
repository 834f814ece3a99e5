"""fold_ms_per_mkmer: milliseconds of the program's ``fold`` span (each
chunk's trim, which reads the previous merge's count on the host, and its
KB1, KB2 and KB3 launches) in the traced window, a million distinct k-mers
placed by the window's builds."""

from benchmark import spans

MOVES = "build_mkmers_per_s"


def read(rec):
    return spans.ms_per_mkmer(rec, "fold")
