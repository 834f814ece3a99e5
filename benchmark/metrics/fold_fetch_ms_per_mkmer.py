"""fold_fetch_ms_per_mkmer: milliseconds of the program's ``fold_fetch`` span
(the genomes' tree fold and the copy of the keys and taxa to the host) in
the traced window, a million distinct k-mers placed by the window's
builds."""

from benchmark import spans

MOVES = "build_mkmers_per_s"


def read(rec):
    return spans.ms_per_mkmer(rec, "fold_fetch")
