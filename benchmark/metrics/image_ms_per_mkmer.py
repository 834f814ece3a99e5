"""image_ms_per_mkmer: milliseconds of the program's ``image`` and
``payload`` spans (the slot image of ``KmerTable.encode_slots`` and the
classifier's values of ``formats.payload``) in the traced window, a
million distinct k-mers placed by the window's builds."""

from benchmark import spans

MOVES = "build_mkmers_per_s"


def read(rec):
    return spans.ms_per_mkmer(rec, "image", "payload")
