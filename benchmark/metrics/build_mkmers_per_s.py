"""build_mkmers_per_s: distinct k-mers placed by the window's whole
builds, in millions, over the window's seconds by the host clock."""

MOVES = "build_mkmers_per_s"


def read(rec):
    if rec.kind != "build":
        return None
    return rec.units * rec.kmers / 1e6 / rec.window_s
