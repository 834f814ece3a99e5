"""mbases_per_s: bases of the window's whole passes over the pool, in
millions, over the window's seconds by the host clock (Kraken's Mbp/m
a second)."""

MOVES = "mbases_per_s"


def read(rec):
    if rec.kind != "classify":
        return None
    return rec.mbases / rec.window_s
