"""k2_roofline_pct: K2's (resolve, ``csrc/resolve.cu``) share of its
roofline over the traced window: the least time of the window's passes
(``roofline.k2_bound_s``, with each read's distinct hit taxa from its
checked record) over the device time of K2's events in the trace."""

from benchmark import roofline

MOVES = "mbases_per_s"
KERNELS = (r"resolve_warp", r"resolve_block")


def read(rec):
    if rec.kind != "classify" or rec.trace is None:
        return None
    n, sec = rec.trace.kernel_seconds(KERNELS)
    if not n or sec <= 0:
        return None
    bound = rec.units * roofline.k2_bound_s(
        rec.pool.lengths, rec.distinct_hit_taxa(), rec.k, rec.batch)
    return 100.0 * bound / sec
