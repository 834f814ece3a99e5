"""k1_roofline_pct: K1's (encode + probe, ``csrc/encode_probe.cu``) share
of its roofline over the traced window: the least time of the window's
passes (``roofline.k1_bound_s`` of the pool's own reads) over the device
time of K1's events in the trace."""

from benchmark import roofline

MOVES = "mbases_per_s"
KERNELS = (r"encode_probe_kernel<",)


def read(rec):
    if rec.kind != "classify" or rec.trace is None:
        return None
    n, sec = rec.trace.kernel_seconds(KERNELS)
    if not n or sec <= 0:
        return None
    bound = rec.units * roofline.k1_bound_s(
        rec.pool.lengths, rec.valid_kmers(), rec.k, rec.batch)
    return 100.0 * bound / sec
