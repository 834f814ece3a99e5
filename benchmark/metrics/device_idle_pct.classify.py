"""device_idle_pct.classify: the share of the traced window in which no kernel,
copy or memset ran on the card (100 less the busy union's share), in a
classify cell."""

MOVES = "mbases_per_s"


def read(rec):
    if rec.kind != "classify" or rec.trace is None or not rec.trace.busy_us:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
