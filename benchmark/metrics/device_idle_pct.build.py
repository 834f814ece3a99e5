"""device_idle_pct.build: the share of the traced window in which no kernel,
copy or memset ran on the card (100 less the busy union's share), in a
build cell."""

MOVES = "build_mkmers_per_s"


def read(rec):
    if rec.kind != "build" or rec.trace is None or not rec.trace.busy_us:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
