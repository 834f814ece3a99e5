"""peak_device_gib: torch.cuda.max_memory_allocated() of the run in GiB:
the database and the window's work."""

MOVES = "peak_device_gib"


def read(rec):
    return rec.peak_bytes / 2**30
