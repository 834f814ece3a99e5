"""setup_s: seconds from the start of the process to the window's start:
imports, CUDA's start, the program's library loads (their build on a
checkout's first run), the database's load or build and upload, the
pool's generation and the warm-up."""

MOVES = "setup_s"


def read(rec):
    return rec.setup_s
