"""writer_ms_per_mbase: milliseconds of the classifier's writer thread,
its ``materialize`` and ``format`` stages (``Classifier.stage_seconds``,
summed over the traced window's passes), a million bases classified."""

MOVES = "mbases_per_s"


def read(rec):
    if rec.kind != "classify" or not rec.mbases:
        return None
    s = rec.stage_seconds
    return 1e3 * (s["materialize"] + s["format"]) / rec.mbases
