"""producer_ms_per_mbase: milliseconds of the classifier's ``parse`` stage
(``Classifier.stage_seconds``, summed over the traced window's passes) a
million bases classified."""

MOVES = "mbases_per_s"


def read(rec):
    if rec.kind != "classify" or not rec.mbases:
        return None
    return 1e3 * rec.stage_seconds["parse"] / rec.mbases
