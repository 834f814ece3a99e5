"""A whole run of a tiny cell on the CPU (the program's plain torch
versions), sound and with the timed path broken underneath: each fault
the cell can have turns ``correct`` false."""

import numpy as np
import pytest
import torch


def test_sound_classify_runs_are_correct(run_tiny):
    out = run_tiny("phix.hiseq", 2**31 + 99)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 3000 and not out["failed"]
    assert set(out["metrics"]) == {"mbases_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


def test_a_traced_run_reports_the_layers(run_tiny):
    out = run_tiny("phix.hiseq", 7, traced=True)
    assert out["correct"]
    assert {"producer_ms_per_mbase", "dispatch_ms_per_mbase",
            "writer_ms_per_mbase"} <= set(out["metrics"])
    assert "window_s" in out["device"] and "breakdown" in out


def test_an_answer_altered_where_it_is_produced(run_tiny, monkeypatch):
    from bonsai_tpu_torch.classify import pipeline

    orig = pipeline.resolve

    def altered(*a, **k):
        t = orig(*a, **k)
        return torch.where(t != 0, torch.ones_like(t), t)

    monkeypatch.setattr(pipeline, "resolve", altered)
    out = run_tiny("phix.hiseq", 11)
    assert not out["correct"] and out["checks"]["lines_differ"]["value"]


def test_half_of_each_batch_left_out(run_tiny, monkeypatch):
    from bonsai_tpu_torch.classify import pipeline
    from bonsai_tpu_torch.io import fastx

    orig = fastx.batch_reads

    def half(*a, **k):
        for b in orig(*a, **k):
            h = max(len(b.names) // 2, 1)
            yield fastx.ReadBatch(b.names[:h], b.seqs[:h], b.codes[:h],
                                  b.lengths[:h],
                                  b.quals[:h] if b.quals else None)

    monkeypatch.setattr(pipeline.fastx, "batch_reads", half)
    out = run_tiny("phix.hiseq", 12)
    assert not out["correct"] and out["checks"]["lines_differ"]["value"]


def test_a_pass_that_leaves_its_state_unchanged(run_tiny, monkeypatch):
    from bonsai_tpu_torch.classify.pipeline import Classifier

    def idle(self, path, out_fh, *a, **k):
        self.stage_seconds = dict.fromkeys(
            ("parse", "dispatch", "materialize", "format"), 0.0)

    monkeypatch.setattr(Classifier, "process_dataset", idle)
    out = run_tiny("phix.hiseq", 13)
    assert not out["correct"] and out["checks"]["lines_differ"]["value"]


def test_a_later_pass_with_an_answer_altered(run_tiny, monkeypatch):
    from bonsai_tpu_torch.classify import pipeline
    from bonsai_tpu_torch.classify.pipeline import Classifier

    orig, calls = Classifier.process_dataset, []
    resolve = pipeline.resolve

    def altered(*a, **k):
        t = resolve(*a, **k)
        return torch.where(t != 0, torch.ones_like(t), t)

    def later(self, *a, **k):
        # the warm-up's passes and the window's first are sound
        calls.append(1)
        if len(calls) == 4:
            monkeypatch.setattr(pipeline, "resolve", altered)
        return orig(self, *a, **k)

    monkeypatch.setattr(Classifier, "process_dataset", later)
    out = run_tiny("phix.hiseq", 14, seconds=1.0)
    assert not out["correct"] and out["checks"]["lines_differ"]["value"]


def test_sound_build_runs_are_correct(run_tiny):
    out = run_tiny("phix.build", 5)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"build_mkmers_per_s", "peak_device_gib",
                                   "setup_s"}


def test_a_build_with_an_answer_altered(run_tiny, monkeypatch):
    from bonsai_tpu_torch.db import build_device

    orig = build_device._finish_fold

    def altered(*a, **k):
        keys, taxa, *rest = orig(*a, **k)
        taxa = taxa.copy()
        taxa[0] = 1 if taxa[0] != 1 else 2
        return (keys, taxa, *rest)

    monkeypatch.setattr(build_device, "_finish_fold", altered)
    out = run_tiny("phix.build", 6)
    # one k-mer's taxon altered in every build of the window
    assert not out["correct"]
    assert out["checks"]["kmers_differ"]["value"] == out["attempted"]


def test_a_build_with_half_its_genomes_left_out(run_tiny, monkeypatch):
    from bonsai_tpu_torch.db import build_device

    orig = build_device._device_gather

    def half(paths, *a, **k):
        return orig(paths[:max(len(paths) // 2, 1)], *a, **k)

    monkeypatch.setattr(build_device, "_device_gather", half)
    out = run_tiny("phix.build", 7)
    assert not out["correct"] and out["checks"]["kmers_differ"]["value"]


def test_a_fold_that_leaves_its_state_unchanged(run_tiny, monkeypatch):
    from bonsai_tpu_torch.db import build_device

    monkeypatch.setattr(build_device, "merge_fold",
                        lambda a, b, *x, **k: a)
    out = run_tiny("phix.build", 8)
    assert not out["correct"] and out["checks"]["kmers_differ"]["value"]


def test_a_placement_that_drops_a_key(run_tiny, monkeypatch):
    from bonsai_tpu_torch.db.table import KmerTable

    orig = KmerTable._place

    def dropping(self, nb, *a, **k):
        ok = orig(self, nb, *a, **k)
        if ok:
            i = int(np.flatnonzero(self._occ)[0])
            self._occ[i] = False
            self._own, self._word = self._own[1:], self._word[1:]
        return ok

    monkeypatch.setattr(KmerTable, "_place", dropping)
    out = run_tiny("phix.build", 9)
    # one k-mer missing from every build's image
    assert not out["correct"]
    assert out["checks"]["kmers_differ"]["value"] == 2 * out["attempted"]


def test_a_placement_left_for_later_is_timed(run_tiny, monkeypatch):
    """A table that defers its placement places it when its image is made,
    inside the window: still correct, and nothing escapes the timing."""
    from bonsai_tpu_torch.db.table import KmerTable

    orig, placed = KmerTable._place, []

    def lazy(self, nb, *a, **k):
        placed.append(nb)
        if len(placed) % 2:
            # the constructor's call: the bucket count only, nothing placed
            self.nb, self.lgnb = nb, nb.bit_length() - 1
            self.vbits = max(self.lgnb - 2, 0)
            self._occ = None
            return True
        return orig(self, nb, *a, **k)

    monkeypatch.setattr(KmerTable, "_place", lazy)
    out = run_tiny("phix.build", 10)
    assert out["correct"], out["checks"]
    assert len(placed) == 2 * (out["attempted"] + 1)


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(card, run_tiny):
    for cell in ("phix.hiseq", "phix.build"):
        out = run_tiny(cell, 2**31 + 5, device=card)
        assert out["correct"], (cell, out["checks"])
        assert out["device"]["platform"] == "gpu"
