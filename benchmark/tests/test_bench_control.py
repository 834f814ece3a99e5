"""The control (the reference with each k-mer's first genome in place of
the LCA) fails each cell's check at a size a test run holds."""

from benchmark import control

from .conftest import ROOT


def test_the_control_fails_the_classify_check(tiny):
    bench, bdir, _ = tiny
    got = control.readings("phix.hiseq", 3, ROOT, bench, bdir, "cpu")
    assert got["lines_differ"] > 0, got


def test_the_control_fails_the_build_check(tiny):
    bench, bdir, _ = tiny
    got = control.readings("phix.build", 3, ROOT, bench, bdir, "cpu")
    assert got["kmers_differ"] > 0
