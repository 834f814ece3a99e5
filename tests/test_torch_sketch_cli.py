"""The port's sketch subcommands against ``bonsai_tpu.cli.main`` on the
CPU (``--device cpu``: the plain torch versions of the kernels), on the
golden genomes (phiX, its 1%-mutated copy, 20,000 random bases) and
phiX: the same arguments run in two empty directories, and the text on
stdout and stderr and every file written must be equal, byte for byte
(.shs / .bin compared after gunzip: gzip stamps a time in its header).

Exceptions, each a fault of the JAX package that the port does not copy:
``distmat --hll`` with three genomes, where the JAX package merges its
sketches in place (``test_distmat_hll_estimates_each_pair_alone``).
"""

import contextlib
import gzip
import io
import os

import numpy as np
import pytest

from bonsai_tpu import cli as jcli
from bonsai_tpu.sketch import hll as jhll
from bonsai_tpu_torch import cli

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLDEN = [os.path.join(DATA, "golden", f)
          for f in ("g_phix.fa", "g_phixmut.fa", "g_rand.fa")]
PHIX = os.path.join(DATA, "phix.fa")


def _run(main, argv, cwd):
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        os.chdir(old)
    return rc, out.getvalue(), err.getvalue()


def _content(path):
    opener = gzip.open if path.endswith((".shs", ".bin")) else open
    with opener(path, "rb") as fh:
        return fh.read()


def _same_run(tmp_path, argv):
    """Run both CLIs on ``argv`` in empty directories; return the port's
    directory after checking codes, text and files."""
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    dj.mkdir()
    dt.mkdir()
    want = _run(jcli.main, argv, dj)
    got = _run(cli.main, argv + ["--device", "cpu"], dt)
    assert got[0] == want[0] == 0
    assert got[1] == want[1]
    assert got[2].replace(str(dt), "D") == want[2].replace(str(dj), "D")
    files = sorted(os.listdir(dj))
    assert sorted(os.listdir(dt)) == files
    for f in files:
        assert _content(str(dt / f)) == _content(str(dj / f)), f
    return dt


@pytest.mark.parametrize("flags", [
    ["-k", "21"], ["-k", "17,21,31", "-C"], ["-k", "21,31", "--nthash"],
    ["-k", "25", "--shs-only"], ["-k", "25", "--bin-only"],
])
def test_kmercnt_matches_jax(tmp_path, flags):
    _same_run(tmp_path, ["kmercnt", *GOLDEN[:2], PHIX, *flags, "-o", "out"])


@pytest.mark.parametrize("flags", [
    ["-k", "21", "-z", "64", "-S", "-s"],
    ["-k", "31", "-z", "4096", "-S"],
    ["-k", "21", "-z", "256", "-C", "-Z"],
    ["-k", "40", "-z", "128", "-S", "-s"],  # k > 32: cyclic hashes
    ["-k", "21", "-z", "128", "-c"],
    ["-k", "7", "-z", "128", "-P"],
])
def test_setsketch_matches_jax(tmp_path, flags):
    _same_run(tmp_path, ["setsketch", *GOLDEN, *flags, "-B", "-o", "u.ss"])


def test_setsketch_paths_file_and_alias(tmp_path):
    lst = tmp_path / "paths.txt"
    lst.write_text("\n".join(GOLDEN[1:]) + "\n")
    _same_run(tmp_path, ["setsketcher", GOLDEN[0], "-F", str(lst), "-k", "21",
                         "-z", "64", "-B"])
    assert _run(cli.main, ["setsketch", "--device", "cpu"], tmp_path)[0] == 1


@pytest.mark.parametrize("cmd", ["rolling-multk", "rolling_multk"])
def test_rolling_multk_matches_jax(tmp_path, cmd):
    _same_run(tmp_path, [cmd, *GOLDEN, PHIX, "-C"])


def test_rolling_multk_sketch_matches_jax(tmp_path):
    _same_run(tmp_path, ["rolling-multk-sketch", *GOLDEN, "-k", "17,31",
                         "-z", "256", "-o", "rms"])


@pytest.mark.parametrize("metric", ["jaccard", "intersection", "union",
                                    "containment", "mash"])
def test_distmat_matches_jax(tmp_path, metric):
    _same_run(tmp_path, ["distmat", *GOLDEN, "-k", "21", "-o", "dm",
                         "--metric", metric])


@pytest.mark.parametrize("metric", ["jaccard", "union", "containment"])
def test_distmat_hll_of_two_genomes_matches_jax(tmp_path, metric):
    _same_run(tmp_path, ["distmat", *GOLDEN[:2], "-k", "21", "-o", "dmh",
                         "--hll", "12", "--metric", metric])


def test_distmat_hll_estimates_each_pair_alone(tmp_path):
    """Three genomes at --hll 12: entry (0, 2) of the port is the union
    estimate of sketches 0 and 2; the JAX package's is that of 0, 1 and 2
    (its merge raised sketch 0 in place for entry (0, 1)).  The diagonal
    and j = i + 1 agree."""
    from bonsai_tpu.core.spacer import Spacer
    from bonsai_tpu.db.build import genome_kmer_set

    argv = ["distmat", *GOLDEN, "-k", "21", "-o", "dm", "--hll", "12",
            "--metric", "union"]
    assert _run(jcli.main, argv, tmp_path)[0] == 0
    theirs = np.load(tmp_path / "dm.npy")
    assert _run(cli.main, argv + ["--device", "cpu"], tmp_path)[0] == 0
    ours = np.load(tmp_path / "dm.npy")
    hlls = []
    for p in GOLDEN:
        h = jhll.HyperLogLog(12)
        h.addh(genome_kmer_set(p, Spacer(21, 21), True))
        hlls.append(h)
    want = np.float32(hlls[0].union_estimate(hlls[2]))
    assert ours[0, 2] == ours[2, 0] == want
    assert theirs[0, 2] != want
    for i, j in ((0, 0), (1, 1), (2, 2), (0, 1), (1, 2)):
        assert ours[i, j] == theirs[i, j]


@pytest.mark.parametrize("metric", ["jaccard", "intersection", "union",
                                    "containment"])
def test_cmpshs_matches_jax(tmp_path, metric):
    assert jcli.main(["kmercnt", *GOLDEN, PHIX, "-k", "21", "--shs-only",
                      "-o", str(tmp_path / "x")]) == 0
    shs = [str(tmp_path / "x.21.shs")]
    for p in GOLDEN[1:]:
        assert jcli.main(["kmercnt", p, "-k", "21", "--shs-only", "-o",
                          str(tmp_path / os.path.basename(p))]) == 0
        shs.append(str(tmp_path / f"{os.path.basename(p)}.21.shs"))
    _same_run(tmp_path, ["cmpshs", *shs, "-m", metric])
    _same_run(tmp_path / "torch", ["cmpshs", *shs, "-m", metric, "-o",
                                   "m.tsv"])


# item 12a, ported: css2ss, shs2sketch, stdin2ss, setsketchroller,
# genome2multiset, errexp, ssi-build and ssi-screen (and their aliases);
# items 12b and 12c: hist, kmeridx and metatree, which run on the device,
# and lca, taxmap and fahist, host text work
SKETCH_TOOLS = {"css2ss", "shs2sketch", "ssi-build", "setsketchscreener",
                "stdin2ss", "genome2multiset", "setsketchroller", "errexp"}
DEVICE_TOOLS = {"hist", "kmeridx", "metatree"}


@pytest.mark.parametrize("argv", [
    ["hist", "db"], ["lca", "nodes.dmp", "1", "2"], ["taxmap", "a", "b"],
    ["css2ss", "a", "b"], ["shs2sketch", "a", "b"], ["ssi-build", "a"],
    ["setsketchscreener", "a", "b"], ["stdin2ss"], ["genome2multiset", "a"],
    ["fahist", "a"], ["kmeridx", "a", "-o", "b"], ["setsketchroller"],
    ["errexp", "-l", "0.2"], ["metatree", "a", "b"],
])
def test_item_12_subcommands_ask_for_the_card_or_their_inputs(
        tmp_path, monkeypatch, argv, capsys):
    """Every subcommand of item 12 is ported (``test_torch_sketch_tools.py``,
    ``test_torch_index_tools.py``, ``test_torch_metatree.py``) and none is
    refused naming ROADMAP: on the default device the sketch tools, hist,
    kmeridx and metatree ask for the card before they read an input (ssi-
    build without its -o fails argparse's check), and lca, taxmap and
    fahist, which take no device, fail only on their missing input
    files."""
    monkeypatch.chdir(tmp_path)  # no input file of these names
    if argv[0] in SKETCH_TOOLS | DEVICE_TOOLS:
        with pytest.raises((RuntimeError, SystemExit)) as e:
            cli.main(argv)
        err = capsys.readouterr().err
        assert "ROADMAP" not in err
        if e.type is SystemExit:
            assert argv[0] == "ssi-build" and "-o/--out" in err
        else:
            assert "no CUDA device" in str(e.value)
        return
    with pytest.raises(FileNotFoundError) as e:
        cli.main(argv)
    assert e.value.filename == argv[1]
    assert "ROADMAP" not in capsys.readouterr().err
