"""Port parity: the sketch tools (css2ss, shs2sketch, stdin2ss,
setsketchroller, genome2multiset, errexp, ssi-build/setsketchindexer,
ssi-screen/setsketchscreener), ``sketch/ssi.py`` and ``sketch/gchunk.py``,
on the CPU.

Each subcommand runs through ``bonsai_tpu.cli.main`` and the port's
``cli.main --device cpu`` (the plain versions of KS1 and KS2) on the same
inputs, made by the JAX CLI from the golden genomes (phiX, its
1%-mutated copy, 20,000 random bases) or drawn from a numpy seed, in two
empty directories: the text on stdout and stderr and every file written
must be equal, byte for byte (.bin after gunzip: gzip stamps a time in
its header).  ``SetSketchIndex`` (add, query, topk, merge, write, read,
``build_index``) and ``GenomeChunker``'s profiles and registers are held
to the JAX package's on random registers and on the golden genomes.

Tolerance: equal bytes and equal values.  (On the card KS2's registers
are within 2 ulp of these, the one stated tolerance; ``chip_smoke.py``
counts the packed registers that it moves across a quantization step.)
"""

import contextlib
import gzip
import io
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

from bonsai_tpu import cli as jcli
from bonsai_tpu.core.spacer import Spacer as JSpacer
from bonsai_tpu.sketch import gchunk as jgchunk
from bonsai_tpu.sketch import setsketch as jss
from bonsai_tpu.sketch import ssi as jssi

from bonsai_tpu_torch import cli
from bonsai_tpu_torch.core.bitops import as_keys
from bonsai_tpu_torch.core.spacer import Spacer
from bonsai_tpu_torch.sketch import gchunk, ssi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
GOLDEN = [os.path.join(DATA, "golden", f)
          for f in ("g_phix.fa", "g_phixmut.fa", "g_rand.fa")]


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
    opener = gzip.open if path.endswith((".shs", ".bin", ".gz")) else open
    with opener(path, "rb") as fh:
        return fh.read()


def _same_run(tmp_path, argv, name="run"):
    """Both CLIs on ``argv`` in empty directories: codes, text and every
    file equal; returns (port's directory, its stdout)."""
    dj, dt = tmp_path / f"{name}_jax", tmp_path / f"{name}_torch"
    dj.mkdir()
    dt.mkdir()
    want = _run(jcli.main, argv, dj)
    got = _run(cli.main, argv + ["--device", "cpu"], dt)
    assert got[0] == want[0] == 0, (got[2], want[2])
    assert got[1].replace(str(dt), "D") == want[1].replace(str(dj), "D")
    assert got[2].replace(str(dt), "D") == want[2].replace(str(dj), "D")
    files = sorted(os.listdir(dj))
    assert sorted(os.listdir(dt)) == files and files
    for f in files:
        assert _content(str(dt / f)) == _content(str(dj / f)), f
    return dt, got[1]


def _touch_nothing_run(tmp_path, argv, name):
    """_same_run for commands that write only to stdout and stderr."""
    dj, dt = tmp_path / f"{name}_jax", tmp_path / f"{name}_torch"
    dj.mkdir()
    dt.mkdir()
    want = _run(jcli.main, argv, dj)
    got = _run(cli.main, argv + ["--device", "cpu"], dt)
    assert got == want
    return got[1]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The JAX CLI's setsketch (-S: .ss and .u64.kmers) and kmercnt (.shs)
    of the golden genomes, and a raw stream of 16-byte records."""
    d = tmp_path_factory.mktemp("inputs")
    assert _run(jcli.main, ["setsketch", *GOLDEN, "-k", "21", "-z", "512",
                            "-S", "-B", "-o", "union.ss"], d)[0] == 0
    for p in GOLDEN:
        assert _run(jcli.main, ["kmercnt", p, "-k", "21", "--shs-only", "-o",
                                os.path.basename(p)], d)[0] == 0
    rng = np.random.default_rng(16)
    rec = rng.integers(0, 2**64, 2 * 9000 + 1, dtype=np.uint64)  # + 8 B
    rec.tofile(d / "stream.bin")
    names = [os.path.basename(p) for p in GOLDEN]
    return dict(
        dir=d,
        ss=[str(d / f"{n}.21.512.ss") for n in names],
        union=str(d / "union.ss"),
        kmers=[str(d / f"{n}.21.512.u64.kmers") for n in names],
        shs=[str(d / f"{n}.21.shs") for n in names],
        stream=str(d / "stream.bin"))


@pytest.mark.parametrize("bits", ["16", "8", "20"])
def test_css2ss_matches_jax(tmp_path, inputs, bits):
    for i, ss in enumerate(inputs["ss"] + [inputs["union"]]):
        _same_run(tmp_path, ["css2ss", ss, "out.pss", "-b", bits], f"r{i}")


@pytest.mark.parametrize("flags", [["-z", "512"], ["-z", "4096", "-b", "8"],
                                   ["-z", "64", "-b", "12"]])
def test_shs2sketch_matches_jax(tmp_path, inputs, flags):
    for i, shs in enumerate(inputs["shs"]):
        _same_run(tmp_path, ["shs2sketch", shs, "out.pss", *flags], f"r{i}")


@pytest.mark.parametrize("flags", [[], ["-H"], ["-S", "4096", "-H"],
                                   ["-S", "64", "-a", "1e-3", "-b", "1.01"]])
def test_stdin2ss_matches_jax(tmp_path, inputs, flags):
    _same_run(tmp_path, ["stdin2ss", inputs["stream"], "-o", "s.ss", *flags])


@pytest.mark.parametrize("records", [0, 1])
def test_stdin2ss_subprocess_stderr_matches_jax(tmp_path, records):
    """stdin2ss of 0 or 1 16-byte record through each CLI as a subprocess
    (where nothing captures a warning): equal stderr and .ss bytes.  A
    read-only view of 0 or 1 values once reached torch.from_numpy uncopied,
    and torch warned on stderr."""
    stream = tmp_path / "stream.bin"
    stream.write_bytes(np.random.default_rng(7).integers(
        0, 2**64, 2 * records, dtype=np.uint64).tobytes())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in os.environ.get("PYTHONPATH", "")
                             .split(os.pathsep) if p]))
    runs = {}
    for pkg, extra in (("bonsai_tpu", []),
                       ("bonsai_tpu_torch", ["--device", "cpu"])):
        d = tmp_path / pkg
        d.mkdir()
        proc = subprocess.run(
            [sys.executable, "-m", pkg, "stdin2ss", str(stream), "-o", "x.ss",
             *extra], cwd=d, env=env, capture_output=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        runs[pkg] = (proc.stdout, proc.stderr, (d / "x.ss").read_bytes())
    assert runs["bonsai_tpu_torch"] == runs["bonsai_tpu"]
    assert runs["bonsai_tpu"][1] == f"processed {records} total\n".encode()


def test_as_keys_of_a_read_only_array_does_not_warn():
    raw = np.arange(3, dtype=np.uint64).tobytes()
    for view in (np.frombuffer(raw, dtype=np.uint64)[0::2][:1],
                 np.frombuffer(raw, dtype=np.uint64)[:0],
                 np.frombuffer(raw, dtype=np.uint64)):
        assert not view.flags.writeable
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = as_keys(view, "cpu")
        assert got.tolist() == view.astype(np.int64).tolist()


def test_as_keys_shares_a_writable_array():
    a = np.arange(5, dtype=np.uint64)
    t = as_keys(a, "cpu")
    assert t.data_ptr() == a.ctypes.data
    a[2] = 41
    assert int(t[2]) == 41


def test_setsketchroller_matches_jax(tmp_path, inputs):
    _same_run(tmp_path, ["setsketchroller", *inputs["kmers"], "-o",
                         "roller.idx", "-k", "21"], "a")
    lst = tmp_path / "paths.txt"
    lst.write_text("\n".join(inputs["kmers"][1:]) + "\n")
    _same_run(tmp_path, ["setsketchroller", inputs["kmers"][0], "-F",
                         str(lst), "-o", "roller.idx", "-b"], "b")
    assert _run(cli.main, ["setsketchroller", "--device", "cpu"],
                tmp_path)[0] == 1


@pytest.mark.parametrize("flags", [["-k", "21"], ["-k", "31", "-C"],
                                   ["-k", "15"]])
def test_genome2multiset_matches_jax(tmp_path, flags):
    for i, p in enumerate(GOLDEN):
        _same_run(tmp_path, ["genome2multiset", p, *flags, "-o", "g2m"],
                  f"r{i}")


def test_errexp_matches_jax(tmp_path):
    out = _touch_nothing_run(tmp_path, ["errexp", "-l", "0.3", "--set-sizes",
                                        "10,12", "--sketch-sizes", "6,9"],
                             "errexp")
    lines = [x for x in out.splitlines() if not x.startswith("#")]
    assert len(lines) == 2 * 3 * 2  # set sizes x Jaccards x sketch sizes


@pytest.mark.parametrize("cmd", ["ssi-build", "setsketchindexer"])
@pytest.mark.parametrize("kind", ["packed", "continuous"])
def test_ssi_build_and_screen_match_jax(tmp_path, inputs, cmd, kind):
    """An index of the three genomes' sketches (packed by css2ss, or
    continuous, packed with one global (a, b) and its .params), screened
    with each sketch, the union and a packed sketch, both aliases."""
    if kind == "packed":
        sk = []
        for i, ss in enumerate(inputs["ss"] + [inputs["union"]]):
            out = str(tmp_path / f"p{i}.pss")
            assert _run(jcli.main, ["css2ss", ss, out], tmp_path)[0] == 0
            sk.append(out)
        sketches, queries = sk[:3], sk
    else:
        sketches = inputs["ss"]
        queries = inputs["ss"] + [inputs["union"]]
    for r in ("4", "2"):
        dt, _ = _same_run(tmp_path, [cmd, *sketches, "-o", "idx.ssi", "-r", r,
                                     "-k", "21"], f"b{r}")
        index = str(dt / "idx.ssi")
        screen = ("ssi-screen" if cmd == "ssi-build" else
                  "setsketchscreener")
        out = _touch_nothing_run(tmp_path, [screen, index, *queries, "-r", r,
                                            "-n", "2"], f"s{r}")
        assert len(out.splitlines()) == len(queries)
        first = out.splitlines()[0].split("\t")
        assert first[1].startswith("0:")  # genome 0 finds itself first
        assert os.path.exists(index + ".params") == (kind == "continuous")


def _registers(rng, n, m, bits):
    """n packed sketches of m registers, neighbours sharing most groups."""
    base = rng.integers(0, 1 << bits, m).astype(np.uint32)
    out = []
    for i in range(n):
        r = base.copy()
        flip = rng.random(m) < 0.05 * (i + 1)
        r[flip] = rng.integers(0, 1 << bits, int(flip.sum()))
        out.append(r)
    return out


@pytest.mark.parametrize("regs_per_hash", [1, 3, 4])
def test_set_sketch_index_matches_jax(tmp_path, regs_per_hash):
    rng = np.random.default_rng(regs_per_hash)
    regs = _registers(rng, 6, 1030, 16)  # 1030: a partial last group
    idx = [m.SetSketchIndex(k=31, regs_per_hash=regs_per_hash)
           for m in (jssi, ssi)]
    for r in regs[:4]:
        assert idx[0].add(r) == idx[1].add(r)
    assert idx[0].add(regs[4], 9) == idx[1].add(regs[4], 9) == 9
    assert idx[1].n_samples == 10
    for q in regs:
        np.testing.assert_array_equal(idx[1].query(q), idx[0].query(q))
        assert idx[1].topk(q, 3) == idx[0].topk(q, 3)
        assert idx[1].topk(q, 20) == idx[0].topk(q, 20)
    np.testing.assert_array_equal(ssi._group_keys(regs[0], regs_per_hash),
                                  jssi._group_keys(regs[0], regs_per_hash))
    for name in ("idx.ssi", "idx.ssi.gz"):
        pj, pt = str(tmp_path / f"j_{name}"), str(tmp_path / f"t_{name}")
        idx[0].write(pj)
        idx[1].write(pt)
        assert _content(pt) == _content(pj)
        back = ssi.SetSketchIndex.read(pj, regs_per_hash)
        assert back.map == idx[1].map and back.k == 31
        assert back.n_samples == idx[1].n_samples
    # merge, and build_index over SetSketch objects
    other = [m.SetSketchIndex(k=31, regs_per_hash=regs_per_hash)
             for m in (jssi, ssi)]
    for o in other:
        o.add(regs[5], 12)
    idx[0].merge(other[0])
    idx[1].merge(other[1])
    assert idx[1].map == idx[0].map and idx[1].n_samples == 13
    sk = [jss.SetSketch(r, 1.001, 1e-3, 16) for r in regs]
    from bonsai_tpu_torch.sketch.setsketch import SetSketch

    built = ssi.build_index([SetSketch(r, 1.001, 1e-3, 16) for r in regs],
                            k=5, regs_per_hash=regs_per_hash)
    want = jssi.build_index(sk, k=5, regs_per_hash=regs_per_hash)
    assert built.map == want.map and built.n_samples == want.n_samples


@pytest.mark.parametrize("chunk,p,canon", [(1000, 10, True), (2048, 12, False),
                                           (100_000, 14, True)])
def test_genome_chunker_profiles_match_jax(chunk, p, canon):
    for path in GOLDEN:
        want = jgchunk.GenomeChunker(path, chunk, JSpacer(21, 21), p, canon)
        got = gchunk.GenomeChunker(path, chunk, Spacer(21, 21), p, canon,
                                   device="cpu")
        assert len(got.contigs) == len(want.contigs)
        seen = []
        got.for_each(lambda cd: seen.append(cd.name))
        assert seen == [cd.name for cd in want.contigs]
        for g, w in zip(got.contigs, want.contigs):
            assert g.name == w.name and len(g.hlls) == len(w.hlls)
            np.testing.assert_array_equal(g.profile(), w.profile())
            for hg, hw in zip(g.hlls, w.hlls):
                np.testing.assert_array_equal(hg.registers, hw.registers)
