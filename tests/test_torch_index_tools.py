"""Port parity: the taxonomy's host helpers, ``db/kmeridx.py`` and the
index and taxonomy subcommands (hist, lca, taxmap, fahist, kmeridx), on
the CPU.

``TaxTree``'s lca, lca_pairs, lca_reduce, resolve_tree_host,
node_depth, is_ancestor, original, invert, descendants and len are held
to the JAX tree's on random trees whose root's parent is 0 or itself,
with a second root (disjoint roots) and taxa that appear only as
parents, on random pairs that include 0, equal taxids and missing
taxids.  ``KmerIdx`` (KB1's plain version on ``device="cpu"``) is held
to the JAX index on random contigs with N runs, IUPAC codes, lowercase
bases, contigs shorter than k and empty ones, at k = 1, 4, 21, 31 and
32 (keys with bit 63 set), whole and in chunks of a few windows; its
files are read by the other package both ways.  Each subcommand runs
through ``bonsai_tpu.cli.main`` and the port's ``cli.main`` (with
``--device cpu`` where it takes one) in two empty directories: exit
code, stdout, stderr and every file written must be equal (a gzip file,
told by its magic, after gunzip: gzip stamps a time in its header).

Tolerance: exact equality (integer and text work).
"""

import gzip
import os

import numpy as np
import pytest

from bonsai_tpu import cli as jcli
from bonsai_tpu.db.kmeridx import KmerIdx as JKmerIdx
from bonsai_tpu.taxonomy.tree import TaxTree as JTaxTree

from bonsai_tpu_torch import cli
from bonsai_tpu_torch.db import kmeridx
from bonsai_tpu_torch.db.kmeridx import KmerIdx
from bonsai_tpu_torch.taxonomy.tree import TaxTree
from test_torch_sketch_tools import _run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
GOLD = os.path.join(DATA, "golden")
GOLDEN = [os.path.join(GOLD, f) for f in ("g_phix.fa", "g_phixmut.fa",
                                         "g_rand.fa")]


def content(path):
    """A file's bytes, gunzipped where it starts with gzip's magic."""
    with open(path, "rb") as fh:
        gz = fh.read(2) == b"\x1f\x8b"
    with (gzip.open if gz else open)(path, "rb") as fh:
        return fh.read()


def same_run(tmp_path, argv, name="run", device=True, rc=0):
    """Both CLIs on ``argv`` (the port's with --device cpu where
    ``device``) in empty directories: codes, text and every file equal;
    returns (port's directory, its stdout)."""
    dj, dt = tmp_path / f"{name}_jax", tmp_path / f"{name}_torch"
    dj.mkdir()
    dt.mkdir()
    want = _run(jcli.main, argv, dj)
    got = _run(cli.main, argv + (["--device", "cpu"] if device else []), dt)
    assert got[0] == want[0] == rc, (got[2], want[2])
    assert got[1].replace(str(dt), "D") == want[1].replace(str(dj), "D")
    assert got[2].replace(str(dt), "D") == want[2].replace(str(dj), "D")
    files = sorted(os.listdir(dj))
    assert sorted(os.listdir(dt)) == files
    for f in files:
        assert content(str(dt / f)) == content(str(dj / f)), f
    return dt, got[1]


# -- TaxTree's host helpers ----------------------------------------------------

def _random_tree(rng, n, root_parent):
    """{taxid: parent}: root 1 (parent ``root_parent``), n random taxa
    under it, a second root 7 (parent 0) with a few, and a taxon that is
    only a parent (999999999, a root of its own)."""
    ids = rng.choice(np.arange(8, 10**6), n, replace=False).tolist()
    pm = {1: root_parent, 7: 0}
    placed = [1]
    for t in ids[: n - 4]:
        pm[t] = int(rng.choice(placed))
        placed.append(t)
    for t in ids[n - 4 : n - 1]:
        pm[t] = 7
    pm[ids[-1]] = 999999999
    return pm


def _pairs(rng, pm, m):
    present = np.array(sorted(set(pm) | {p for p in pm.values() if p}))
    missing = np.array([2, 3, 4, 5, 10**6 + 1, 0xFFFFFFFE])
    pool = np.concatenate([present, missing, [0]]).astype(np.int64)
    a = rng.choice(pool, m)
    b = rng.choice(pool, m)
    b[: m // 8] = a[: m // 8]  # equal taxids
    b[m // 8 : m // 4] = 0
    a[m // 4 : m // 4 + 8] = 7  # disjoint roots
    b[m // 4 : m // 4 + 4] = 1
    return a, b


@pytest.mark.parametrize("root_parent", [0, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_taxtree_host_helpers_match_jax(root_parent, seed):
    """lca() corners (lca(a, a) = a, lca(x, 0) = x, a missing taxid ->
    0xFFFFFFFF, disjoint roots -> 1), lca_pairs' precedence, and the other
    helpers, on a root whose parent is 0 (as simulate() writes) or itself
    (as a nodes.dmp holds it before parsing)."""
    rng = np.random.default_rng(100 * seed + root_parent)
    pm = _random_tree(rng, 300, root_parent)
    jt, tt = JTaxTree(pm), TaxTree(pm)
    a, b = _pairs(rng, pm, 400)
    got = [tt.lca(int(x), int(y)) for x, y in zip(a, b)]
    want = [jt.lca(int(x), int(y)) for x, y in zip(a, b)]
    assert got == want
    assert 0xFFFFFFFF in want and 1 in want
    assert np.array_equal(tt.lca_pairs(a, b), jt.lca_pairs(a, b))
    assert tt.lca_pairs(a, b).dtype == np.uint32
    assert np.array_equal(tt.lca_pairs(a, b), np.array(want, np.uint32))
    for i in range(0, 400, 37):
        seq = [int(x) for x in a[i : i + 5]]
        assert tt.lca_reduce(seq) == jt.lca_reduce(seq)
    assert tt.lca_reduce([]) == jt.lca_reduce([]) == 0
    assert np.array_equal(tt.is_ancestor(a, b), jt.is_ancestor(a, b))
    c = np.arange(len(tt.tax_ids) + 1)
    assert np.array_equal(tt.original(c), jt.original(c))
    for t in list(pm)[:50] + [999999999]:
        assert tt.node_depth(t) == jt.node_depth(t)
        assert tt._compact_scalar(t) == jt._compact_scalar(t)
        if t != root_parent:  # a self-parent is its own descendant, forever
            assert tt.descendants(t) == jt.descendants(t)
    assert tt.node_depth(0) == jt.node_depth(0)
    for f in (tt.node_depth, jt.node_depth):
        with pytest.raises(KeyError):
            f(3)
    assert tt.invert() == jt.invert()
    assert len(tt) == len(jt) == len(pm)
    if root_parent == 0:  # nor does the walk to the root end there
        for _ in range(30):
            hits = {int(t): int(rng.integers(1, 4)) for t in
                    rng.choice(list(pm), int(rng.integers(1, 6)))}
            assert tt.resolve_tree_host(hits) == jt.resolve_tree_host(hits)
        ties = {t: 1 for t in list(pm)[2:6]}
        assert tt.resolve_tree_host(ties) == jt.resolve_tree_host(ties)


def test_taxtree_nodes_dmp_self_parent_root():
    """ec_nodes.dmp's root is its own parent: both trees parse it to 1 -> 0
    and answer the same."""
    g = os.path.join(GOLD, "ec_nodes.dmp")
    jt, tt = JTaxTree.from_nodes_dmp(g), TaxTree.from_nodes_dmp(g)
    ids = [0, 1, 2, 11, 12, 13, 14, 15, 99]
    for x in ids:
        for y in ids:
            assert tt.lca(x, y) == jt.lca(x, y)
    assert tt.lca_reduce([11, 12, 13]) == 2
    assert tt.resolve_tree_host({11: 2, 12: 2}) == jt.resolve_tree_host(
        {11: 2, 12: 2}) == 2
    assert tt.descendants(2) == jt.descendants(2)


# -- KmerIdx -------------------------------------------------------------------

def _contigs(rng, n=6):
    """(name, seq): N runs, IUPAC codes, lowercase bases, a contig shorter
    than most k, an empty one."""
    out = []
    for i in range(n):
        L = int(rng.integers(40, 400))
        s = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), L)
        for _ in range(int(rng.integers(0, 4))):
            at = int(rng.integers(0, L))
            s[at : at + int(rng.integers(1, 40))] = ord("N")
        iu = rng.random(L) < 0.01
        s[iu] = rng.choice(np.frombuffer(b"RYKMSWn", np.uint8), int(iu.sum()))
        out.append((b"c%d" % i, s.tobytes()))
    out.insert(2, (b"short", b"ACGTAC"))
    out.insert(4, (b"empty", b""))
    return out


def _write_fa(path, contigs):
    with open(path, "wb") as fh:
        for name, seq in contigs:
            fh.write(b">" + name + b" some comment\n" + seq + b"\n")


def _same_idx(got, want):
    assert np.array_equal(got.keys, want.keys)
    assert got.keys.dtype == want.keys.dtype == np.uint64
    assert np.array_equal(got.offsets, want.offsets)
    assert got.offsets.dtype == want.offsets.dtype
    assert np.array_equal(got.positions, want.positions)
    assert got.positions.dtype == want.positions.dtype
    assert got.refnames == want.refnames and got.comments == want.comments
    assert [int(x) for x in got.seqlens] == [int(x) for x in want.seqlens]
    assert got._cum == want._cum and len(got) == len(want)


@pytest.mark.parametrize("k", [1, 4, 21, 31, 32])
@pytest.mark.parametrize("block", [None, 5])
def test_kmeridx_matches_jax(tmp_path, monkeypatch, k, block):
    """keys, offsets, positions, get and contig_of of KB1's plain version
    (whole contigs, or chunks of 5 windows with a k - 1 halo), then a
    second add_seq after finalize folded in."""
    rng = np.random.default_rng(k)
    contigs = _contigs(rng)
    fa = tmp_path / "g.fa"
    _write_fa(fa, contigs)
    want = JKmerIdx(k, str(fa))
    if block is None:
        got = KmerIdx(k, str(fa), device="cpu")
    else:
        monkeypatch.setattr(kmeridx, "BLOCK", block)
        got = KmerIdx(k, device="cpu")
        for name, seq in contigs:
            got.add_seq(name, seq)
        got.finalize()
    _same_idx(got, want)
    assert len(got) > 0
    if k == 32:
        assert (got.keys >> np.uint64(63)).any()
    probe = list(got.keys[:: max(1, len(got) // 20)]) + [0, 2**64 - 1, 12345]
    for km in probe:
        g, w = got.get(int(km)), want.get(int(km))
        assert g.dtype == w.dtype and np.array_equal(g, w)
    total = int(sum(len(s) for _, s in contigs))
    for gpos in [0, 1, 5, 6, 7, total - 1] + list(
            rng.integers(0, total, 20)):
        assert got.contig_of(int(gpos)) == want.contig_of(int(gpos))
    more = [(b"more", contigs[0][1] + b"ACGT" * 20), (b"tiny", b"A")]
    for name, seq in more:
        got.add_seq(name, seq, b"c")
        want.add_seq(name, seq, b"c")
    got.finalize()
    want.finalize()
    _same_idx(got, want)


def test_kmeridx_empty_and_short(tmp_path):
    """Only contigs shorter than k (nothing pending) and only N windows
    (pending but empty)."""
    for contigs in ([(b"a", b"ACG"), (b"b", b"")],
                    [(b"n", b"N" * 50), (b"x", b"ACGTNACGT")]):
        got, want = KmerIdx(8, device="cpu"), JKmerIdx(8)
        for name, seq in contigs:
            got.add_seq(name, seq)
            want.add_seq(name, seq)
        got.finalize()
        want.finalize()
        _same_idx(got, want)
        got.write(str(tmp_path / "p.kidx"))
        want.write(str(tmp_path / "j.kidx"))
        assert content(tmp_path / "p.kidx") == content(tmp_path / "j.kidx")
        _same_idx(KmerIdx.read(str(tmp_path / "j.kidx"), device="cpu"),
                  JKmerIdx.read(str(tmp_path / "j.kidx")))


@pytest.mark.parametrize("k", [4, 32])
def test_kmeridx_files_both_ways(tmp_path, k):
    """The port's file decompresses to the JAX writer's bytes; each
    package reads the other's file to the same index."""
    rng = np.random.default_rng(50 + k)
    fa = tmp_path / "g.fa"
    _write_fa(fa, _contigs(rng, 4))
    got, want = KmerIdx(k, str(fa), device="cpu"), JKmerIdx(k, str(fa))
    got.write(str(tmp_path / "p.kidx"))
    want.write(str(tmp_path / "j.kidx"))
    assert content(tmp_path / "p.kidx") == content(tmp_path / "j.kidx")
    assert open(tmp_path / "p.kidx", "rb").read(2) == b"\x1f\x8b"
    _same_idx(JKmerIdx.read(str(tmp_path / "p.kidx")), want)
    _same_idx(KmerIdx.read(str(tmp_path / "j.kidx"), device="cpu"), want)


def test_kmeridx_default_device_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KmerIdx(31)
    with pytest.raises(ValueError, match="k must be <= 32"):
        KmerIdx(33, device="cpu")


# -- the subcommands -----------------------------------------------------------

@pytest.fixture(scope="module")
def golden_dbs(tmp_path_factory):
    """The JAX CLI's builds of the golden genomes: a file, a --shards 2
    directory and a --bonsai-format (khash) file."""
    d = tmp_path_factory.mktemp("dbs")
    base = ["-k", "21", "-T", os.path.join(GOLD, "nodes.dmp"), "-M",
            os.path.join(GOLD, "nameidmap.txt")]
    out = {}
    for name, flags in (("file", []), ("sharded", ["--shards", "2"]),
                        ("khash", ["--bonsai-format"])):
        p = str(d / f"{name}.db")
        assert _run(jcli.main, ["build", p, *GOLDEN, *base, *flags],
                    d)[0] == 0
        out[name] = p
    assert os.path.isdir(out["sharded"])
    return out


@pytest.mark.parametrize("which", ["file", "sharded", "khash"])
def test_cli_hist_matches_jax(tmp_path, golden_dbs, which):
    _, text = same_run(tmp_path, ["hist", golden_dbs[which]])
    assert text.startswith("Name\tCount\n") and len(text.splitlines()) > 2
    same_run(tmp_path, ["hist", golden_dbs[which], "h.tsv"], "out")


@pytest.mark.parametrize("taxids", [["11", "12", "13"], ["11", "99"],
                                    ["13", "0"], ["12"], ["14", "15", "1"]])
def test_cli_lca_matches_jax(tmp_path, taxids):
    _, text = same_run(tmp_path, ["lca", os.path.join(GOLD, "ec_nodes.dmp"),
                                  *taxids], device=False)
    if taxids == ["11", "99"]:
        assert text == "4294967295\n"


def test_cli_taxmap_matches_jax(tmp_path):
    d, _ = same_run(tmp_path, ["taxmap", os.path.join(GOLD,
                                                      "ec_nameidmap.txt"),
                               "names.json"], device=False)
    assert os.path.getsize(d / "names.json") > 0


@pytest.mark.parametrize("out", [False, True])
def test_cli_fahist_matches_jax(tmp_path, out):
    paths = GOLDEN + [os.path.join(DATA, "phix.fa"),
                      os.path.join(GOLD, "mate1.fa")]
    argv = ["fahist", *paths] + (["-o", "h.txt"] if out else [])
    _, text = same_run(tmp_path, argv, device=False)
    assert bool(text) != out


@pytest.mark.parametrize("k", ["21", "32"])
def test_cli_kmeridx_matches_jax(tmp_path, k):
    """kmeridx's stderr and its file (after gunzip, by magic: -o .kidx)."""
    rng = np.random.default_rng(int(k))
    fa = tmp_path / "g.fa"
    _write_fa(fa, _contigs(rng) + [(b"phix", open(GOLDEN[0], "rb").read()
                                    .split(b"\n", 1)[1].replace(b"\n", b""))])
    d, _ = same_run(tmp_path, ["kmeridx", str(fa), "-k", k, "-o", "x.kidx"])
    assert open(d / "x.kidx", "rb").read(2) == b"\x1f\x8b"
