"""Port parity: ``bonsai_tpu_torch/metatree/`` and the ``metatree``
subcommand, on the CPU.

``KmerGenomeSets`` (each genome's set from KB1's plain version through
``genome_kmer_set(use_device=True, device="cpu")``), ``bitmap_patterns``
(T = 3, 64 and 70 sets, an owner on bit 63, keys with bit 63 set,
``drop_trivial`` off), ``pairwise_veccmp`` (whole and in blocks of rows),
``adjacency``, ``score_node_addn``, ``FMEmitter``'s records and text
(``simulate`` data, and maps with tied scores), ``TaxonomyReformation``
and ``simulate``'s files are held to the JAX package's; the subcommand
runs through both CLIs (``--device cpu`` for the port) on ``simulate``
data with -n, -L, -C, -F and with no genome mapped (exit 1).

Tolerance: exact equality (integer and text work).
"""

import io
import os

import numpy as np
import pytest

from bonsai_tpu.core.spacer import Spacer as JSpacer
from bonsai_tpu.metatree import bitsets as jbits
from bonsai_tpu.metatree import flextree as jflex
from bonsai_tpu.metatree import sim as jsim
from bonsai_tpu.metatree.tx import TaxonomyReformation as JReformation
from bonsai_tpu.taxonomy.tree import TaxTree as JTaxTree

from bonsai_tpu_torch.core.spacer import Spacer
from bonsai_tpu_torch.metatree import bitsets, flextree, sim
from bonsai_tpu_torch.metatree.tx import TaxonomyReformation
from bonsai_tpu_torch.taxonomy.tree import TaxTree
from test_torch_index_tools import same_run


@pytest.fixture(scope="module")
def sim_data(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("simgenomes"))
    return sim.simulate(out, n_parents=2, leaves_per_parent=4, block=400,
                        cross_pairs=((0, 1), (2, 3)))


# -- bitsets -------------------------------------------------------------------

def _sets(rng, T):
    """T sets of distinct keys: each key of a pool of 3000 (a third with
    bit 63 set) goes to the sets of one of 12 patterns (among them one
    set, all T sets and, where T > 63, set 63)."""
    pats = [rng.random(T) < rng.uniform(0.2, 0.8) for _ in range(9)]
    one, every = np.zeros(T, bool), np.ones(T, bool)
    one[T // 2] = True
    pats += [one, every, np.arange(T) % 2 == 1]
    pool = rng.choice(1 << 62, 3000, replace=False).astype(np.uint64)
    pool[::3] |= np.uint64(1 << 63)
    which = rng.integers(0, len(pats), pool.size)
    return [np.sort(pool[np.array([pats[w][t] for w in which])])
            for t in range(T)]


def _kgs(cls, sets, **attrs):
    kgs = cls.__new__(cls)
    kgs.taxes, kgs.sets = list(range(len(sets))), sets
    kgs.__dict__.update(attrs)
    return kgs


@pytest.mark.parametrize("T", [3, 64, 70])
@pytest.mark.parametrize("drop_trivial", [True, False])
def test_bitmap_patterns_match_jax(T, drop_trivial):
    sets = _sets(np.random.default_rng(T), T)
    want = jbits.bitmap_patterns(_kgs(jbits.KmerGenomeSets, sets),
                                 drop_trivial)
    got = bitsets.bitmap_patterns(
        _kgs(bitsets.KmerGenomeSets, sets, device="cpu"), drop_trivial)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[0].shape[0] >= 3 and got[1].max() > 1
    if T > 63:
        assert (got[0][:, 0] >> np.uint64(63)).any()


def test_bitmap_patterns_empty():
    """No set, and sets whose k-mers are all trivial, give no pattern;
    where every set is empty the JAX package's vec_popcnt raises on its
    (0, 1) rows, and the port gives no pattern."""
    for sets in ([], [np.array([5], np.uint64), np.array([6], np.uint64)]):
        want = jbits.bitmap_patterns(_kgs(jbits.KmerGenomeSets, sets))
        got = bitsets.bitmap_patterns(
            _kgs(bitsets.KmerGenomeSets, sets, device="cpu"))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.size == 0
    sets = [np.zeros(0, np.uint64)] * 2
    with pytest.raises(ValueError):
        jbits.bitmap_patterns(_kgs(jbits.KmerGenomeSets, sets))
    pats, counts = bitsets.bitmap_patterns(
        _kgs(bitsets.KmerGenomeSets, sets, device="cpu"))
    assert pats.shape == (0, 1) and counts.shape == (0,)


@pytest.mark.parametrize("canon", [True, False])
@pytest.mark.parametrize("filtered", [False, True])
def test_kmer_genome_sets_match_jax(sim_data, canon, filtered):
    """Per-taxon sets (one taxon with two genomes) and the acceptable
    filter."""
    _, _, t2p = sim_data
    tp = {100: t2p[100] + t2p[101], 102: t2p[102], 104: t2p[104]}
    acceptable = None
    if filtered:
        every = np.unique(np.concatenate([
            jbits.build_mod.genome_kmer_set(p, JSpacer(21, 21), canon)
            for ps in tp.values() for p in ps]))
        rng = np.random.default_rng(3)
        acceptable = np.sort(rng.choice(every, every.size // 3,
                                        replace=False))
    want = jbits.KmerGenomeSets(tp, JSpacer(21, 21), canon, acceptable)
    got = bitsets.KmerGenomeSets(tp, Spacer(21, 21), canon, acceptable,
                                 device="cpu")
    assert got.taxes == want.taxes and got.size() == want.size() == 3
    assert got.weight() == want.weight() > 0
    for g, w in zip(got.sets, want.sets):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _nested(rng, P, W):
    base = rng.integers(0, 2**63, (P // 2, W), dtype=np.uint64)
    base[::4, -1] |= np.uint64(1 << 63)
    sub = base & rng.integers(0, 2**63, (P // 2, W), dtype=np.uint64)
    pats = np.concatenate([base, sub, base[:2]])  # nested, and equal rows
    return pats[rng.permutation(pats.shape[0])]


@pytest.mark.parametrize("block", [False, True])
def test_pairwise_adjacency_score_match_jax(monkeypatch, block):
    rng = np.random.default_rng(7)
    pats = _nested(rng, 40, 2)
    if block:  # rows of 3 a block
        monkeypatch.setattr(bitsets, "PAIRWISE_BYTES", 3 * 8 * 42 * 2)
    want = jbits.pairwise_veccmp(pats)
    got = bitsets.pairwise_veccmp(pats, "cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert (got[0] & ~got[1]).any()
    counts = rng.integers(1, 50, pats.shape[0])
    for reverse in (False, True):
        adj = bitsets.adjacency(pats, reverse, "cpu")
        jadj = jbits.adjacency(pats, reverse)
        assert all(np.array_equal(a, b) for a, b in zip(adj, jadj))
        for i in range(pats.shape[0]):
            assert bitsets.score_node_addn(i, adj, pats, counts, 128) == \
                jbits.score_node_addn(i, jadj, pats, counts, 128)
    assert np.array_equal(bitsets.vec_popcnt(pats), jbits.vec_popcnt(pats))
    for i in range(0, 40, 7):
        for j in range(0, 40, 3):
            assert bitsets.veccmp(pats[i], pats[j]) == jbits.veccmp(
                pats[i], pats[j])
    empty = np.zeros((0, 1), np.uint64)
    assert bitsets.pairwise_veccmp(empty, "cpu")[0].shape == (0, 0)


# -- flextree, tx, sim ---------------------------------------------------------

def _emit(mod, tree, t2p, pm, device, **kw):
    fme = mod.FMEmitter(tree, t2p, **kw, **device)
    for parent in (10, 11):
        taxes = sorted(t for t in t2p if pm[t] == parent)
        assert fme.process_subtree(parent, taxes, (
            JSpacer if mod is jflex else Spacer)(31, 31))
    buf = io.StringIO()
    return fme.run_collapse(max(pm), buf), buf.getvalue()


@pytest.mark.parametrize("kw", [dict(to_add=4), dict(to_add=40),
                                dict(to_add=40, condense=False),
                                dict(canonicalize=False, to_add=24,
                                     max_heap_size=5)])
def test_fmemitter_matches_jax(sim_data, kw):
    """Records and text; with to_add = 40 every candidate is emitted, the
    junction patterns' small scores among them, tied."""
    pm, _, t2p = sim_data
    want = _emit(jflex, JTaxTree(pm), t2p, pm, {}, **kw)
    got = _emit(flextree, TaxTree(pm), t2p, pm, dict(device="cpu"), **kw)
    assert got == want
    scores = [r["score"] for r in got[0]]
    if kw["to_add"] == 40:
        assert len(scores) > len(set(scores))  # ties
    assert (10, [100, 101]) in [(r["parent"], r["children"])
                                for r in got[0][:4]]


def test_run_collapse_ties_match_jax():
    """Maps whose nodes tie on score: the stable sort and the row order
    decide which is emitted."""
    def maps(mod, FNode):
        out = []
        for sid in range(3):
            fm = mod.FlexMap.__new__(mod.FlexMap)
            fm.parent, fm.bitcount, fm.id = 10 + sid, 4, sid
            fm.taxes, fm.n = [100 + 4 * sid + i for i in range(4)], 0
            fm.nodes = [FNode(pattern=np.array([p], np.uint64), n=n, pc=pc,
                              bc=4, subtree=sid)
                        for p, n, pc in ((3, 6, 2), (5, 6, 2), (12, 4, 2),
                                         (7, 12, 3), (6, 12, 2))]
            out.append(fm)
        return out

    texts = []
    for mod in (jflex, flextree):
        fme = mod.FMEmitter.__new__(mod.FMEmitter)
        fme.subtrees = maps(mod, mod.FNode)
        fme.left_to_add, fme.max_heap_size = 11, 4
        buf = io.StringIO()
        texts.append((fme.run_collapse(50, buf), buf.getvalue()))
    assert texts[0] == texts[1]


def test_roundup64_and_fnode():
    for x in (1, 2, 5, 8, 9, 64, 65):
        assert flextree.roundup64(x) == jflex.roundup64(x)
    a = flextree.FNode(pattern=np.array([7], np.uint64), n=10, pc=3, bc=4,
                       subtree=0)
    b = flextree.FNode(pattern=np.array([3], np.uint64), n=5, pc=2, bc=4,
                       subtree=0)
    a.subsume(b)
    assert (a.score(), b.score()) == (15, 5)


def test_reformation_matches_jax(sim_data, tmp_path):
    """Multi-genome taxa split into synthetic leaves, renumbering by
    depth, the maps and write_mapping's text; an unmapped genome skipped,
    or a KeyError with panic_on_undef."""
    pm, nm, t2p = sim_data
    paths = [p for ps in t2p.values() for p in ps]
    stray = tmp_path / "stray.fa"
    stray.write_text(">nobody\nACGT\n")
    nm = dict(nm, leaf_101=100, leaf_106=104, leaf_107=104)
    paths.append(str(stray))
    jt = JReformation(nm, paths, JTaxTree(pm))
    tt = TaxonomyReformation(nm, paths, TaxTree(pm))
    for name in ("newid_path_map", "old_to_new", "new_to_old",
                 "name_map_new", "path_map_new"):
        assert getattr(tt, name) == getattr(jt, name), name
    assert tt.new_tree.parent_map == jt.new_tree.parent_map
    assert len(tt.newid_path_map) == 5
    assert tt.taxid_of(104) == jt.taxid_of(104)
    assert tt.old_id(3) == jt.old_id(3)
    bj, bt = io.StringIO(), io.StringIO()
    jt.write_mapping(bj)
    tt.write_mapping(bt)
    assert bt.getvalue() == bj.getvalue()
    for cls, tree in ((JReformation, JTaxTree(pm)),
                      (TaxonomyReformation, TaxTree(pm))):
        with pytest.raises(KeyError):
            cls(nm, paths, tree, panic_on_undef=True)


def test_simulate_same_files(tmp_path):
    kw = dict(n_parents=3, leaves_per_parent=3, block=250, seed=5,
              cross_pairs=((0, 1), (1, 2)))
    want = jsim.simulate(str(tmp_path / "j"), **kw)
    got = sim.simulate(str(tmp_path / "t"), **kw)
    assert got[:2] == want[:2]
    assert sorted(got[2]) == sorted(want[2])
    for t in want[2]:
        (pj,), (pt,) = want[2][t], got[2][t]
        assert os.path.basename(pj) == os.path.basename(pt)
        assert open(pj, "rb").read() == open(pt, "rb").read()


# -- the subcommand ------------------------------------------------------------

@pytest.fixture(scope="module")
def sim_cli(sim_data, tmp_path_factory):
    pm, nm, t2p = sim_data
    d = tmp_path_factory.mktemp("simcli")
    nodes, nim = d / "nodes.dmp", d / "nameid.txt"
    nodes.write_text("".join(f"{t}\t|\t{p}\t|\n" for t, p in pm.items()))
    nim.write_text("".join(f"{n}\t{t}\n" for n, t in nm.items()))
    paths = [p for ps in t2p.values() for p in ps]
    (d / "paths.txt").write_text("\n".join(paths) + "\n")
    return str(nodes), str(nim), paths, str(d / "paths.txt")


@pytest.mark.parametrize("flags", [["-n", "2"], ["-n", "6", "-L", "10"],
                                   ["-n", "5", "-C", "-k", "21"], []])
def test_cli_metatree_matches_jax(tmp_path, sim_cli, flags):
    nodes, nim, paths, _ = sim_cli
    _, text = same_run(tmp_path, ["metatree", nodes, nim, *paths, *flags])
    assert text.startswith("#Taxid (inserted)")


def test_cli_metatree_paths_file_and_out(tmp_path, sim_cli):
    nodes, nim, _, listing = sim_cli
    d, _ = same_run(tmp_path, ["metatree", nodes, nim, "-F", listing, "-n",
                               "3", "-o", "mt.tsv"])
    assert len(open(d / "mt.tsv").read().splitlines()) == 4


def test_cli_metatree_no_genome_mapped(tmp_path, sim_cli):
    """No genome under the accepted LCA, or no genome at all: exit 1."""
    nodes, nim, paths, _ = sim_cli
    _, text = same_run(tmp_path, ["metatree", nodes, nim, *paths, "-L",
                                  "12"], rc=1)
    assert text == ""
    same_run(tmp_path, ["metatree", nodes, nim], "none", rc=1)
