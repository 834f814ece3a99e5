"""Port parity: the incremental, checkpointed and on-card LCA build, on
the CPU.

The same numpy-seeded k-mer sets and the golden genomes go through the
JAX package (``bonsai_tpu/db/build.py``) and the port
(``bonsai_tpu_torch/db/build.py``):

* ``lca_fold_pairs`` on random pairs with 0s, taxids missing from the
  tree (poisoning, and a run of one missing taxid alone), disjoint roots
  and keys with bit 63 set;
* ``IncrementalLCABuilder`` against the batch fold
  (``tests/test_build_extras.py::test_incremental_matches_batch``), and
  a checkpoint written by one package and resumed by the other, both ways,
  to the content of one uninterrupted build;
* ``lca_map`` with ``checkpoint_path`` (a whole build, a build resumed
  from a checkpoint of its first genomes in either package,
  ``checkpoint_every_folds``), ``as_arrays``, ``input_type`` and
  ``use_device`` (on ``device="cpu"``: the plain versions of KB1 and KB4,
  which the card tests hold the kernels to), and ``taxdepth_map`` /
  ``ftct_map`` with ``input_type`` and ``use_device``;
* ``genome_kmer_set`` with ``input_type`` DNA and PROTEIN20, host and
  ``use_device``, and with a small ``block`` that splits each contig
  under ``-C -w`` (the column-0 drop of a non-final chunk), ``-w``, ``-S``
  and unwindowed;
* ``use_device=True`` on the default device raises without a card.

Tolerance: equal values (exact).
"""

import os

import numpy as np
import pytest
import torch

from bonsai_tpu.core.alphabet import InputType as JInputType
from bonsai_tpu.core.spacer import Spacer as JSpacer
from bonsai_tpu.db import build as jbuild
from bonsai_tpu.taxonomy.tree import TaxTree as JTree

from bonsai_tpu_torch.core.alphabet import InputType
from bonsai_tpu_torch.core.spacer import Spacer
from bonsai_tpu_torch.db import build as tbuild
from bonsai_tpu_torch.taxonomy.tree import TaxTree
from bonsai_tpu_torch.tools.synthetic import translate

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(__file__), "data")
GOLD = os.path.join(DATA, "golden")
NODES = os.path.join(GOLD, "nodes.dmp")
NAMEID = os.path.join(GOLD, "nameidmap.txt")
GENOMES = [os.path.join(GOLD, f) for f in ("g_phix.fa", "g_phixmut.fa",
                                           "g_rand.fa")]
# 11-13 under 2 under 1, and a second root 50 with 51 under it
PARENTS = {1: 0, 2: 1, 11: 2, 12: 2, 13: 1, 50: 0, 51: 50}


@pytest.fixture(scope="module")
def trees():
    return JTree(PARENTS), TaxTree(PARENTS)


def _kset(seed, n, top=1 << 14):
    """A genome's distinct k-mers: n draws below ``top``, so that the
    genomes share some."""
    return np.unique(np.random.default_rng(seed).integers(0, top, n,
                                                          dtype=np.uint64))


def _same(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lca_fold_pairs_matches_jax(trees, seed):
    """Pairs over a pool of keys (bit 63 set on some): in-tree taxids, 0s,
    taxids 777 and 888 missing from the tree, the second root's 51."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 20, 3000, dtype=np.uint64)
    pool[::7] |= np.uint64(1 << 63)
    keys = rng.choice(pool, 20_000)
    taxa = rng.choice(np.array([11, 12, 13, 2, 1, 0, 777, 888, 51, 50],
                               dtype=np.uint32), keys.size)
    # a run of one missing taxid alone keeps it; a run of 0s alone is 0
    keys = np.concatenate([keys, [5 << 40] * 3, [6 << 40] * 2,
                           [7 << 40, 7 << 40]]).astype(np.uint64)
    taxa = np.concatenate([taxa, [777] * 3, [0, 0], [11, 51]]).astype(np.uint32)
    want = jbuild.lca_fold_pairs(keys, taxa, trees[0])
    got = tbuild.lca_fold_pairs(keys, taxa, trees[1])
    _same(got, want)
    folded = dict(zip(got[0].tolist(), got[1].tolist()))
    assert folded[5 << 40] == 777 and folded[6 << 40] == 0
    assert folded[7 << 40] == 1  # disjoint roots
    assert (got[1] == 0xFFFFFFFF).any()
    # and the k-way merge of the same pairs as runs
    runs = [(np.unique(keys[taxa == t]), int(t)) for t in np.unique(taxa)]
    _same(tbuild.lca_fold_runs(np.zeros(0, np.uint64), np.zeros(0, np.uint32),
                               runs, trees[1]), want)


def test_lca_fold_pairs_of_distinct_and_empty_keys(trees):
    keys = np.array([9, 3, 5], dtype=np.uint64)
    taxa = np.array([11, 0, 777], dtype=np.uint32)
    _same(tbuild.lca_fold_pairs(keys, taxa, trees[1]),
          jbuild.lca_fold_pairs(keys, taxa, trees[0]))
    _same(tbuild.lca_fold_pairs(keys[:0], taxa[:0], trees[1]),
          jbuild.lca_fold_pairs(keys[:0], taxa[:0], trees[0]))


def test_incremental_matches_batch(trees):
    sets = {11: _kset(1, 5000), 12: _kset(2, 5000), 13: _kset(3, 5000)}
    keys = np.concatenate(list(sets.values()))
    taxa = np.concatenate([np.full(s.size, t, dtype=np.uint32)
                           for t, s in sets.items()])
    want = jbuild.lca_fold_pairs(keys, taxa, trees[0])
    for fold_every in (1, 2, 8):
        b = tbuild.IncrementalLCABuilder(trees[1], fold_every=fold_every)
        for t, s in sets.items():
            b.add_genome(f"g{t}", t, s)
        table = b.finish()
        _same((table.keys_sorted, table.vals_sorted), want)
    jb = jbuild.IncrementalLCABuilder(trees[0], fold_every=1)
    for t, s in sets.items():
        jb.add_genome(f"g{t}", t, s)
    _same(b.finish_arrays(), jb.finish_arrays())


GENOME_SETS = [(f"g{i}", 11 + (i % 3) if i != 4 else 51, _kset(10 + i, 2000))
               for i in range(7)]


@pytest.mark.parametrize("first,then", [("jax", "port"), ("port", "jax"),
                                        ("port", "port")])
def test_checkpoint_resumes_across_packages(trees, tmp_path, first, then):
    """A build of 3 genomes checkpointed by one package, resumed by the
    other: pending is the rest, and the content is one uninterrupted
    build's."""
    mods = {"jax": (jbuild, trees[0]), "port": (tbuild, trees[1])}
    ckpt = str(tmp_path / "build.ckpt.npz")
    m, tree = mods[first]
    b1 = m.IncrementalLCABuilder(tree, ckpt, fold_every=2)
    for p, t, s in GENOME_SETS[:3]:
        b1.add_genome(p, t, s)
    b1.save_checkpoint()
    assert not os.path.exists(ckpt + ".tmp.npz")
    m, tree = mods[then]
    b2 = m.IncrementalLCABuilder(tree, ckpt, fold_every=2)
    assert b2.pending([p for p, _, _ in GENOME_SETS]) == [
        p for p, _, _ in GENOME_SETS[3:]]
    for p, t, s in GENOME_SETS[3:]:
        b2.add_genome(p, t, s)
    got = b2.finish_arrays()
    whole = tbuild.IncrementalLCABuilder(trees[1])
    for p, t, s in GENOME_SETS:
        whole.add_genome(p, t, s)
    _same(got, whole.finish_arrays())
    jwhole = jbuild.IncrementalLCABuilder(trees[0])
    for p, t, s in GENOME_SETS:
        jwhole.add_genome(p, t, s)
    _same(got, jwhole.finish_arrays())
    assert (got[1] == 1).any()  # the second root's genome met another


def test_checkpoint_files_hold_the_same_arrays(trees, tmp_path):
    """The two packages' checkpoints of the same genomes hold equal keys,
    taxa and done (the zip bytes carry a time stamp)."""
    paths = {}
    for name, m, tree in (("jax", jbuild, trees[0]),
                          ("port", tbuild, trees[1])):
        paths[name] = str(tmp_path / f"{name}.npz")
        b = m.IncrementalLCABuilder(tree, paths[name], fold_every=2,
                                    checkpoint_every_folds=2)
        for p, t, s in GENOME_SETS:
            b.add_genome(p, t, s)
        # 7 genomes: folds after 2, 4, 6; a checkpoint after the 2nd fold
        with np.load(paths[name]) as z:
            assert [x.decode() for x in z["done"]] == [
                p for p, _, _ in GENOME_SETS[:4]]
        b.save_checkpoint()
    with np.load(paths["jax"]) as a, np.load(paths["port"]) as b:
        assert sorted(a.files) == sorted(b.files) == ["done", "keys", "taxa"]
        for f in a.files:
            assert a[f].dtype == b[f].dtype
            np.testing.assert_array_equal(a[f], b[f])


def _trees_from_dmp():
    return JTree.from_nodes_dmp(NODES), TaxTree.from_nodes_dmp(NODES)


@pytest.mark.parametrize("k,w,gaps,canon", [(21, 21, None, True),
                                            (21, 30, None, False)])
def test_lca_map_checkpoint_path(tmp_path, k, w, gaps, canon):
    """A whole build with a checkpoint, the same call again (every genome
    done), a build resumed from either package's checkpoint of its first
    two genomes, and ``as_arrays``: all the JAX lca_map's content."""
    jt, tt = _trees_from_dmp()
    want = jbuild.lca_map(GENOMES, jt, NAMEID, JSpacer(k, w, gaps), canon)
    want = (want.keys_sorted, want.vals_sorted)
    sp = Spacer(k, w, gaps)
    ck = str(tmp_path / "ck.npz")
    t1 = tbuild.lca_map(GENOMES, tt, NAMEID, sp, canon, checkpoint_path=ck)
    assert os.path.exists(ck)
    _same((t1.keys_sorted, t1.vals_sorted), want)
    t2 = tbuild.lca_map(GENOMES, tt, NAMEID, sp, canon, checkpoint_path=ck,
                        as_arrays=True)
    _same(t2, want)
    for who in ("jax", "port"):
        part = str(tmp_path / f"{who}_part.npz")
        if who == "jax":
            jbuild.lca_map(GENOMES[:2], jt, NAMEID, JSpacer(k, w, gaps), canon,
                           checkpoint_path=part)
        else:
            tbuild.lca_map(GENOMES[:2], tt, NAMEID, sp, canon,
                           checkpoint_path=part)
        got = tbuild.lca_map(GENOMES, tt, NAMEID, sp, canon,
                             checkpoint_path=part, as_arrays=True,
                             checkpoint_every_folds=2)
        _same(got, want)
        with np.load(part) as z:
            assert [p.decode() for p in z["done"]] == GENOMES
    # the port's finished checkpoint, resumed by the JAX package
    back = jbuild.lca_map(GENOMES, jt, NAMEID, JSpacer(k, w, gaps), canon,
                          checkpoint_path=ck, as_arrays=True)
    _same(back, want)


@pytest.fixture(scope="module")
def protein_genome(tmp_path_factory):
    """phiX's three forward frames as protein records."""
    from bonsai_tpu_torch.io import fastx

    seq = b"".join(s for _, s, _ in fastx.read_fastx(GENOMES[0]))
    path = tmp_path_factory.mktemp("prot") / "phix_frames.fa"
    path.write_bytes(b"".join(b">f%d\n%s\n" % (f, translate(seq, f))
                              for f in range(3)))
    return str(path)


@pytest.mark.parametrize("it,k,w,spacing,canon", [
    ("DNA", 31, 31, None, True),
    ("DNA", 21, 40, None, False),
    ("PROTEIN20", 7, 7, None, False),
    ("PROTEIN20", 7, 20, None, False),
    ("PROTEIN_14", 6, 6, [1] * 5, False),
])
def test_genome_kmer_set_input_types_match_jax(protein_genome, it, k, w,
                                               spacing, canon):
    path = GENOMES[0] if it == "DNA" else protein_genome
    want = jbuild.genome_kmer_set(path, JSpacer(k, w, spacing), canon,
                                  input_type=JInputType[it])
    sp = Spacer(k, w, spacing)
    host = tbuild.genome_kmer_set(path, sp, canon, input_type=InputType[it])
    dev = tbuild.genome_kmer_set(path, sp, canon, input_type=InputType[it],
                                 use_device=True, device="cpu")
    assert want.size > 100
    _same([host], [want])
    _same([dev], [want])


@pytest.mark.parametrize("k,w,spacing,canon,block", [
    (31, 40, None, False, 1000),  # -C -w: the column-0 drop
    (31, 40, None, False, 777),
    (31, 40, None, True, 1000),   # -w
    (21, 21, "0x16,1x4", False, 500),   # -S
    (21, 40, "0x16,1x4", False, 901),   # -S -w
    (25, 25, None, True, 300),    # unwindowed
])
def test_genome_kmer_set_small_blocks_match_jax(k, w, spacing, canon, block):
    """A block of a few hundred windows splits each contig into many
    chunks; host and ``use_device`` equal the JAX package at that block."""
    path = GENOMES[1]
    jsp = JSpacer(k, w, spacing)
    sp = Spacer(k, w, spacing)
    want = jbuild.genome_kmer_set(path, jsp, canon, block=block,
                                  use_device=False)
    if sp.unspaced() and sp.unwindowed():
        # the JAX host path ignores block there; its device path chunks
        want = jbuild.genome_kmer_set(path, jsp, canon, block=block,
                                      use_device=True)
    got = tbuild.genome_kmer_set(path, sp, canon, use_device=True,
                                 block=block, device="cpu")
    _same([got], [want])
    if not (sp.unspaced() and sp.unwindowed()):
        _same([tbuild.genome_kmer_set(path, sp, canon, block=block)], [want])
    whole = jbuild.genome_kmer_set(path, jsp, canon)
    # the chunks drop only trailing partial windows: a subset of the
    # contig's own emissions, all of them where there is no such window
    assert np.isin(got, whole).all()
    if canon or w == k:
        _same([got], [whole])


@pytest.mark.parametrize("which", ["taxdepth", "ftct"])
def test_phase1_maps_on_the_device_path_match_jax(which):
    jt, tt = _trees_from_dmp()
    jf = getattr(jbuild, f"{which}_map")
    tf = getattr(tbuild, f"{which}_map")
    want = jf(GENOMES, jt, NAMEID, JSpacer(25, 25), True)
    for use_device in (False, True):
        got = tf(GENOMES, tt, NAMEID, Spacer(25, 25), True,
                 input_type=InputType.DNA, use_device=use_device,
                 device="cpu")
        _same((got.keys_sorted, got.vals_sorted),
              (want.keys_sorted, want.vals_sorted))


def test_lca_map_on_the_device_path_matches_jax(protein_genome):
    jt, tt = _trees_from_dmp()
    want = jbuild.lca_map(GENOMES, jt, NAMEID, JSpacer(31, 31))
    got = tbuild.lca_map(GENOMES, tt, NAMEID, Spacer(31, 31), use_device=True,
                         device="cpu", block=2000)
    _same((got.keys_sorted, got.vals_sorted),
          (want.keys_sorted, want.vals_sorted))
    # another input type through lca_map: the frames as one genome
    name = {"f0": 101}
    want = jbuild.lca_map([protein_genome], jt, name, JSpacer(7, 7), False,
                          input_type=JInputType.PROTEIN20, as_arrays=True)
    got = tbuild.lca_map([protein_genome], tt, name, Spacer(7, 7), False,
                         input_type=InputType.PROTEIN20, use_device=True,
                         device="cpu", as_arrays=True)
    _same(got, want)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_use_device_on_the_default_device_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        tbuild.genome_kmer_set(GENOMES[0], Spacer(31, 31), use_device=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbuild.lca_map(GENOMES, TaxTree.from_nodes_dmp(NODES), NAMEID,
                       Spacer(31, 31), use_device=True)
