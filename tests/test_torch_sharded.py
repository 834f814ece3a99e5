"""Port parity: the sharded classifier (``bonsai_tpu_torch/parallel/``) on
the CPU against the JAX package's ``ShardedClassifier`` on the virtual
8-device CPU mesh and against its one-device ``Classifier``.

The data is ``tests/test_sharded.py``'s ``setup``: 96 reads of 80-199
bases with 2% Ns, a k = 17 database of 60% of their canonical k-mers
over six taxa.  The port's ranks share the CPU in one process; the JAX
references are made once a module.  Covered: the a2a route at (dp, db) =
(1, 2), (2, 2), (1, 4), (2, 3) and the psum route at (2, 2), (1, 4) (the
raw 6-tuple), the Kraken text of ``process_dataset``, paired reads,
capacity overflow (cf 0.05, several rounds), queries equal to the
frame's U64_MAX pad key, stored or not, ``gather_rows_per_step``,
``from_sharded_dir`` at group 1 and 2 and its merge fall-through, the
dictionary layout, ``bake_rank_images`` (the .npy files equal the JAX
package's) and its fingerprint (stale images ignored, where the JAX
loader serves them), ``HashShardedTable.arrays_np``, a taxid past 2^31,
spaced seeds and the mesh's collectives.  Tolerance: equal values and
equal bytes.
"""

import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from bonsai_tpu.classify.pipeline import Classifier as JClassifier
from bonsai_tpu.core import bitops as jbitops
from bonsai_tpu.core import encode as jenc
from bonsai_tpu.core.alphabet import DNA4
from bonsai_tpu.db import formats as jformats
from bonsai_tpu.db import table as jtable
from bonsai_tpu.io import fastx as jfastx
from bonsai_tpu.parallel import sharded as jsharded
from bonsai_tpu.parallel.mesh import make_mesh as jmesh
from bonsai_tpu.taxonomy.tree import TaxTree as JTree

from bonsai_tpu_torch.classify import output as out_mod
from bonsai_tpu_torch.db import formats as tformats
from bonsai_tpu_torch.db import table as ttable
from bonsai_tpu_torch.io import fastx
from bonsai_tpu_torch.parallel import sharded
from bonsai_tpu_torch.parallel.mesh import default_mesh, make_mesh
from bonsai_tpu_torch.taxonomy.tree import TaxTree

from conftest import random_dna

K = 17
TAXONOMY = {1: 0, 2: 1, 3: 1, 11: 2, 12: 2, 13: 3}
A2A = [(1, 2), (2, 2), (1, 4), (2, 3)]
PSUM = [(2, 2), (1, 4)]


def _dbs(keys, taxa, k=K, gaps=None):
    gaps = [0] * (k - 1) if gaps is None else gaps
    return (jformats.Database(table=jtable.KmerTable(keys, taxa), k=k, w=k,
                              gaps=gaps),
            tformats.Database(table=ttable.KmerTable(keys, taxa), k=k, w=k,
                              gaps=gaps))


@pytest.fixture(scope="module")
def ref():
    """The data, both packages' databases and trees, and the JAX
    references: the one-device full result and text, and each split's
    raw sharded step."""
    rng = np.random.default_rng(0)
    reads = [random_dna(rng, int(rng.integers(80, 200)), 0.02)
             for _ in range(96)]
    lut = DNA4.lut
    kms = []
    for r in reads:
        codes = lut[np.frombuffer(r, dtype=np.uint8)][None]
        km, inv = jenc.pack_kmers(codes, K)
        kms.append(jbitops.canonical(km[~inv], K))
    allk = np.unique(np.concatenate(kms))
    pick = allk[rng.random(len(allk)) < 0.6]
    taxa = rng.choice([1, 2, 3, 11, 12, 13], size=len(pick)).astype(np.uint32)
    jdb, tdb = _dbs(pick, taxa)
    jtree, ttree = JTree(TAXONOMY), TaxTree(TAXONOMY)
    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), -1, dtype=np.int8)
    lengths = np.array([len(r) for r in reads], dtype=np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = lut[np.frombuffer(r, dtype=np.uint8)]
    batch = jfastx.ReadBatch(names=[f"r{i}".encode() for i in range(96)],
                             seqs=reads, codes=codes, lengths=lengths,
                             quals=None)
    single = JClassifier(jdb, jtree, emit_all=True)
    full = single.classify_batch(batch, full=True)
    steps = {}
    for route, splits in (("a2a", A2A), ("psum", PSUM)):
        for dp, db in splits:
            sc = jsharded.ShardedClassifier(jdb, jtree,
                                            jmesh({"dp": dp, "db": db}),
                                            route=route)
            steps[route, dp, db] = [np.asarray(x)
                                    for x in sc.step(codes, lengths)]
    return dict(reads=reads, pick=pick, taxa=taxa, jdb=jdb, tdb=tdb,
                jtree=jtree, ttree=ttree, codes=codes, lengths=lengths,
                full=full, steps=steps, single=single)


def _tbatch(ref, n=None):
    n = len(ref["reads"]) if n is None else n
    return fastx.ReadBatch(names=[f"r{i}".encode() for i in range(n)],
                           seqs=ref["reads"][:n], codes=ref["codes"][:n],
                           lengths=ref["lengths"][:n], quals=None)


def _check_step(got, want):
    assert len(got) == 6
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g.astype(np.int64), np.asarray(w).astype(
            np.int64))


@pytest.mark.parametrize("route,dp,db", [("a2a", *s) for s in A2A]
                         + [("psum", *s) for s in PSUM])
def test_raw_step_matches_jax(ref, route, dp, db):
    sc = sharded.ShardedClassifier(ref["tdb"], ref["ttree"],
                                   make_mesh({"dp": dp, "db": db}, ["cpu"]),
                                   route=route)
    got = sc.step(ref["codes"], ref["lengths"])
    _check_step(got, ref["steps"][route, dp, db])
    full = ref["full"]
    assert np.array_equal(got[0], full.taxon)
    assert np.array_equal(got[2], full.hit_mask)
    assert np.array_equal(got[1][got[2]], full.taxa[full.hit_mask])
    if route == "a2a":
        assert sc.last_rounds == 1


@pytest.mark.parametrize("route,dp,db", [("a2a", 2, 2), ("a2a", 1, 3),
                                         ("psum", 2, 2)])
def test_process_dataset_text_matches_jax(ref, tmp_path, route, dp, db):
    fa = tmp_path / "r.fa"
    with open(fa, "w") as fh:
        for i, r in enumerate(ref["reads"]):
            fh.write(f">q{i}\n{r.decode()}\n")
    want = io.StringIO()
    JClassifier(ref["jdb"], ref["jtree"], emit_all=True).process_dataset(
        str(fa), want, batch_size=40)
    sc = sharded.ShardedClassifier(ref["tdb"], ref["ttree"],
                                   make_mesh({"dp": dp, "db": db}, ["cpu"]),
                                   route=route, emit_all=True)
    got = io.StringIO()
    sc.process_dataset(str(fa), got, batch_size=40)
    assert got.getvalue() == want.getvalue()
    assert sc.n_classified == sum(
        1 for line in want.getvalue().splitlines() if line.startswith("C"))


@pytest.mark.parametrize("route", ["a2a", "psum"])
def test_paired_reads_match_jax(ref, route):
    n = 96
    jb = jfastx.ReadBatch(names=[b""] * n, seqs=[b""] * n,
                          codes=ref["codes"], lengths=ref["lengths"],
                          quals=None)
    want = ref["single"].classify_batch(jb, paired=True, full=True)
    sc = sharded.ShardedClassifier(ref["tdb"], ref["ttree"],
                                   make_mesh({"dp": 2, "db": 2}, ["cpu"]), route=route)
    res = sc.classify_batch(_tbatch(ref), paired=True, full=True)
    for f in ("taxon", "n_missing", "n_kmers", "n_kmers1"):
        assert np.array_equal(getattr(res, f), getattr(want, f)), f
    assert np.array_equal(res.taxa[res.hit_mask], want.taxa[want.hit_mask])
    raw = sc.step(ref["codes"], ref["lengths"], paired=True)
    assert np.array_equal(raw[0], want.taxon)
    assert np.array_equal(raw[5], want.n_kmers1)


def test_overflow_rounds_match_jax(ref):
    """Homopolymer reads send every k-mer of a read to one owner; at cf
    0.05 the route takes several rounds and stays exact (the JAX package's
    test_a2a_skew_overflow_rounds)."""
    reads = [bytes([c]) * 120 for c in b"ACGT" for _ in range(8)]
    codes = np.stack([DNA4.lut[np.frombuffer(r, np.uint8)] for r in reads
                      ]).astype(np.int8)
    codes = np.concatenate([codes, ref["codes"][:32, :120]])
    lengths = np.concatenate([np.full(32, 120, np.int32),
                              np.minimum(ref["lengths"][:32], 120)])
    jb = jfastx.ReadBatch(names=[b""] * 64, seqs=[], codes=codes,
                          lengths=lengths, quals=None)
    want = ref["single"].classify_batch(jb, full=True)
    jsc = jsharded.ShardedClassifier(ref["jdb"], ref["jtree"],
                                     jmesh({"dp": 2, "db": 4}), route="a2a",
                                     capacity_factor=0.05)
    jstep = [np.asarray(x) for x in jsc.step(codes, lengths)]
    sc = sharded.ShardedClassifier(ref["tdb"], ref["ttree"],
                                   make_mesh({"dp": 2, "db": 4}, ["cpu"]),
                                   route="a2a", capacity_factor=0.05)
    got = sc.step(codes, lengths)
    _check_step(got, jstep)
    assert np.array_equal(got[0], want.taxon)
    assert sc.last_rounds > 1


def test_gather_rows_per_step_matches_jax(ref):
    for route, dp, db in (("a2a", 4, 2), ("a2a", 2, 4), ("a2a", 1, 8),
                          ("psum", 2, 4), ("a2a", 2, 3)):
        for cf in (1.05, 0.3):
            j = jsharded.ShardedClassifier(ref["jdb"], ref["jtree"],
                                           jmesh({"dp": dp, "db": db}),
                                           route=route, capacity_factor=cf)
            t = sharded.ShardedClassifier(ref["tdb"], ref["ttree"],
                                          make_mesh({"dp": dp, "db": db}, ["cpu"]),
                                          route=route, capacity_factor=cf)
            for n, L, rounds in ((96, 199, 1), (8192, 101, 3), (5, 10, 1)):
                assert (t.gather_rows_per_step(n, L, rounds)
                        == j.gather_rows_per_step(n, L, rounds))


@pytest.mark.parametrize("db,group", [(4, 1), (2, 2), (3, None)])
def test_from_sharded_dir_matches_jax(ref, tmp_path, db, group):
    """A --shards 4 directory: one file a rank (db 4), two (db 2), and a
    split that does not divide (db 3: merge-loaded)."""
    d = str(tmp_path / "sh")
    tformats.save_database_sharded(ref["tdb"], d, 4, device="cpu")
    mesh = make_mesh({"dp": 1, "db": db}, ["cpu"])
    loaded = []
    real = tformats.read_database_arrays

    def counting(path):
        loaded.append(os.path.basename(path))
        return real(path)

    tformats.read_database_arrays = counting
    try:
        sc = sharded.ShardedClassifier.from_sharded_dir(d, ref["ttree"], mesh)
    finally:
        tformats.read_database_arrays = real
    assert sc._rank_images_used is False
    assert sorted(loaded) == [f"shard-{s:05d}.btpu" for s in range(4)]
    got = sc.step(ref["codes"], ref["lengths"])
    full = ref["full"]
    assert np.array_equal(got[0], full.taxon)
    assert np.array_equal(got[2], full.hit_mask)
    assert np.array_equal(got[3], full.n_missing)
    assert np.array_equal(got[1][got[2]], full.taxa[full.hit_mask])


def test_from_sharded_dir_dictionary_layout(ref, tmp_path):
    """The directory's recorded dictionary gives the inline layout and the
    dictionary compact output, byte-identical to the one-device text."""
    d = str(tmp_path / "shd")
    tformats.save_database_sharded(ref["tdb"], d, 4, device="cpu")
    sc = sharded.ShardedClassifier.from_sharded_dir(
        d, ref["ttree"], make_mesh({"dp": 2, "db": 4}, ["cpu"]))
    assert sc._inline and sc._uniq_host is not None
    assert sc._n_distinct == 6
    sc.max_runs = 256  # run-rich reads: keep the compact output
    batch = _tbatch(ref)
    res = sc._finish_batch(batch, sc._dispatch_batch(batch))
    assert res.compact
    single = ref["single"]
    jb = jfastx.ReadBatch(names=batch.names, seqs=batch.seqs,
                          codes=batch.codes, lengths=batch.lengths, quals=None)
    want = single.classify_batch(jb, full=True)
    assert out_mod.format_batch(res, K, emit_all=True) == \
        out_mod.format_batch(want, K, emit_all=True)


def test_from_sharded_dir_without_a_dictionary(ref, tmp_path):
    """An older directory with no uniq_vals: flat values, _n_distinct
    None (K2's dedup rule takes it), still exact."""
    d = str(tmp_path / "old")
    tformats.save_database_sharded(ref["tdb"], d, 4, device="cpu")
    mf = json.load(open(os.path.join(d, "manifest.json")))
    os.unlink(os.path.join(d, mf.pop("uniq_vals")))
    del mf["nb"]
    json.dump(mf, open(os.path.join(d, "manifest.json"), "w"))
    sc = sharded.ShardedClassifier.from_sharded_dir(
        d, ref["ttree"], make_mesh({"dp": 1, "db": 4}, ["cpu"]))
    assert not sc._inline and sc._n_distinct is None
    got = sc.step(ref["codes"], ref["lengths"])
    assert np.array_equal(got[0], ref["full"].taxon)
    assert np.array_equal(got[2], ref["full"].hit_mask)


def _npys(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.endswith(".npy")}


@pytest.mark.parametrize("ranks", [0, 2])
@pytest.mark.parametrize("dictionary", [True, False])
def test_bake_rank_images_match_jax(ref, tmp_path, ranks, dictionary):
    d = str(tmp_path / "sh")
    tformats.save_database_sharded(ref["tdb"], d, 4, device="cpu")
    if not dictionary:  # flat values: slot and value files
        mf = json.load(open(os.path.join(d, "manifest.json")))
        os.unlink(os.path.join(d, mf.pop("uniq_vals")))
        json.dump(mf, open(os.path.join(d, "manifest.json"), "w"))
    dj = str(tmp_path / "shj")
    shutil.copytree(d, dj)
    ti = sharded.bake_rank_images(d, ref["ttree"], ranks)
    ji = jsharded.bake_rank_images(dj, ref["jtree"], ranks)
    assert os.path.basename(ti) == os.path.basename(ji)
    got, want = _npys(ti), _npys(ji)
    assert got == want and len(got) == (ranks or 4) * (1 if dictionary else 2)
    meta = json.load(open(os.path.join(ti, "meta.json")))
    assert meta["fingerprint"] == sharded.fingerprint(
        d, json.load(open(os.path.join(d, "manifest.json"))))
    sc = sharded.ShardedClassifier.from_sharded_dir(
        d, ref["ttree"], make_mesh({"dp": 1, "db": ranks or 4}, ["cpu"]))
    assert sc._rank_images_used
    got = sc.step(ref["codes"], ref["lengths"])
    assert np.array_equal(got[0], ref["full"].taxon)
    assert np.array_equal(got[2], ref["full"].hit_mask)


def test_stale_rank_images_are_ignored(ref, tmp_path):
    """Shards rebuilt in place from another database: the port ignores the
    images baked from the old shards and classifies against the new ones
    (the JAX loader takes the stale images: ADVICE r5); a shard touched in
    place invalidates them too; baking again makes them current."""
    d = str(tmp_path / "sh")
    tformats.save_database_sharded(ref["tdb"], d, 4, device="cpu")
    sharded.bake_rank_images(d, ref["ttree"], 4)
    jsharded.bake_rank_images(d, ref["jtree"], 4)  # the JAX loader's meta
    rng = np.random.default_rng(5)
    keep = rng.random(ref["pick"].size) < 0.5
    keys2, taxa2 = ref["pick"][keep], ref["taxa"][keep]
    jdb2, tdb2 = _dbs(keys2, taxa2)
    tformats.save_database_sharded(tdb2, d, 4, device="cpu")
    jb = jfastx.ReadBatch(names=[b""] * 96, seqs=[], codes=ref["codes"],
                          lengths=ref["lengths"], quals=None)
    want = JClassifier(jdb2, ref["jtree"]).classify_batch(jb, full=True)
    mesh = make_mesh({"dp": 1, "db": 4}, ["cpu"])
    sc = sharded.ShardedClassifier.from_sharded_dir(d, ref["ttree"], mesh)
    assert not sc._rank_images_used
    got = sc.step(ref["codes"], ref["lengths"])
    assert np.array_equal(got[0], want.taxon)
    assert np.array_equal(got[2], want.hit_mask)
    sharded.bake_rank_images(d, ref["ttree"], 4)
    assert sharded.ShardedClassifier.from_sharded_dir(
        d, ref["ttree"], mesh)._rank_images_used
    p = os.path.join(d, "shard-00002.btpu")
    st = os.stat(p)
    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    sc = sharded.ShardedClassifier.from_sharded_dir(d, ref["ttree"], mesh)
    assert not sc._rank_images_used
    assert np.array_equal(sc.step(ref["codes"], ref["lengths"])[0],
                          want.taxon)


@pytest.mark.parametrize("ndb", [1, 3, 4])
def test_hash_sharded_table_arrays_match_jax(ref, ndb):
    jt, tt = ref["jdb"].table, ref["tdb"].table
    packed = tformats.packed_values(tt, ref["ttree"])
    want = jtable.HashShardedTable(jt, ndb)
    got = ttable.HashShardedTable(tt, ndb, "cpu")
    assert (got.nb, got.lgnb, got.vbits) == (want.nb, want.lgnb, want.vbits)
    for vals in (packed, np.arange(tt.n, dtype=np.uint64) * np.uint64(7)):
        g, w = got.arrays_np(vals), want.arrays_np(vals)
        assert g[2] == w[2]
        assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


def test_a_taxid_past_2_31(ref):
    """The response word carries the original taxid in its high 32 bits:
    a taxid >= 2^31 comes back whole through both routes, in the raw step
    and in the dictionary compact output."""
    big = {1: 0, 2: 1, 3_000_000_000: 1, 4_000_000_001: 3_000_000_000}
    taxa = np.where(ref["taxa"] % 2 == 0, 3_000_000_000,
                    4_000_000_001).astype(np.uint32)
    jdb, tdb = _dbs(ref["pick"], taxa)
    jtree, ttree = JTree(big), TaxTree(big)
    jb = jfastx.ReadBatch(names=[f"r{i}".encode() for i in range(96)],
                          seqs=ref["reads"], codes=ref["codes"],
                          lengths=ref["lengths"], quals=None)
    single = JClassifier(jdb, jtree, emit_all=True)
    want = single.classify_batch(jb, full=True)
    assert int(want.taxon.max()) >= 1 << 31
    want_txt = out_mod.format_batch(want, K, emit_all=True)
    for route, dp, db in (("a2a", 1, 4), ("psum", 2, 2)):
        sc = sharded.ShardedClassifier(tdb, ttree,
                                       make_mesh({"dp": dp, "db": db}, ["cpu"]),
                                       route=route, emit_all=True)
        got = sc.step(ref["codes"], ref["lengths"])
        assert np.array_equal(got[0], want.taxon)
        assert np.array_equal(got[1][got[2]], want.taxa[want.hit_mask])
        sc.max_runs = 256
        res = sc.classify_batch(_tbatch(ref))
        assert res.compact
        assert out_mod.format_batch(res, K, emit_all=True) == want_txt


@pytest.mark.parametrize("trial", range(3))
def test_fuzz_against_jax(trial):
    """Random k, lengths, Ns, split, cf and canonicalization (trial 2: a
    spaced seed), as the JAX package's test_a2a_fuzz_vs_single."""
    from bonsai_tpu.core.encoder import BatchEncoder
    from bonsai_tpu.core.spacer import Spacer

    rng = np.random.default_rng(100 + trial)
    k = int(rng.choice([13, 19, 23, 29]))
    canon = bool(rng.integers(0, 2))
    gaps = [0] * (k - 1)
    if trial == 2:
        gaps[int(rng.integers(0, k - 1))] = 2
        canon = False
    c = k + sum(gaps)
    reads = [random_dna(rng, int(rng.integers(c + 1, 150)), 0.03)
             for _ in range(48)]
    L = max(len(r) for r in reads)
    codes = np.full((48, L), -1, dtype=np.int8)
    lengths = np.array([len(r) for r in reads], dtype=np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = DNA4.lut[np.frombuffer(r, dtype=np.uint8)]
    em = BatchEncoder(Spacer(k, k, gaps), canon, "lex").emissions(codes,
                                                                  lengths)
    pool = np.unique(np.asarray(em.values)[np.asarray(em.mask)])
    keys = np.sort(pool[rng.random(len(pool)) < 0.5])
    taxa = rng.choice([1, 2, 3, 11, 12, 13], size=len(keys)).astype(np.uint32)
    jdb, tdb = _dbs(keys, taxa, k, gaps)
    jb = jfastx.ReadBatch(names=[b""] * 48, seqs=[], codes=codes,
                          lengths=lengths, quals=None)
    want = JClassifier(jdb, JTree(TAXONOMY), canonicalize=canon
                       ).classify_batch(jb, full=True)
    dp, db = [(4, 2), (2, 4), (1, 8), (2, 3)][int(rng.integers(0, 4))]
    cf = float(rng.choice([0.1, 0.5, 1.25]))
    for route in ("a2a", "psum"):
        sc = sharded.ShardedClassifier(tdb, TaxTree(TAXONOMY),
                                       make_mesh({"dp": dp, "db": db}, ["cpu"]),
                                       canonicalize=canon, route=route,
                                       capacity_factor=cf)
        got = sc.step(codes, lengths)
        assert np.array_equal(got[0], want.taxon)
        assert np.array_equal(got[2], want.hit_mask)
        assert np.array_equal(got[3], want.n_missing)
        assert np.array_equal(got[4], want.n_kmers)


@pytest.mark.parametrize("dp,db", [(1, 2), (1, 4)])
@pytest.mark.parametrize("stored", [True, False])
def test_a_query_equal_to_the_pad_key_matches_jax(dp, db, stored):
    """The a2a frame pads its unused rows with U64_MAX, and a real query
    can be that key: at k = 32 without canonicalization the all-T 32-mer
    packs to it.  Reads with runs of 32 T's and more, a database that
    stores that k-mer (or lacks it), capacity factor 0.05 (several
    rounds): the raw step equals the JAX ShardedClassifier's, and the
    all-T positions hit exactly where the database stores the k-mer."""
    from bonsai_tpu.core.encoder import BatchEncoder
    from bonsai_tpu.core.spacer import Spacer

    k = 32
    rng = np.random.default_rng(32)
    reads = [random_dna(rng, int(rng.integers(10, 40)), 0.02)
             + b"T" * int(rng.integers(32, 60))
             + random_dna(rng, int(rng.integers(10, 40)), 0.02)
             for _ in range(24)] + [random_dna(rng, 90, 0.02)
                                    for _ in range(8)]
    L = max(len(r) for r in reads)
    codes = np.full((len(reads), L), -1, dtype=np.int8)
    lengths = np.array([len(r) for r in reads], dtype=np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = DNA4.lut[np.frombuffer(r, dtype=np.uint8)]
    em = BatchEncoder(Spacer(k, k), False, "lex").emissions(codes, lengths)
    vals, mask = np.asarray(em.values), np.asarray(em.mask)
    all_t = mask & (vals == np.uint64(2**64 - 1))
    assert all_t.sum() >= 24 * 1
    pool = np.unique(vals[mask])
    keys = pool[(rng.random(len(pool)) < 0.5) & (pool != np.uint64(2**64 - 1))]
    if stored:
        keys = np.append(keys, np.uint64(2**64 - 1))
    keys = np.sort(keys)
    taxa = rng.choice([1, 2, 3, 11, 12, 13], size=len(keys)).astype(np.uint32)
    jdb, tdb = _dbs(keys, taxa, k)
    jsc = jsharded.ShardedClassifier(jdb, JTree(TAXONOMY),
                                     jmesh({"dp": dp, "db": db}),
                                     canonicalize=False, route="a2a",
                                     capacity_factor=0.05)
    want = [np.asarray(x) for x in jsc.step(codes, lengths)]
    sc = sharded.ShardedClassifier(tdb, TaxTree(TAXONOMY),
                                   make_mesh({"dp": dp, "db": db}, ["cpu"]),
                                   canonicalize=False, route="a2a",
                                   capacity_factor=0.05)
    got = sc.step(codes, lengths)
    _check_step(got, want)
    assert sc.last_rounds > 1
    hit = got[2]
    assert hit.shape == all_t.shape
    assert bool(hit[all_t].all()) if stored else not bool(hit[all_t].any())


def test_tiny_and_empty_batches(ref):
    """Fewer queries than owners (the JAX package's output), and reads
    with no k-mer at all (P = 0, where the JAX classifier cannot reduce):
    no round, nothing classified."""
    sc = sharded.ShardedClassifier(ref["tdb"], ref["ttree"],
                                   make_mesh({"dp": 1, "db": 4}, ["cpu"]))
    for L, n in ((K, 4), (K + 2, 8), (K - 1, 4)):
        codes = np.ascontiguousarray(ref["codes"][:n, :L])
        lengths = np.minimum(ref["lengths"][:n], L).astype(np.int32)
        got = sc.step(codes, lengths)
        assert got[2].shape == (n, max(L - K + 1, 0))
        if L < K:
            assert sc.last_rounds == 0
            assert not got[0].any() and not got[4].any()
            continue
        jb = jfastx.ReadBatch(names=[b""] * n, seqs=[], codes=codes,
                              lengths=lengths, quals=None)
        want = ref["single"].classify_batch(jb, full=True)
        assert np.array_equal(got[0], want.taxon)
        assert np.array_equal(got[2], want.hit_mask)


def test_mesh_collectives_and_errors():
    mesh = make_mesh({"dp": 2, "db": 3}, ["cpu"])
    assert mesh.coords(4) == {"dp": 1, "db": 1}
    x = {r: torch.arange(6) + 10 * r for r in range(6)}
    y = mesh.all_to_all(x)
    # rank (1, 1) gets block 1 of ranks 3, 4, 5
    assert y[4].tolist() == [32, 33, 42, 43, 52, 53]
    s = mesh.psum({r: torch.tensor(r) for r in range(6)})
    assert [int(s[r]) for r in range(6)] == [3, 3, 3, 12, 12, 12]
    s = mesh.psum({r: torch.tensor(r) for r in range(6)}, ("dp", "db"))
    assert {int(v) for v in s.values()} == {15}
    sp = make_mesh({"sp": 4}, ["cpu"])
    p = sp.ppermute({r: torch.tensor([r]) for r in range(4)},
                    [(i, (i - 1) % 4) for i in range(4)])
    assert [int(p[r]) for r in range(4)] == [1, 2, 3, 0]
    with pytest.raises(ValueError, match="1 devices not divisible by "
                                         "db_shards=4"):
        default_mesh(n_devices=1, db_shards=4, device="cpu")
    assert default_mesh(db_shards=3, device="cpu").shape == {"dp": 1, "db": 3}
    _, tdb = _dbs(np.arange(1, 6, dtype=np.uint64), np.full(5, 2, np.uint32))
    sc = sharded.ShardedClassifier(tdb, TaxTree(TAXONOMY),
                                   make_mesh({"db": 4}, ["cpu"]))
    with pytest.raises(ValueError, match="multiple of 4"):
        sc.step(np.zeros((6, 30), np.int8), np.full(6, 30, np.int32))


def test_mesh_defaults_to_the_card_where_there_is_one():
    # entry points run on the card unless the caller asks for the CPU
    mesh = make_mesh({"dp": 1, "db": 2})
    want = "cuda" if torch.cuda.is_available() else "cpu"
    assert [mesh.device(r).type for r in range(2)] == [want, want]
    assert make_mesh({"db": 2}, ["cpu"]).device(1) == torch.device("cpu")


def test_a2a_places_each_shard_once(ref, monkeypatch):
    # the classifier's images are the shards HashShardedTable placed to
    # agree on nb, not a second placement of each
    placed = []
    real = ttable.KmerTable

    class Counting(real):
        def __init__(self, keys, vals, *a, **kw):
            placed.append(len(keys))
            super().__init__(keys, vals, *a, **kw)

    monkeypatch.setattr(ttable, "KmerTable", Counting)
    sc = sharded.ShardedClassifier(ref["tdb"], ref["ttree"],
                                   make_mesh({"dp": 1, "db": 4}, ["cpu"]),
                                   route="a2a")
    assert len(placed) == 4 and sum(placed) == ref["tdb"].table.n
    _check_step(sc.step(ref["codes"], ref["lengths"]),
                ref["steps"]["a2a", 1, 4])


def test_a2a_images_after_a_bucket_growth(ref, monkeypatch):
    # shard 0 needs twice the buckets once: every shard is placed again at
    # the grown nb, and the images uploaded are those of the last round
    real = ttable.KmerTable
    grown = []

    class GrowOnce(real):
        def __init__(self, keys, vals, load_factor=ttable.MAX_LOAD,
                     min_nb=0):
            if min_nb and not grown:
                grown.append(min_nb)
                min_nb *= 2
            super().__init__(keys, vals, load_factor, min_nb)

    monkeypatch.setattr(ttable, "KmerTable", GrowOnce)
    sc = sharded.ShardedClassifier(ref["tdb"], ref["ttree"],
                                   make_mesh({"dp": 1, "db": 4}, ["cpu"]),
                                   route="a2a")
    nb = 2 * grown[0]
    assert sc.lgnb == nb.bit_length() - 1
    assert all(sc._arr[r].slots.shape[0] == nb for r in range(4))
    _check_step(sc.step(ref["codes"], ref["lengths"]),
                ref["steps"]["a2a", 1, 4])
