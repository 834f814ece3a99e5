"""Port parity: the hash-scored phase 2 of ``build -t/-f --phase1-db``.

``ScoreMap.lookup_scores`` of the port against the JAX package's, on
numpy queries and on CPU tensors (the plain version of KB5), with inline
and flat probe images (a flat one has more distinct values than the slot
index field holds), found and missing keys, the poly-A k-mer 0 and
U64_MAX.  ``BatchEncoder(scheme="hash")`` against the JAX encoder on the
three windowed disciplines (canonical, ``-C -w``, spaced) at k of 21, 31
and 32 and windows of 2, 13 and 16, on rows with Ns, a poly-A run, rows
shorter than the span, P < W, rows none of whose k-mers phase 1 holds
and an all-N row.  The phase-1 table is carried across from the JAX
``KmerTable``'s ``keys_sorted`` / ``vals_sorted``.  Then ``minimized_map``
and ``device_minimized_map(device="cpu")`` against the JAX
``minimized_map`` at the shape of ``tests/test_build_device.py``'s phase-2
test (k = 19, w = 36), after -t and -f phase 1, also where phase 1 lacks
a genome, and ``classify`` against a phase-2 database through both CLIs.
Tolerance: exact equality, since all of it is integer work.
"""

import json
import os

import numpy as np
import pytest
import torch

import bonsai_tpu  # noqa: F401  (enables jax x64)
from bonsai_tpu.cli import main as jmain
from bonsai_tpu.core.encoder import BatchEncoder as JEncoder
from bonsai_tpu.core.spacer import Spacer as JSpacer
from bonsai_tpu.db import build as jbuild
from bonsai_tpu.db.table import KmerTable as JTable
from bonsai_tpu.db.table import ScoreMap as JScoreMap
from bonsai_tpu.taxonomy.tree import TaxTree as JTree

from bonsai_tpu_torch import cli
from bonsai_tpu_torch.core.encoder import BatchEncoder, minimizers_plain
from bonsai_tpu_torch.core.spacer import Spacer, parse_spacing
from bonsai_tpu_torch.db import build as tbuild
from bonsai_tpu_torch.db import build_device as bd
from bonsai_tpu_torch.db.formats import load_database
from bonsai_tpu_torch.db.table import KmerTable, ScoreMap, lookup_scores
from bonsai_tpu_torch.taxonomy.tree import TaxTree

from conftest import random_dna

torch.set_num_threads(1)
U64_MAX = np.uint64(2**64 - 1)
GOLD = os.path.join(os.path.dirname(__file__), "data", "golden")
MANIFEST = json.load(open(os.path.join(GOLD, "manifest.json")))
GENOMES = [os.path.join(GOLD, f) for f in ("g_phix.fa", "g_phixmut.fa",
                                           "g_rand.fa")]
NODES = os.path.join(GOLD, "nodes.dmp")
NAMEID = os.path.join(GOLD, "nameidmap.txt")
PARENTS = {1: 0, 2: 1, 3: 1, 11: 2, 12: 2, 13: 3}


def u64(t):
    return t.numpy().view(np.uint64)


def t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def phase1_values(rng, n, mode):
    """Packed phase-1 values: TDencode-like with 5 taxa (inline), or all
    distinct (flat)."""
    if mode == "flat":
        return (np.uint64(7) << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    depth = rng.integers(0, 4, n).astype(np.uint64)
    taxa = rng.choice(np.array([1, 2, 11, 12, 13], np.uint64), n)
    return ((np.uint64(0xFFFFFFFF) - depth) << np.uint64(32)) | taxa


def tables(keys, rng, mode):
    """The JAX phase-1 table and the port's, carried across from its sorted
    key and value arrays."""
    keys = np.unique(np.asarray(keys, dtype=np.uint64))
    # inline: 2^10 buckets at least, so that the slot's 8-bit index field
    # holds the 20 values; flat: the fewest buckets, whose field holds
    # fewer values than the keys have
    jt = JTable(keys, phase1_values(rng, keys.size, mode),
                min_nb=1 << 10 if mode == "inline" else 0)
    tt = KmerTable(jt.keys_sorted, jt.vals_sorted, min_nb=jt.nb)
    assert tt.nb == jt.nb
    assert tt.arrays_np()[2] == (mode == "inline")
    return jt, tt


# -- ScoreMap.lookup_scores ------------------------------------------------------

@pytest.mark.parametrize("mode", ["inline", "flat"])
@pytest.mark.parametrize("edges_stored", [True, False])
def test_lookup_scores_matches_jax(mode, edges_stored):
    """Half the queries stored; 0 and U64_MAX stored or not."""
    rng = np.random.default_rng(1 + edges_stored)
    keys = rng.integers(0, 2**64, 5000, dtype=np.uint64)
    if edges_stored:
        keys = np.concatenate([keys, np.array([0, U64_MAX], np.uint64)])
    jt, tt = tables(keys, rng, mode)
    q = np.concatenate([rng.choice(jt.keys_sorted, 3000),
                        rng.integers(0, 2**64, 3000, dtype=np.uint64),
                        np.array([0, U64_MAX, 0], np.uint64)])
    want = JScoreMap(jt).lookup_scores(q)
    smap = ScoreMap(tt)
    got = smap.lookup_scores(q)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(u64(smap.lookup_scores(t64(q))), want)
    np.testing.assert_array_equal(u64(lookup_scores(t64(q), smap.arrays("cpu"))),
                                  want)
    assert (want[-3:] != U64_MAX).all() == edges_stored
    assert (want == U64_MAX).sum() >= 2900


def test_score_map_uploads_once():
    rng = np.random.default_rng(3)
    _, tt = tables(rng.integers(0, 2**64, 100, dtype=np.uint64), rng, "inline")
    smap = ScoreMap(tt)
    assert smap.arrays("cpu") is smap.arrays(torch.device("cpu"))


# -- BatchEncoder(scheme="hash") -------------------------------------------------

DISCIPLINES = {  # name -> (canonicalize, spaced)
    "canonical": (True, False),
    "uncanonical": (False, False),
    "spaced": (False, True),
}


def hash_rows(rng, c, W, B=20, L=150):
    """int8 codes (B, L), -1 for N and padding, and lengths: 2% Ns, a
    poly-A run (the k-mer 0), a row of T (k = 32: U64_MAX), an all-N row,
    rows shorter than the span, rows with fewer than W valid seeds, and
    the last two rows fresh bases (their k-mers are left out of phase 1)."""
    L = max(L, c + W + 8)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.02] = -1
    lengths = rng.integers(c, L + 1, B).astype(np.int32)
    codes[0, 10 : 10 + c + 2 * W] = 0
    lengths[0] = L
    codes[1] = 3
    lengths[1] = L
    codes[2] = -1
    lengths[3:6] = rng.integers(0, c, 3)
    lengths[6:9] = c - 1 + rng.integers(1, W + 1, 3)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return codes, lengths


def phase1_of(codes, lengths, k, canon, positions, rng):
    """Half the seeds of every row but the last two, and 0 and U64_MAX."""
    em = minimizers_plain(torch.from_numpy(codes[:-2]),
                          torch.from_numpy(lengths[:-2]), k, 1, canon,
                          positions=positions)
    seeds = np.unique(u64(em.values)[em.mask.numpy()])
    keep = rng.choice(seeds, seeds.size // 2, replace=False)
    return np.concatenate([keep, np.array([0, U64_MAX], np.uint64)])


@pytest.mark.parametrize("mode", ["inline", "flat"])
@pytest.mark.parametrize("W", [2, 13, 16])
@pytest.mark.parametrize("k", [21, 31, 32])
@pytest.mark.parametrize("discipline", sorted(DISCIPLINES))
def test_hash_emissions_match_jax(discipline, k, W, mode):
    canon, spaced = DISCIPLINES[discipline]
    gaps = parse_spacing("0x16,1x4", 21) if spaced and k == 21 else (
        [1] * (k - 1) if spaced else None)
    c = JSpacer(k, k, gaps).c
    jsp, sp = JSpacer(k, c + W - 1, gaps), Spacer(k, c + W - 1, gaps)
    assert sp.window_kmers == W
    positions = tuple(int(p) for p in sp.positions) if spaced else None
    rng = np.random.default_rng(k * 100 + W)
    codes, lengths = hash_rows(rng, sp.c, W)
    jt, tt = tables(phase1_of(codes, lengths, k, canon and not spaced,
                              positions, rng), rng, mode)
    jem = JEncoder(jsp, canon, "hash", score_map=JScoreMap(jt)).emissions(
        codes, lengths)
    em = BatchEncoder(sp, canon, "hash", score_map=ScoreMap(tt)).emissions(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    jm, jv = np.asarray(jem.mask), np.asarray(jem.values)
    m = em.mask.numpy()
    assert m.shape == jm.shape and m.any()
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(u64(em.values)[m], jv[jm])


@pytest.mark.parametrize("discipline", sorted(DISCIPLINES))
def test_hash_emissions_of_rows_shorter_than_the_window(discipline):
    """P < W: no window column (the compacted discipline keeps its tail)."""
    canon, spaced = DISCIPLINES[discipline]
    gaps = parse_spacing("0x16,1x4", 21) if spaced else None
    jsp = JSpacer(21, JSpacer(21, 21, gaps).c + 15, gaps)
    rng = np.random.default_rng(5)
    L = jsp.c + 3
    codes = rng.integers(0, 4, (4, L)).astype(np.int8)
    lengths = np.array([L, L - 1, 0, jsp.c], dtype=np.int32)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    positions = tuple(int(p) for p in jsp.positions) if spaced else None
    jt, tt = tables(phase1_of(np.concatenate([codes, codes[:2]]),
                              np.concatenate([lengths, lengths[:2]]), 21,
                              canon and not spaced, positions, rng), rng,
                    "inline")
    jem = JEncoder(jsp, canon, "hash", score_map=JScoreMap(jt)).emissions(
        codes, lengths)
    em = BatchEncoder(Spacer(21, jsp.w, gaps), canon, "hash",
                      score_map=ScoreMap(tt)).emissions(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    np.testing.assert_array_equal(em.mask.numpy(), np.asarray(jem.mask))
    m = em.mask.numpy()
    np.testing.assert_array_equal(u64(em.values)[m], np.asarray(jem.values)[m])


def test_hash_scheme_needs_a_score_map():
    codes = torch.zeros((1, 40), dtype=torch.int8)
    lengths = torch.tensor([40], dtype=torch.int32)
    with pytest.raises(ValueError, match="score_map"):
        BatchEncoder(Spacer(21, 30), True, "hash").emissions(codes, lengths)
    # unwindowed seeds take no score
    em = BatchEncoder(Spacer(21, 21), True, "hash").emissions(codes, lengths)
    assert em.mask.all()


# -- minimized_map ---------------------------------------------------------------

@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Three synthetic genomes of a contig of 2500 bases and one of 700,
    1% Ns."""
    tmp = tmp_path_factory.mktemp("genomes")
    rng = np.random.default_rng(13)
    paths, name_map = [], {}
    for i in range(3):
        p = str(tmp / f"g{i}.fa")
        with open(p, "w") as fh:
            for ci, clen in enumerate((2500, 700)):
                seq = random_dna(rng, clen, n_prob=0.01).decode()
                fh.write(f">ACC_{i}_{ci} synthetic\n{seq}\n")
        paths.append(p)
        name_map[f"ACC_{i}_0"] = [11, 12, 13][i]
    return paths, name_map


@pytest.mark.parametrize("phase", ["t", "f"])
@pytest.mark.parametrize("discipline", sorted(DISCIPLINES))
def test_minimized_map_matches_jax(genomes, discipline, phase):
    """k = 19, w = 36 (the spaced seed k = 19 at span 23, w = 40); the host
    and the device build (plain versions) against the JAX host build."""
    paths, name_map = genomes
    canon, spaced = DISCIPLINES[discipline]
    gaps = [0] * 14 + [1] * 4 if spaced else None
    k, w = 19, 40 if spaced else 36
    jt, tt = JTree(PARENTS), TaxTree(PARENTS)
    jfn = jbuild.taxdepth_map if phase == "t" else jbuild.ftct_map
    p1 = jfn(paths, jt, name_map, JSpacer(k, k, gaps), canon)
    want = jbuild.minimized_map(paths, p1, jt, name_map, JSpacer(k, w, gaps),
                                canon)
    assert want.n > 0
    tp1 = KmerTable(p1.keys_sorted, p1.vals_sorted)
    for got in (tbuild.minimized_map(paths, tp1, tt, name_map,
                                     Spacer(k, w, gaps), canon),
                bd.device_minimized_map(paths, tp1, tt, name_map,
                                        Spacer(k, w, gaps), canon,
                                        device="cpu")):
        np.testing.assert_array_equal(got.keys_sorted, want.keys_sorted)
        np.testing.assert_array_equal(got.vals_sorted, want.vals_sorted)
        assert got.vals_sorted.dtype == np.uint32


def test_minimized_map_of_genomes_phase1_lacks(genomes):
    """Phase 1 of the first genome only: the other genomes' k-mers score
    U64_MAX, and the keys phase 1 lacks are dropped from the content."""
    paths, name_map = genomes
    jt, tt = JTree(PARENTS), TaxTree(PARENTS)
    p1 = jbuild.taxdepth_map(paths[:1], jt, name_map, JSpacer(19, 19))
    want = jbuild.minimized_map(paths, p1, jt, name_map, JSpacer(19, 36))
    tp1 = KmerTable(p1.keys_sorted, p1.vals_sorted)
    got = bd.device_minimized_map(paths, tp1, tt, name_map, Spacer(19, 36),
                                  device="cpu")
    np.testing.assert_array_equal(got.keys_sorted, want.keys_sorted)
    np.testing.assert_array_equal(got.vals_sorted, want.vals_sorted)
    assert 0 < want.n
    assert np.isin(want.keys_sorted, p1.keys_sorted).all()


def test_phase2_content_tells_missing_from_a_stored_u64_max():
    """Scores from the card: a key that scores U64_MAX is probed again on
    the host, kept where phase 1 stores U64_MAX and dropped where phase 1
    lacks it; the same content as the host probe alone."""
    keys = np.array([0, 5, 9, 12, 40], np.uint64)
    vals = np.array([3, U64_MAX, 7, 1 << 40, 2], np.uint64)
    p1 = KmerTable(keys, vals)
    q = np.array([0, 5, 6, 12, 41], np.uint64)
    scores = ScoreMap(p1).lookup_scores(q)
    assert list(scores == U64_MAX) == [False, True, True, False, True]
    got = tbuild.phase2_content(q, p1, scores)
    want = tbuild.phase2_content(q, p1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].tolist() == [0, 5, 12]
    assert got[1].tolist() == [3, 0xFFFFFFFF, 0]


# -- classify against a phase-2 database -------------------------------------------

@pytest.fixture(scope="module")
def phase2_db(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("phase2")
    p1, db = str(tmp / "p1.btpu"), str(tmp / "p2.btpu")
    c = next(c for c in MANIFEST["configs"] if c["name"] == "min_td_k25_w37")
    assert cli.main(["prebuild", NAMEID, NODES, p1, *GENOMES, "-k", "25",
                     "-t"]) == 0
    assert cli.main(["build", db, *GENOMES, *c["flags"], "-t", "--phase1-db",
                     p1, "-T", NODES, "-M", NAMEID]) == 0
    assert tbuild.content_digest(load_database(db).table) == c["db_digest"]
    assert load_database(db).scheme == "hash"
    return db


@pytest.mark.parametrize("argv", [["-a", "reads.fa"], ["-a", "mate1.fa",
                                                       "mate2.fa"]],
                         ids=["single-a", "paired-a"])
def test_classify_against_a_phase2_database_matches_jax(phase2_db, argv,
                                                        tmp_path):
    reads = [os.path.join(GOLD, a) if a.endswith(".fa") else a for a in argv]
    jout, tout = str(tmp_path / "jax.out"), str(tmp_path / "torch.out")
    assert jmain(["classify", phase2_db, NODES, *reads, "-o", jout]) == 0
    assert cli.main(["classify", phase2_db, NODES, *reads, "--device", "cpu",
                     "-o", tout]) == 0
    want = open(jout, "rb").read()
    assert len(want.splitlines()) >= 100
    assert open(tout, "rb").read() == want
