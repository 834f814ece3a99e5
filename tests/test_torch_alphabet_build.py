"""Port parity: the build's other alphabets (queue A item 8.4b).

``BatchEncoder(scheme="hash")`` of PROTEIN, PROTEIN20, PROTEIN_3BIT (at
k = 22 too, whose 66-bit fold reaches a real U64_MAX), PROTEIN_14 and
PROTEIN_6, spaced and windowed, against the JAX encoder on rows with
ambiguous codes, a run of one letter, rows shorter than the span and an
all-ambiguous row, scored by inline and flat phase-1 maps of half their
own seeds (0 and U64_MAX stored); then the builds of small protein
genomes (two contigs each, 'X' and '*' ambiguous, a run of 'P'):
``minimized_map(input_type=)`` on the host and with ``use_device`` on
the CPU, each ``device_*_map(input_type=, device="cpu")`` against the JAX
package's ``device_*_map`` at the same chunk size (1024 windows, so that
chunk edges fall inside contigs) and against the JAX host map,
``genome_kmer_set`` under the scheme hash, and ``sharded_lca_map
(input_type=)`` on a CPU mesh against ``lca_map``, with quantile and
degenerate splitters.  The phase-1 map the JAX package builds goes into
the port's ``KmerTable`` as its sorted keys and values, so that both
packages score by the same map.  Tolerance: exact equality, since all of
it is integer work.
"""

import numpy as np
import pytest
import torch

import bonsai_tpu  # noqa: F401  (enables jax x64)
from bonsai_tpu.core.alphabet import alphabet_of as jalphabet_of
from bonsai_tpu.core.encoder import BatchEncoder as JEncoder
from bonsai_tpu.core.spacer import Spacer as JSpacer
from bonsai_tpu.db import build as jbuild
from bonsai_tpu.db import build_device as jbd
from bonsai_tpu.db.table import KmerTable as JTable
from bonsai_tpu.db.table import ScoreMap as JScoreMap
from bonsai_tpu.taxonomy.tree import TaxTree as JTree

from bonsai_tpu_torch.core.alphabet import InputType, nper64
from bonsai_tpu_torch.core.encoder import BatchEncoder, minimizers_plain
from bonsai_tpu_torch.core.spacer import Spacer, parse_spacing
from bonsai_tpu_torch.db import build as tbuild
from bonsai_tpu_torch.db import build_device as bd
from bonsai_tpu_torch.db.table import KmerTable, ScoreMap
from bonsai_tpu_torch.parallel.mesh import make_mesh
from bonsai_tpu_torch.taxonomy.tree import TaxTree

torch.set_num_threads(1)
U64_MAX = np.uint64(2**64 - 1)
PROTEIN_CHARS = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
PARENTS = {1: 0, 2: 1, 3: 1, 11: 2, 12: 2, 13: 3}
BLOCK = 1 << 10


def u64(t):
    return t.numpy().view(np.uint64)


def protein(rng, n, ambiguous=0.02) -> bytes:
    """n residues of the 20 amino acids, a share ``ambiguous`` of them 'X'
    or '*' (ambiguous in every alphabet but PROTEIN's bytes)."""
    seq = rng.choice(PROTEIN_CHARS, n)
    amb = rng.random(n) < ambiguous
    seq[amb] = rng.choice(np.frombuffer(b"X*", np.uint8), int(amb.sum()))
    return seq.tobytes()


# -- BatchEncoder(scheme="hash") ---------------------------------------------

# (input type, k): the middle of each type's k-mer, and PROTEIN_3BIT at
# k = 22, whose fold of 66 bits keeps the low 64 (a run of 'P', code 7, is
# U64_MAX)
SEEDS = [(InputType.PROTEIN, 5), (InputType.PROTEIN20, 5),
         (InputType.PROTEIN_3BIT, 6), (InputType.PROTEIN_3BIT, 22),
         (InputType.PROTEIN_14, 5), (InputType.PROTEIN_6, 6)]


def hash_rows(rng, it, c, W, B=16, L=160):
    """(B, L) codes of ``it`` and lengths: 2% ambiguous residues, a run of
    'P' (code 7 of PROTEIN_3BIT), an all-ambiguous row, rows shorter than
    the span and with fewer than W valid seeds, -1 past each length; the
    last two rows fresh residues (phase 1 lacks their seeds)."""
    L = max(L, c + W + 8)
    rows = np.frombuffer(b"".join(protein(rng, L) for _ in range(B)),
                         np.uint8).reshape(B, L).copy()
    rows[0, 10: 10 + c + 3 * W] = ord("P")
    rows[1] = ord("X")
    codes = jalphabet_of(it).lut[rows]
    lengths = rng.integers(c, L + 1, B).astype(np.int32)
    lengths[0] = L
    lengths[2:4] = rng.integers(0, c, 2)
    lengths[4:6] = c - 1 + rng.integers(1, W + 1, 2)
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return codes, lengths


def tables(rng, seeds, mode):
    """The JAX phase-1 table of ``seeds``, 0 and U64_MAX, and the port's,
    carried across from its sorted keys and values: 6 packed values
    (inline) or one a key (flat)."""
    keys = np.unique(np.concatenate([seeds, np.array([0, U64_MAX],
                                                     np.uint64)]))
    v = (np.arange(keys.size, dtype=np.uint64) if mode == "flat" else
         rng.integers(0, 6, keys.size).astype(np.uint64))
    jt = JTable(keys, ((v + np.uint64(7)) << np.uint64(32)) | v,
                min_nb=0 if mode == "flat" else 1 << 10)
    tt = KmerTable(jt.keys_sorted, jt.vals_sorted, min_nb=jt.nb)
    assert tt.arrays_np()[2] == (mode == "inline")
    return jt, tt


@pytest.mark.parametrize("mode", ["inline", "flat"])
@pytest.mark.parametrize("W", [2, 13])
@pytest.mark.parametrize("disc", ["spaced", "windowed"])
@pytest.mark.parametrize("it,k", SEEDS,
                         ids=[f"{t.name}-{k}" for t, k in SEEDS])
def test_hash_emissions_match_jax(it, k, disc, W, mode):
    """The spaced seed takes every other residue (KB1's discipline); the
    windowed seed is contiguous and uncanonical (KB4's)."""
    gaps = [1] * (k - 1) if disc == "spaced" else None
    c = JSpacer(k, k, gaps).c
    jsp, sp = JSpacer(k, c + W - 1, gaps), Spacer(k, c + W - 1, gaps)
    assert sp.window_kmers == W
    pos = tuple(int(p) for p in sp.positions) if gaps else None
    rng = np.random.default_rng(int(it) * 1000 + k * 10 + W)
    codes, lengths = hash_rows(rng, it, c, W)
    em = minimizers_plain(torch.from_numpy(codes[:-2]),
                          torch.from_numpy(lengths[:-2]), k, 1, False,
                          positions=pos, it=it)
    seeds = np.unique(u64(em.values)[em.mask.numpy()])
    jt, tt = tables(rng, rng.choice(seeds, seeds.size // 2, replace=False),
                    mode)
    jem = JEncoder(jsp, True, "hash", it, JScoreMap(jt)).emissions(codes,
                                                                   lengths)
    got = BatchEncoder(sp, True, "hash", it, ScoreMap(tt)).emissions(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    jm, m = np.asarray(jem.mask), got.mask.numpy()
    assert m.shape == jm.shape and m.any()
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(u64(got.values)[m],
                                  np.asarray(jem.values)[jm])
    if (it, k, disc) == (InputType.PROTEIN_3BIT, 22, "windowed"):
        assert (u64(got.values)[m] == U64_MAX).any()  # the run of 'P'


def test_hash_scheme_of_every_type_takes_a_score_map():
    """No type refuses the scheme; without a map the windowed seeds
    raise, unwindowed ones take no score."""
    codes = torch.zeros((1, 40), dtype=torch.int8)
    lengths = torch.tensor([40], dtype=torch.int32)
    for it in InputType:
        k = min(nper64(it), 5)
        for sp in (Spacer(k, k + 6), Spacer(k, 2 * k + 4, [1] * (k - 1))):
            enc = BatchEncoder(sp, False, "hash", it)
            with pytest.raises(ValueError, match="score_map"):
                enc.emissions(codes, lengths)
        em = BatchEncoder(Spacer(k, k), False, "hash", it).emissions(codes,
                                                                     lengths)
        assert em.mask.all()


# -- the builds ---------------------------------------------------------------

@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Three protein genomes of two contigs (2600 and 900 residues, 2%
    'X' or '*', the first with a run of 80 'P'), their first accessions
    mapped to taxa 11, 12 and 13."""
    tmp = tmp_path_factory.mktemp("protein")
    rng = np.random.default_rng(24)
    paths, name_map = [], {}
    for i in range(3):
        p = str(tmp / f"p{i}.faa")
        with open(p, "wb") as fh:
            for ci, clen in enumerate((2600, 900)):
                seq = bytearray(protein(rng, clen))
                if ci == 0:
                    seq[500:580] = b"P" * 80
                fh.write(b">ACC_%d_%d synthetic\n%s\n" % (i, ci, bytes(seq)))
        paths.append(p)
        name_map[f"ACC_{i}_0"] = [11, 12, 13][i]
    return paths, name_map


def _same(got, want):
    np.testing.assert_array_equal(got.keys_sorted, want.keys_sorted)
    np.testing.assert_array_equal(np.asarray(got.vals_sorted, np.uint64),
                                  np.asarray(want.vals_sorted, np.uint64))


# (input type, k, w, spacing) of a phase 2, whose phase 1 is the same seed
# at w = its span: windowed contiguous (KB4) and spaced (KB1) seeds
BUILDS = {
    "PROTEIN20 -k 5 -w 12": (InputType.PROTEIN20, 5, 12, ""),
    "PROTEIN_6 -k 6 -S 1x5 -w 18": (InputType.PROTEIN_6, 6, 18, "1x5"),
    "PROTEIN_3BIT -k 22 -w 30": (InputType.PROTEIN_3BIT, 22, 30, ""),
    "PROTEIN_14 -k 5 -S 0x2,2x2 -w 16": (InputType.PROTEIN_14, 5, 16,
                                         "0x2,2x2"),
    "PROTEIN -k 4 -w 9": (InputType.PROTEIN, 4, 9, ""),
}


def _seeds(name):
    it, k, w, spacing = BUILDS[name]
    gaps = parse_spacing(spacing, k)
    c = Spacer(k, k, gaps).c
    return (it, (JSpacer(k, c, gaps), Spacer(k, c, gaps)),
            (JSpacer(k, w, gaps), Spacer(k, w, gaps)))


@pytest.mark.parametrize("phase", ["t", "f"])
@pytest.mark.parametrize("name", sorted(BUILDS))
def test_minimized_map_matches_jax(genomes, name, phase):
    """The JAX host phase 1 (-t or -f) scores both packages' phase 2: the
    port's host build, with ``use_device`` on the CPU, and
    ``device_minimized_map`` on the CPU (one chunk a contig) against the
    JAX host build."""
    paths, name_map = genomes
    it, (jp1, tp1), (jp2, tp2) = _seeds(name)
    jt, tt = JTree(PARENTS), TaxTree(PARENTS)
    jfn = jbuild.taxdepth_map if phase == "t" else jbuild.ftct_map
    p1 = jfn(paths, jt, name_map, jp1, True, it)
    want = jbuild.minimized_map(paths, p1, jt, name_map, jp2, True, it)
    assert want.n > 0
    t1 = KmerTable(p1.keys_sorted, p1.vals_sorted)
    for got in (tbuild.minimized_map(paths, t1, tt, name_map, tp2, True, it),
                tbuild.minimized_map(paths, t1, tt, name_map, tp2, True, it,
                                     use_device=True, device="cpu"),
                bd.device_minimized_map(paths, t1, tt, name_map, tp2, True,
                                        it, device="cpu")):
        _same(got, want)
        assert got.vals_sorted.dtype == np.uint32


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_device_minimized_map_in_chunks_matches_jax(genomes, name):
    """Chunks of 1024 windows, as the JAX device build at the same block:
    a chunk's edge inside a contig drops the trailing partial window of
    the uncanonical windowed discipline."""
    paths, name_map = genomes
    it, (jp1, _), (jp2, tp2) = _seeds(name)
    jt, tt = JTree(PARENTS), TaxTree(PARENTS)
    p1 = jbuild.taxdepth_map(paths, jt, name_map, jp1, True, it)
    want = jbd.device_minimized_map(paths, p1, jt, name_map, jp2, True, it,
                                    block=BLOCK)
    got = bd.device_minimized_map(paths, KmerTable(p1.keys_sorted,
                                                   p1.vals_sorted), tt,
                                  name_map, tp2, True, it, block=BLOCK,
                                  device="cpu")
    assert want.n > 0
    _same(got, want)


DEVICE_MAPS = {  # name -> (port, JAX device, JAX host)
    "lca": (bd.device_lca_map, jbd.device_lca_map, jbuild.lca_map),
    "taxdepth": (bd.device_taxdepth_map, jbd.device_taxdepth_map,
                 jbuild.taxdepth_map),
    "ftct": (bd.device_ftct_map, jbd.device_ftct_map, jbuild.ftct_map),
}


def _call(fn, paths, tree, name_map, sp, it, **kw):
    """A map of the input type ``it``: the LCA maps take the scheme
    before it."""
    if fn in (bd.device_lca_map, jbd.device_lca_map, jbuild.lca_map):
        return fn(paths, tree, name_map, sp, True, "lex", it, **kw)
    return fn(paths, tree, name_map, sp, True, it, **kw)


@pytest.mark.parametrize("which", ["phase 1", "phase 2 seed"])
@pytest.mark.parametrize("name", sorted(BUILDS))
@pytest.mark.parametrize("kind", sorted(DEVICE_MAPS))
def test_device_maps_match_jax(genomes, kind, name, which):
    """``device_lca_map``, ``device_taxdepth_map`` and ``device_ftct_map``
    with the input type, at the phase-1 seed (unwindowed, or spaced at
    W = 1) and at the phase-2 seed (windowed): in chunks of 1024 windows
    against the JAX device build at that block, and in one chunk a contig
    against the JAX host build."""
    paths, name_map = genomes
    it, p1, p2 = _seeds(name)
    jsp, tsp = p1 if which == "phase 1" else p2
    port, jdev, jhost = DEVICE_MAPS[kind]
    jt, tt = JTree(PARENTS), TaxTree(PARENTS)
    want = _call(jdev, paths, jt, name_map, jsp, it, block=BLOCK)
    assert want.n > 0
    _same(_call(port, paths, tt, name_map, tsp, it, block=BLOCK,
                device="cpu"), want)
    _same(_call(port, paths, tt, name_map, tsp, it, device="cpu"),
          _call(jhost, paths, jt, name_map, jsp, it))


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_genome_kmer_set_under_hash_matches_jax(genomes, name):
    """``genome_kmer_set(scheme="hash", input_type=, score_map=)`` on the
    host and with ``use_device`` on the CPU against the JAX host's."""
    paths, _ = genomes
    it, (jp1, _), (jp2, tp2) = _seeds(name)
    p1 = jbuild.taxdepth_map(paths, JTree(PARENTS), {"ACC_0_0": 11}, jp1,
                             True, it)
    smap = ScoreMap(KmerTable(p1.keys_sorted, p1.vals_sorted))
    want = jbuild.genome_kmer_set(paths[0], jp2, True, "hash", it,
                                  JScoreMap(p1))
    assert want.size > 0
    for use_device in (False, True):
        got = tbuild.genome_kmer_set(paths[0], tp2, True, "hash", it, smap,
                                     use_device, device="cpu")
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ndb", [2, 4])
@pytest.mark.parametrize("name", sorted(BUILDS))
def test_sharded_lca_map_matches_lca_map(genomes, name, ndb):
    """``sharded_lca_map`` with the input type on a CPU mesh of ``ndb`` db
    ranks (splitters from the keys' quantiles) against the JAX host
    ``lca_map`` at the same block."""
    paths, name_map = genomes
    it, _, (jsp, tsp) = _seeds(name)
    want = jbuild.lca_map(paths, JTree(PARENTS), name_map, jsp, True, "lex",
                          it, block=BLOCK)
    got = bd.sharded_lca_map(paths, TaxTree(PARENTS), name_map, tsp,
                             make_mesh({"db": ndb}, ["cpu"]), True, "lex", it,
                             block=BLOCK)
    assert want.n > 0
    _same(got, want)


@pytest.mark.parametrize("it,k", [(InputType.PROTEIN20, 7),
                                  (InputType.PROTEIN_3BIT, 22)],
                         ids=["PROTEIN20-7", "PROTEIN_3BIT-22"])
def test_sharded_lca_map_of_degenerate_splitters(tmp_path, it, k):
    """Fewer keys than ranks: the JAX rule's even split of [0, 4^k) (2k <
    64), which another alphabet's keys overrun into the last rank; the
    content is ``lca_map``'s all the same."""
    rng = np.random.default_rng(k)
    paths, name_map = [], {}
    for i in range(3):
        p = str(tmp_path / f"s{i}.faa")
        open(p, "wb").write(b">S%d x\n%s\n" % (i, protein(rng, k, 0.0)))
        paths.append(p)
        name_map[f"S{i}"] = [11, 12, 13][i]
    want = jbuild.lca_map(paths, JTree(PARENTS), name_map, JSpacer(k, k),
                          True, "lex", it)
    got = bd.sharded_lca_map(paths, TaxTree(PARENTS), name_map, Spacer(k, k),
                             make_mesh({"db": 4}, ["cpu"]), True, "lex", it)
    assert want.n == 3
    _same(got, want)
