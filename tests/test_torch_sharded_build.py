"""Port parity: the sharded build and the sequence-parallel encode on the
CPU against the JAX package (its virtual 8-device CPU mesh).

``sharded_encode_contig`` at sp = 4 and 8, canonical and not;
``ShardedLCAFold`` and ``sharded_lca_map`` against the JAX functions and
against ``db/build.lca_map`` (quantile and even splitters, canonical,
uncanonical windowed, 3 and 4 ranks); a capacity overflow raises and
leaves every rank's state as it was; ``key_range`` at the splitters and
U64_MAX.  Tolerance: equal keys and values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bonsai_tpu.core.alphabet import DNA4
from bonsai_tpu.core.spacer import Spacer as JSpacer
from bonsai_tpu.db import build as jbuild
from bonsai_tpu.db import build_device as jbd
from bonsai_tpu.parallel.mesh import make_mesh as jmesh
from bonsai_tpu.parallel.sharded import sharded_encode_contig as jencode
from bonsai_tpu.taxonomy.tree import TaxTree as JTree

from bonsai_tpu_torch.core.spacer import Spacer
from bonsai_tpu_torch.db import build as tbuild
from bonsai_tpu_torch.db import build_device as bd
from bonsai_tpu_torch.parallel.mesh import make_mesh
from bonsai_tpu_torch.parallel.sharded import sharded_encode_contig
from bonsai_tpu_torch.taxonomy.tree import TaxTree

from conftest import random_dna

TAXA = {1: 0, 2: 1, 3: 1, 11: 2, 12: 2, 13: 3, 5: 0, 51: 5}


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Three genomes of two contigs each (1% Ns), as test_build_device."""
    d = tmp_path_factory.mktemp("g")
    rng = np.random.default_rng(21)
    paths, name_map = [], {}
    for i in range(3):
        p = str(d / f"g{i}.fa")
        with open(p, "w") as fh:
            for ci, clen in enumerate((2600, 900)):
                seq = random_dna(rng, clen, n_prob=0.01).decode()
                fh.write(f">ACC_{i}_{ci} synthetic\n{seq}\n")
        paths.append(p)
        name_map[f"ACC_{i}_0"] = [11, 12, 13][i % 3]
    return paths, name_map


def _same_table(a, b):
    assert np.array_equal(a.keys_sorted, b.keys_sorted)
    assert np.array_equal(np.asarray(a.vals_sorted, np.uint64),
                          np.asarray(b.vals_sorted, np.uint64))


@pytest.mark.parametrize("nsp,k", [(4, 17), (4, 31), (8, 31), (8, 5)])
@pytest.mark.parametrize("canon", [True, False])
def test_sharded_encode_contig_matches_jax(nsp, k, canon):
    rng = np.random.default_rng(nsp * 100 + k)
    seq = random_dna(rng, nsp * 512, 0.01)
    codes = DNA4.lut[np.frombuffer(seq, dtype=np.uint8)][None].astype(np.int8)
    jk, jv = jencode(jnp.asarray(codes), k, jmesh({"sp": nsp}), canon)
    tk, tv = sharded_encode_contig(torch.from_numpy(codes), k,
                                   make_mesh({"sp": nsp}, ["cpu"]), canon)
    assert np.array_equal(tk.numpy().view(np.uint64), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert not tv[0, -(k - 1):].any() if k > 1 else True


def test_sharded_encode_contig_needs_equal_blocks():
    codes = torch.zeros((1, 1001), dtype=torch.int8)
    with pytest.raises(ValueError, match="equal blocks"):
        sharded_encode_contig(codes, 17, make_mesh({"sp": 4}, ["cpu"]))


@pytest.mark.parametrize("k,w,canon,ndb", [(27, 27, True, 4),
                                           (21, 27, True, 3),
                                           (21, 33, False, 4),
                                           (21, 21, False, 2)])
def test_sharded_lca_map_matches_jax_and_host(genomes, k, w, canon, ndb):
    paths, name_map = genomes
    want = jbd.sharded_lca_map(paths, JTree(TAXA), name_map, JSpacer(k, w),
                               jmesh({"db": ndb}), canonicalize=canon,
                               block=1 << 10)
    got = bd.sharded_lca_map(paths, TaxTree(TAXA), name_map, Spacer(k, w),
                             make_mesh({"db": ndb}, ["cpu"]), canonicalize=canon,
                             block=1 << 10)
    assert got.n > 0
    _same_table(got, want)
    if canon or w == k:  # -C -w equals the host build only at its block
        _same_table(got, tbuild.lca_map(paths, TaxTree(TAXA), name_map,
                                        Spacer(k, w), canon))


def test_sharded_lca_map_on_a_dp_by_db_mesh(genomes):
    """The fold's ranks repeat over dp: each db range is folded once a dp
    row and taken once."""
    paths, name_map = genomes
    host = jbuild.lca_map(paths, JTree(TAXA), name_map, JSpacer(27, 27))
    got = bd.sharded_lca_map(paths, TaxTree(TAXA), name_map, Spacer(27, 27),
                             make_mesh({"dp": 2, "db": 2}, ["cpu"]), block=1 << 10)
    _same_table(got, host)


def test_sharded_fold_with_even_splitters_matches_jax():
    """Explicit chunks through both folds at the default even split,
    keys with bit 63 set, U64_MAX and the splitter itself among them."""
    rng = np.random.default_rng(3)
    jtree, ttree = JTree(TAXA), TaxTree(TAXA)
    jf = jbd.ShardedLCAFold(jtree, jmesh({"db": 4}), cap=1 << 12)
    tf = bd.ShardedLCAFold(ttree, make_mesh({"db": 4}, ["cpu"]), cap=1 << 12)
    pool = rng.integers(0, 2**64, 3000, dtype=np.uint64)
    pool[:3] = [2**64 - 1, 2**62, 2**63]  # U64_MAX, two splitters
    for node_taxid in (11, 12, 13, 51, 11):
        keys = rng.choice(pool, 700)
        pad = (rng.random(700) < 0.1).astype(np.uint8)
        node = int(ttree.compact(np.array([node_taxid], np.uint32))[0])
        jf.add_chunk(jnp.asarray(keys), jnp.asarray(pad), node, node_taxid)
        tf.add_chunk(torch.from_numpy(keys.view(np.int64)),
                     torch.from_numpy(pad), node, node_taxid)
    jk, jt = jf.finish()
    tk, tt = tf.finish()
    assert np.array_equal(tk, jk) and np.array_equal(tt, jt)
    assert tk.size and np.all(tk[1:] > tk[:-1])


def test_sharded_fold_overflow_raises_and_keeps_the_state():
    ttree = TaxTree(TAXA)
    fold = bd.ShardedLCAFold(ttree, make_mesh({"db": 2}, ["cpu"]), cap=64)
    rng = np.random.default_rng(2)
    small = torch.from_numpy(rng.integers(0, 1 << 62, 40).astype(np.int64))
    fold.add_chunk(small, torch.zeros(40, dtype=torch.uint8), 3, 11)
    before = [(s.keys.clone(), s.n.clone()) for s in fold.states.values()]
    big = torch.from_numpy(rng.integers(0, 1 << 63, 200).astype(np.int64))
    with pytest.raises(RuntimeError, match="capacity 64"):
        fold.add_chunk(big, torch.zeros(200, dtype=torch.uint8), 4, 12)
    for (k, n), s in zip(before, fold.states.values()):
        assert torch.equal(k, s.keys) and int(n) == int(s.n)
    keys, taxa = fold.finish()
    assert np.array_equal(keys, np.unique(small.numpy().view(np.uint64)))
    assert set(taxa.tolist()) == {11}


def test_key_range_at_its_edges():
    keys = np.array([0, 5, 2**62 - 1, 2**62, 2**63, 2**64 - 2, 2**64 - 1],
                    np.uint64)
    pad = np.array([0, 0, 0, 0, 0, 1, 0], np.uint8)
    k, p = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(pad)
    for lo, hi, last in ((0, 2**62, False), (2**62, 2**64 - 1, False),
                         (2**62, 2**64 - 1, True), (5, 5, True)):
        want = (pad == 0) & (keys >= np.uint64(lo)) & (
            (keys <= np.uint64(hi)) if last else (keys < np.uint64(hi)))
        assert bd.key_range(k, p, lo, hi, last).numpy().tolist() == \
            want.tolist()
    with pytest.raises(ValueError, match="u64 bounds"):
        bd.key_range(k, p, -1, 5, False)
