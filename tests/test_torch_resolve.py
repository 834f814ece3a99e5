"""Port parity: K2's plain version (resolve_batch + taxid gather) and the
taxonomy arrays.

Random trees and hit matrices from a numpy seed go through the JAX
``resolve_batch`` / ``lca_device`` (on the CPU) and the port's, in each
of the JAX package's branches: dense (P <= 256), dedup (P > 256 with a
small distinct-taxa bound) and blockwise (P > 1024), plus paired rows
(W = 2P), all-miss rows and compact index 0 (the 0-identity LCA rules).
Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bonsai_tpu  # noqa: F401  (enables jax x64)
from bonsai_tpu.classify import resolve as jres
from bonsai_tpu.taxonomy.tree import TaxTree as JTree

from bonsai_tpu_torch.classify import resolve as res
from bonsai_tpu_torch.taxonomy.tree import TaxTree

torch.set_num_threads(1)


def _parent_map(rng, n=80):
    pm = {1: 0}
    ids = [1]
    for t in range(2, n + 2):
        tid = int(t * 7 + rng.integers(0, 5))  # sparse, unsorted taxids
        pm[tid] = int(ids[rng.integers(0, len(ids))])
        ids.append(tid)
    return pm


@pytest.fixture(scope="module")
def trees():
    pm = _parent_map(np.random.default_rng(5))
    jt, tt = JTree(pm), TaxTree(pm)
    jax_tax = jt.device_arrays()
    tax = tt.device_arrays("cpu")
    return jt, tt, jax_tax, tax


def test_tree_arrays_equal_jax(trees):
    jt, tt, jax_tax, tax = trees
    for name in ("parent", "depth", "tin", "tout", "lift"):
        np.testing.assert_array_equal(tax[name].numpy(), np.asarray(jax_tax[name]))
    np.testing.assert_array_equal(tax["tax_ids"].numpy().view(np.uint32),
                                  np.asarray(jax_tax["tax_ids"]))


def test_lca_device_matches_jax_with_zero_identity(trees):
    jt, tt, jax_tax, tax = trees
    rng = np.random.default_rng(6)
    n = tt.tin.shape[0]
    a = rng.integers(0, n, 3000).astype(np.int32)
    b = rng.integers(0, n, 3000).astype(np.int32)
    a[:200] = 0
    b[100:300] = 0
    want = np.asarray(jres.lca_device(jnp.asarray(a), jnp.asarray(b), jax_tax))
    got = res.lca_device(torch.from_numpy(a), torch.from_numpy(b), tax)
    np.testing.assert_array_equal(got.numpy(), want)


def _hits(rng, B, P, pool, p_hit=0.6):
    cidx = rng.choice(pool, size=(B, P)).astype(np.int32)
    hit = rng.random((B, P)) < p_hit
    hit[: max(B // 16, 1)] = False  # all-miss rows
    cidx = np.where(hit, cidx, 0).astype(np.int32)
    return cidx, hit


@pytest.mark.parametrize(
    "B,P,n_distinct",
    [(64, 74, 12), (32, 200, None), (16, 300, 12), (8, 1100, 12),
     (8, 1100, None)],
    ids=["dense", "dense-nd", "dedup", "dedup-long", "blockwise"],
)
def test_resolve_batch_matches_jax(trees, B, P, n_distinct):
    jt, tt, jax_tax, tax = trees
    rng = np.random.default_rng(P)
    n = tt.tin.shape[0]
    # hits come from a fixed set of taxa (the DB's distinct values), which
    # includes compact index 0: a DB taxid that is not in the tree
    pool = np.concatenate([[0], rng.choice(np.arange(1, n), 11, replace=False)])
    cidx, hit = _hits(rng, B, P, pool)
    want = np.asarray(jres.resolve_batch(jnp.asarray(cidx), jnp.asarray(hit),
                                         jax_tax, n_distinct=n_distinct))
    got = res.resolve_batch(torch.from_numpy(cidx), torch.from_numpy(hit), tax,
                            n_distinct=n_distinct)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[: max(B // 16, 1)] == 0).all()
    taxid = res.resolve(torch.from_numpy(cidx), torch.from_numpy(hit), tax,
                        n_distinct)
    assert res.resolve.launches == 0  # CPU tensors: the plain version
    np.testing.assert_array_equal(
        taxid.numpy().view(np.uint32), np.asarray(jax_tax["tax_ids"])[want])


def test_resolve_paired_rows_match_jax(trees):
    """Mates (2i, 2i+1) of width P merge into rows of width 2P."""
    jt, tt, jax_tax, tax = trees
    rng = np.random.default_rng(9)
    n = tt.tin.shape[0]
    cidx, hit = _hits(rng, 64, 74, np.arange(n))
    c2, h2 = cidx.reshape(32, 148), hit.reshape(32, 148)
    want = np.asarray(jres.resolve_batch(jnp.asarray(c2), jnp.asarray(h2), jax_tax))
    got = res.resolve_batch(torch.from_numpy(cidx).view(32, 148),
                            torch.from_numpy(hit).view(32, 148), tax)
    np.testing.assert_array_equal(got.numpy(), want)


def _cycle_rows(tree, P):
    """64 rows over a taxonomy with a parent cycle: row 0 holds taxid 6
    (on the cycle, tin 0) first and the root (tin 0) at 149 positions."""
    rng = np.random.default_rng(P)
    hit = rng.random((64, P)) < 0.6
    cidx = np.where(hit, rng.choice(tree.compact([1, 5, 6]), (64, P)), 0)
    cidx, hit[0] = cidx.astype(np.int32), False
    cidx[0] = 0
    cidx[0, 0], hit[0, 0] = tree.compact([6])[0], True
    cidx[0, 1:150], hit[0, 1:150] = tree.compact([1])[0], True
    return cidx, hit


@pytest.mark.parametrize("P,n_distinct", [(300, 3), (300, None), (74, 3)],
                         ids=["dedup", "dense-nd", "dense"])
def test_resolve_batch_parent_cycle_matches_jax(P, n_distinct):
    """Nodes on a parent cycle are never visited and keep the root's tin
    of 0: the dense branch breaks the tie by first position (taxid 6), the
    dedup branch by smaller compact index (taxid 1)."""
    pm = {1: 0, 2: 1, 3: 1, 5: 6, 6: 5}
    tt = TaxTree(pm)
    jax_tax = JTree(pm).device_arrays()
    tax = tt.device_arrays("cpu")
    for name in ("tin", "tout", "depth", "parent", "lift"):
        np.testing.assert_array_equal(tax[name].numpy(), np.asarray(jax_tax[name]))
    cidx, hit = _cycle_rows(tt, P)
    want = np.asarray(jres.resolve_batch(jnp.asarray(cidx), jnp.asarray(hit),
                                         jax_tax, n_distinct=n_distinct))
    got = res.resolve_batch(torch.from_numpy(cidx), torch.from_numpy(hit), tax,
                            n_distinct=n_distinct)
    np.testing.assert_array_equal(got.numpy(), want)
    dedup = res.dedup_rule(n_distinct, P)
    assert dedup == (P > 256 and n_distinct is not None)
    assert tt.tax_ids_compact()[want[0]] == (1 if dedup else 6)


@pytest.fixture(scope="module")
def deep_trees():
    from bonsai_tpu_torch.tools.synthetic import deep_tree

    tt = deep_tree(np.random.default_rng(12), 4096, full=33)
    jt = JTree(tt.parent_map)
    return tt, tt.device_arrays("cpu"), jt.device_arrays()


def test_deep_tree_arrays_equal_jax(deep_trees):
    tt, tax, jax_tax = deep_trees
    assert tt.lift.shape[0] == 6 and tt.max_depth >= 33
    for name in ("parent", "depth", "tin", "tout", "lift"):
        np.testing.assert_array_equal(tax[name].numpy(), np.asarray(jax_tax[name]))


@pytest.mark.parametrize(
    "B,P,n_distinct", [(64, 74, None), (16, 300, 40), (8, 1100, None)],
    ids=["dense", "dedup", "blockwise"])
def test_resolve_batch_deep_tree_matches_jax(deep_trees, B, P, n_distinct):
    """Lineages 33-40 deep (6 lift levels), hits on 40 taxa of the tree."""
    tt, tax, jax_tax = deep_trees
    rng = np.random.default_rng(P + 3)
    pool = rng.choice(np.arange(1, tt.tin.size), 40, replace=False)
    cidx, hit = _hits(rng, B, P, pool)
    want = np.asarray(jres.resolve_batch(jnp.asarray(cidx), jnp.asarray(hit),
                                         jax_tax, n_distinct=n_distinct))
    got = res.resolve_batch(torch.from_numpy(cidx), torch.from_numpy(hit), tax,
                            n_distinct=n_distinct)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (tt.depth[want] > 1).any()  # some reads resolve below the root


@pytest.mark.parametrize("p_hit,R", [(0.0, 32), (0.3, 32), (1.0, 2048)],
                         ids=["no-hit", "some", "all-whole-arrays"])
def test_resolve_work_counts_distinct_taxa(deep_trees, p_hit, R):
    """K2's bound counts d^2 count-weighted pairs a read (d distinct hit
    taxa, not its h hits), and the smaller of the whole taxonomy arrays and
    the entries the work reads."""
    from bonsai_tpu_torch.tools.bounds import resolve_work

    tt, tax, _ = deep_trees
    rng = np.random.default_rng(5)
    W = 74
    hit = rng.random((R, W)) < p_hit
    cidx = np.where(hit, rng.choice(np.arange(1, 9), (R, W)), 0).astype(np.int32)
    d = np.array([np.unique(c[h]).size for c, h in zip(cidx, hit)])
    nb, ops, side = resolve_work(torch.from_numpy(cidx), torch.from_numpy(hit),
                                 tax)
    assert ops == 3 * int((d * d).sum())
    whole = sum(t.numel() * t.element_size() for t in tax.values())
    levels = tt.lift.shape[0]
    entries = int(8 * d.sum() + (d > 0).sum() * (8 * (2 * levels + 1) + 4))
    assert nb == R * W * 5 + 4 * R + min(entries, whole)
    assert side == ("entries" if entries < whole else "whole arrays")
