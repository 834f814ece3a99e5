"""TaxTree: the taxonomy as dense arrays over a compact index space.

Counterpart of ``bonsai_tpu/taxonomy/tree.py``.  Built on the host with
numpy, identical array for array to the JAX package's tree:

  * ``parent``   (N,) compact parent index (0 = virtual "no taxon" root)
  * ``depth``    (N,) node_depth semantics (depth(1) == 1)
  * ``tin/tout`` (N,) Euler preorder interval labels: a is an
                 ancestor-or-self of d iff tin[a] <= tin[d] <= tout[a]
  * ``lift``     (levels, N) binary-lifting ancestor table

``device_arrays(device)`` hands these to the classify kernels as torch
tensors.  The host queries (``lca``, ``lca_pairs``, ``lca_reduce``,
``resolve_tree_host``, ``node_depth``, ``is_ancestor``) keep the
reference's lca() contract, and ``invert``/``descendants`` serve the
metatree tools.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

TAX_MISSING = 0xFFFFFFFF  # reference lca() returns (tax_t)-1 on missing nodes


class TaxTree:
    def __init__(self, parent_map: Dict[int, int]):
        """parent_map: {taxid: parent_taxid} with 1 -> 0 for the root."""
        self.parent_map = dict(parent_map)
        ids = set(self.parent_map.keys())
        ids.update(v for v in self.parent_map.values() if v != 0)
        ids.discard(0)
        self.tax_ids = np.array(sorted(ids), dtype=np.uint32)
        n = len(self.tax_ids) + 1  # compact 0 = "no taxon"
        self._n = n
        parent = np.zeros(n, dtype=np.int32)
        # one vectorised lookup: a searchsorted per entry with a Python int
        # casts the whole id array each call, O(n^2) for NCBI's ~2.6M nodes
        tids = np.fromiter(self.parent_map.keys(), dtype=np.int64,
                           count=len(self.parent_map))
        pids = np.fromiter(self.parent_map.values(), dtype=np.int64,
                           count=len(self.parent_map))
        parent[self.compact(tids)] = self.compact(pids)
        self.parent = parent
        self._build_depth_and_euler()
        self._build_lift()

    # -- compact index mapping -------------------------------------------
    def _compact_scalar(self, tid: int) -> int:
        if tid == 0:
            return 0
        i = int(np.searchsorted(self.tax_ids, tid))
        if i >= len(self.tax_ids) or self.tax_ids[i] != tid:
            raise KeyError(f"taxid {tid} not in taxonomy")
        return i + 1

    def compact(self, taxids, missing_ok: bool = False) -> np.ndarray:
        """uint32 taxids -> compact indices; unknown ids -> 0 when
        missing_ok, else raise."""
        t = np.asarray(taxids, dtype=np.uint32)
        i = np.searchsorted(self.tax_ids, t)
        i_c = np.clip(i, 0, len(self.tax_ids) - 1)
        found = (self.tax_ids[i_c] == t) & (t != 0)
        if not missing_ok and not bool(np.all(found | (t == 0))):
            bad = t[~(found | (t == 0))]
            raise KeyError(f"taxids not in taxonomy: {bad[:10]}")
        return np.where(found, i_c + 1, 0).astype(np.int32)

    def original(self, compact_idx) -> np.ndarray:
        """Compact indices -> original uint32 taxids (0 for index 0)."""
        return self.tax_ids_compact()[np.asarray(compact_idx, dtype=np.int64)]

    def depth_of(self, taxids) -> np.ndarray:
        """node_depth of each taxid; 0 for a taxid absent from the tree."""
        return self.depth[self.compact(taxids, missing_ok=True)]

    def tax_ids_compact(self) -> np.ndarray:
        """(N,) u32: the original taxid of each compact index."""
        return np.concatenate([[0], self.tax_ids]).astype(np.uint32)

    # -- construction ----------------------------------------------------
    def _build_depth_and_euler(self):
        n = self._n
        parent = self.parent
        order = np.argsort(parent[1:], kind="stable") + 1
        sorted_parents = parent[order]
        starts = np.searchsorted(sorted_parents, np.arange(n))
        ends = np.searchsorted(sorted_parents, np.arange(n) + 1)
        depth = np.zeros(n, dtype=np.int32)
        tin = np.zeros(n, dtype=np.int32)
        tout = np.zeros(n, dtype=np.int32)
        counter = 0
        visited = np.zeros(n, dtype=bool)
        visited[0] = True
        for root in order[starts[0] : ends[0]]:
            stack = [(int(root), False)]
            while stack:
                node, done = stack.pop()
                if done:
                    tout[node] = counter - 1
                    continue
                if visited[node]:
                    continue  # cycle guard
                visited[node] = True
                depth[node] = depth[parent[node]] + 1
                tin[node] = counter
                counter += 1
                stack.append((node, True))
                for ch in order[starts[node] : ends[node]][::-1]:
                    if not visited[ch]:
                        stack.append((int(ch), False))
        # virtual node 0: never an ancestor, never a descendant
        tin[0] = -1
        tout[0] = -2
        self.depth = depth
        self.tin = tin
        self.tout = tout
        self.max_depth = int(depth.max()) if n > 1 else 0

    def _build_lift(self):
        levels = max(1, int(np.ceil(np.log2(max(self.max_depth, 2)))))
        lift = np.zeros((levels, self._n), dtype=np.int32)
        lift[0] = self.parent
        for j in range(1, levels):
            lift[j] = lift[j - 1][lift[j - 1]]
        self.lift = lift

    # -- host queries ----------------------------------------------------
    def _lca_compact(self, a, b) -> np.ndarray:
        """Vectorized pairwise LCA over compact indices (0 = none)."""
        a0 = np.asarray(a, dtype=np.int32)
        b0 = np.asarray(b, dtype=np.int32)
        a, b = a0.copy(), b0.copy()
        da = self.depth[a]
        db = self.depth[b]
        for j in range(self.lift.shape[0] - 1, -1, -1):
            step = 1 << j
            lift_a = (da - db) >= step
            a = np.where(lift_a, self.lift[j][a], a)
            da = np.where(lift_a, da - step, da)
            lift_b = (db - da) >= step
            b = np.where(lift_b, self.lift[j][b], b)
            db = np.where(lift_b, db - step, db)
        neq = a != b
        for j in range(self.lift.shape[0] - 1, -1, -1):
            pa = self.lift[j][a]
            pb = self.lift[j][b]
            move = neq & (pa != pb)
            a = np.where(move, pa, a)
            b = np.where(move, pb, b)
        res = np.where(neq, self.parent[a], a)
        # lca(x, 0) == x; lca(0, 0) == 0 (util.h:641-643)
        res = np.where(a0 == 0, b0, res)
        res = np.where(b0 == 0, np.where(a0 == 0, 0, a0), res)
        return res

    def node_depth(self, taxid: int) -> int:
        return int(self.depth[self._compact_scalar(taxid)])

    def is_ancestor(self, anc, desc) -> np.ndarray:
        a = self.compact(anc, missing_ok=True)
        d = self.compact(desc, missing_ok=True)
        return (self.tin[a] <= self.tin[d]) & (self.tin[d] <= self.tout[a])

    def lca(self, a: int, b: int) -> int:
        """Reference-exact pairwise LCA on original taxids (util.h:634-663):
        lca(a,a)=a, lca(x,0)=x, missing taxid -> 0xFFFFFFFF, disjoint -> 1."""
        if a == b:
            return a
        if b == 0:
            return a
        if a == 0:
            return b
        try:
            ca = self._compact_scalar(a)
            cb = self._compact_scalar(b)
        except KeyError:
            return TAX_MISSING
        r = int(self._lca_compact(np.array([ca]), np.array([cb]))[0])
        return int(self.original([r])[0]) if r else 1

    def lca_pairs(self, a, b) -> np.ndarray:
        """Vectorized LCA over original-taxid arrays with the scalar's
        precedence: a == b, then the 0 identities, then a missing taxid
        (TAX_MISSING), then disjoint roots (1)."""
        a = np.asarray(a, dtype=np.uint32)
        b = np.asarray(b, dtype=np.uint32)
        ca = self.compact(a, missing_ok=True)
        cb = self.compact(b, missing_ok=True)
        r = self._lca_compact(ca, cb)
        out = self.original(r)
        out = np.where((r == 0) & (ca != 0) & (cb != 0), 1, out)  # disjoint
        out = np.where(((ca == 0) & (a != 0)) | ((cb == 0) & (b != 0)),
                       TAX_MISSING, out)
        out = np.where(a == 0, b, out)
        out = np.where(b == 0, a, out)
        out = np.where(a == b, a, out)
        return out.astype(np.uint32)

    def lca_reduce(self, taxids: Iterable[int]) -> int:
        """Fold LCA over a collection (resolve_tree's tie handling); 0 for
        none."""
        it = iter(taxids)
        acc = next(it, 0)
        for t in it:
            acc = self.lca(acc, t)
        return acc

    def resolve_tree_host(self, hit_counts: Dict[int, int]) -> int:
        """Reference-exact resolve_tree (util.h:831-869): argmax over
        leaf-to-root path weights; ties -> LCA of the tied taxa."""
        max_taxa = []
        max_taxon, max_score = 0, 0
        for taxon in hit_counts:
            node, score = taxon, 0
            while node:
                score += hit_counts.get(node, 0)
                node = self.parent_map.get(node)
                if node is None:
                    break
            if score > max_score:
                max_taxa = []
                max_score = score
                max_taxon = taxon
            elif score == max_score:
                if not max_taxa:
                    max_taxa.append(max_taxon)
                if taxon not in max_taxa:
                    max_taxa.append(taxon)
        return self.lca_reduce(max_taxa) if max_taxa else max_taxon

    # -- inversion (metatree) ---------------------------------------------
    def invert(self) -> Dict[int, list]:
        """{parent: [children]} in the parent map's order."""
        inv: Dict[int, list] = {}
        for tid, p in self.parent_map.items():
            inv.setdefault(p, []).append(tid)
        return inv

    def descendants(self, taxid: int) -> list:
        """Every descendant of ``taxid``, in the JAX package's order (a
        depth-first walk from the end of each child list)."""
        inv = self.invert()
        out, stack = [], [taxid]
        while stack:
            for ch in inv.get(stack.pop(), ()):
                out.append(ch)
                stack.append(ch)
        return out

    def __len__(self) -> int:
        return len(self.parent_map)

    # -- device arrays ---------------------------------------------------
    def device_arrays(self, device) -> Dict[str, torch.Tensor]:
        """int32 tensors on ``device`` for the resolve kernel; ``tax_ids``
        holds u32 taxids in int32 storage."""
        arrs = dict(
            parent=self.parent, depth=self.depth, tin=self.tin,
            tout=self.tout, lift=self.lift,
            tax_ids=self.tax_ids_compact().view(np.int32),
        )
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrs.items()
        }

    @classmethod
    def from_nodes_dmp(cls, path: str) -> "TaxTree":
        from .ncbi import parse_nodes_dmp

        return cls(parse_nodes_dmp(path))
