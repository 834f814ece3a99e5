"""Per-taxon k-mer sets, k-mer x taxon bit matrices, and subset compares.

Counterpart of ``bonsai_tpu/metatree/bitsets.py`` (the reference's
kgset_t, kgset.h:48-124; bitmap_t / AdjacencyList / score_node_addn,
bitmap.h:8-150; veccmp, bitcmp.h:18-65), with the same numpy results:

  * ``KmerGenomeSets``: each genome's sorted distinct (canonical) k-mers
    from ``genome_kmer_set(use_device=True)``, KB1 on ``device`` (its
    plain version on the CPU), united per taxon on the host;
  * ``bitmap_patterns``: one stable sort of every (k-mer, taxon) pair by
    the unsigned k-mer on the device, one packed-u64 row a distinct
    k-mer (the owner bits added with ``index_add_``: every pair is
    distinct, so the sum of distinct bits is their OR), the rows in 1 or
    in all T sets dropped, then the distinct rows counted in
    ``np.lexsort``'s order (word 0 first, unsigned);
  * ``pairwise_veccmp``: the all-pairs subset compare as (rows, P, W)
    bitwise reductions on the device, in blocks of rows that fit a
    budget.

The metatree bit matrix and the subset compares are library calls on the
card; no TPU kernel lies behind them (the JAX package computes them in
numpy).
"""

from __future__ import annotations

from enum import IntEnum
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.bitops import SIGN, as_keys, popcount64_plain
from ..core.spacer import Spacer
from ..db import build as build_mod
from ..db.build_device import as_device
from ..db.table import unique_u64

PAIRWISE_BYTES = 1 << 28  # device bytes a block of pairwise_veccmp takes


class BitCmp(IntEnum):
    """bitcmp.h:7-12 (values match the reference enum)."""

    EQUAL = 0
    FIRST_PARENT = 1
    SECOND_PARENT = 2
    INCOMPARABLE = 3


_POP8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def vec_popcnt(rows: np.ndarray) -> np.ndarray:
    """Popcount of packed-u64 rows (pop::vec_popcnt)."""
    b = rows.view(np.uint8)
    return _POP8[b].reshape(rows.shape[0], -1).sum(axis=1)


def veccmp(a: np.ndarray, b: np.ndarray) -> BitCmp:
    """Subset-compare two packed bitvectors (bitcmp.h:18-65)."""
    a_sub_b = not np.any(a & ~b)  # a's bits all in b  -> b could be parent
    b_sub_a = not np.any(b & ~a)
    if a_sub_b and b_sub_a:
        return BitCmp.EQUAL
    if b_sub_a:
        return BitCmp.FIRST_PARENT  # a is a strict parent of b
    if a_sub_b:
        return BitCmp.SECOND_PARENT
    return BitCmp.INCOMPARABLE


def pairwise_veccmp(patterns: np.ndarray, device="cuda"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """All-pairs subset classification of (P, W) packed rows on
    ``device``.

    Returns boolean (P, P) matrices (i_superset_j, i_subset_j), both
    including equality; strict relations are the and-nots."""
    dev = as_device(device)
    p = torch.from_numpy(
        np.ascontiguousarray(patterns, dtype=np.uint64).view(np.int64)
    ).to(dev)
    P, W = p.shape
    sup = torch.empty((P, P), dtype=torch.bool, device=dev)
    sub = torch.empty((P, P), dtype=torch.bool, device=dev)
    step = max(1, PAIRWISE_BYTES // max(8 * P * W, 1))
    b = p[None, :, :]
    for i in range(0, P, step):
        a = p[i : i + step, None, :]
        sup[i : i + step] = ((b & ~a) == 0).all(-1)
        sub[i : i + step] = ((a & ~b) == 0).all(-1)
    return sup.cpu().numpy(), sub.cpu().numpy()


class KmerGenomeSets:
    """kgset_t: per-taxon (or per-path) canonical k-mer sets, each
    genome's from KB1 on ``device``."""

    def __init__(
        self,
        tax_to_paths: Dict[int, List[str]],
        sp: Spacer,
        canonicalize: bool = True,
        acceptable: Optional[np.ndarray] = None,  # sorted u64 filter set
        scheme: str = "lex",
        device="cuda",
    ):
        self.device = as_device(device)
        self.taxes: List[int] = []
        self.sets: List[np.ndarray] = []
        for tax, paths in tax_to_paths.items():
            per = [build_mod.genome_kmer_set(p, sp, canonicalize, scheme,
                                             use_device=True,
                                             device=self.device)
                   for p in paths]
            s = (unique_u64(np.concatenate(per)) if per
                 else np.empty(0, np.uint64))
            if acceptable is not None and s.size:
                idx = np.searchsorted(acceptable, s)
                idx = np.minimum(idx, acceptable.size - 1)
                s = s[acceptable[idx] == s] if acceptable.size else s[:0]
            self.taxes.append(int(tax))
            self.sets.append(s)

    def size(self) -> int:
        return len(self.sets)

    def weight(self) -> int:
        """Total k-mers across sets (kgset.h:114-120)."""
        return int(sum(s.size for s in self.sets))


def bitmap_patterns(
    kgs: KmerGenomeSets, drop_trivial: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """k-mer x taxon presence -> distinct packed bit patterns + counts, on
    ``kgs.device``.

    bitmap_t::fill + to_counter (bitmap.h:74-138): build each k-mer's
    bitvector over the T sets, drop k-mers present in exactly 1 or all T
    sets (compressed by the existing taxonomy), and count identical
    patterns.  Each set must hold distinct k-mers, as KmerGenomeSets'
    do.  Returns (patterns (P, W) u64, counts (P,) int64)."""
    T = kgs.size()
    W = max((T + 63) >> 6, 1)
    empty = (np.empty((0, W), np.uint64), np.empty(0, np.int64))
    if T == 0:
        return empty
    dev = kgs.device
    kmers = torch.cat([as_keys(s, dev) for s in kgs.sets])
    owners = torch.repeat_interleave(
        torch.arange(T, device=dev),
        torch.tensor([s.size for s in kgs.sets], device=dev))
    _, order = torch.sort(kmers ^ SIGN, stable=True)
    kmers, owners = kmers[order], owners[order]
    first = torch.ones(kmers.shape[0], dtype=torch.bool, device=dev)
    first[1:] = kmers[1:] != kmers[:-1]
    row_of = torch.cumsum(first, 0) - 1
    n_rows = int(row_of[-1]) + 1 if kmers.numel() else 0
    rows = torch.zeros(n_rows * W, dtype=torch.int64, device=dev)
    rows.index_add_(0, row_of * W + (owners >> 6),
                    torch.ones_like(owners) << (owners & 63))
    rows = rows.view(n_rows, W)
    if drop_trivial:
        pc = popcount64_plain(rows).sum(1)
        rows = rows[(pc != 1) & (pc != T)]
    if rows.numel() == 0:
        return empty
    # distinct patterns + counts in np.lexsort's order: a stable sort by
    # each word, the last first, unsigned (bit 63 flipped)
    perm = torch.arange(rows.shape[0], device=dev)
    for w in range(W - 1, -1, -1):
        _, o = torch.sort(rows[perm, w] ^ SIGN, stable=True)
        perm = perm[o]
    rows = rows[perm]
    firstp = torch.ones(rows.shape[0], dtype=torch.bool, device=dev)
    firstp[1:] = (rows[1:] != rows[:-1]).any(1)
    starts = torch.nonzero(firstp).squeeze(1)
    counts = torch.diff(starts, append=starts.new_tensor([rows.shape[0]]))
    return (rows[starts].cpu().numpy().view(np.uint64),
            counts.cpu().numpy().astype(np.int64))


def adjacency(
    patterns: np.ndarray, reverse: bool = False, device="cuda"
) -> List[np.ndarray]:
    """AdjacencyList (bitmap.h:8-66): adj[i] = indices j where pattern i is
    a STRICT parent (superset) of pattern j (children if reverse)."""
    sup, sub = pairwise_veccmp(patterns, device)
    strict_parent = sup & ~sub  # superset and not equal
    if reverse:
        strict_parent = strict_parent.T
    np.fill_diagonal(strict_parent, False)
    return [np.nonzero(strict_parent[i])[0] for i in range(patterns.shape[0])]


def score_node_addn(
    i: int,
    adj: List[np.ndarray],
    patterns: np.ndarray,
    counts: np.ndarray,
    nelem: int,
) -> int:
    """score_node_addn (bitmap.h:141-150): count_i * (nelem - pc_i) +
    sum over strict children j of count_j * pc_j."""
    pc = vec_popcnt(patterns)
    ret = int(counts[i]) * (nelem - int(pc[i]))
    for j in adj[i]:
        ret += int(counts[j]) * int(pc[j])
    return ret
