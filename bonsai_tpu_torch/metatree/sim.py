"""Synthetic-taxonomy genome simulator for metatree validation.

Counterpart of ``bonsai_tpu/metatree/sim.py`` (the reference's
sim/{fa,main}.py): a known taxonomy and genomes that share sequence
blocks per internal node, plus CROSS-CLADE shared blocks that the
taxonomy does NOT explain, the signal FMEmitter should find.  The same
seed writes the same files, byte for byte, as the JAX package's."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

_BASES = np.array(list(b"ACGT"), dtype=np.uint8)


def _rand_seq(rng, n: int) -> bytes:
    return _BASES[rng.integers(0, 4, n)].tobytes()


def simulate(
    out_dir: str,
    n_parents: int = 2,
    leaves_per_parent: int = 4,
    block: int = 2000,
    seed: int = 0,
    cross_pairs: Sequence[Tuple[int, int]] = ((0, 1),),
):
    """Create genomes + taxonomy.

    Tree: root(1) -> parents(10, 11, ...) -> leaves(100, 101, ...).
    Every genome = [root block][parent block][cross blocks][unique block].
    cross_pairs are (leaf_index, leaf_index) pairs under the SAME parent
    that share an extra block the taxonomy doesn't explain.

    Returns (tree_parent_map, name_map, tax_to_paths)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    root_blk = _rand_seq(rng, block)
    parent_map: Dict[int, int] = {1: 0}
    name_map: Dict[str, int] = {}
    tax_to_paths: Dict[int, List[str]] = {}
    for p in range(n_parents):
        ptax = 10 + p
        parent_map[ptax] = 1
        parent_blk = _rand_seq(rng, block)
        cross_blks = {pair: _rand_seq(rng, block) for pair in cross_pairs}
        for leaf in range(leaves_per_parent):
            ltax = 100 + p * leaves_per_parent + leaf
            parent_map[ltax] = ptax
            parts = [root_blk, parent_blk]
            for (a, b), blk in cross_blks.items():
                if leaf in (a, b):
                    parts.append(blk)
            parts.append(_rand_seq(rng, block))
            name = f"leaf_{ltax}"
            path = os.path.join(out_dir, f"{name}.fa")
            with open(path, "w") as fh:
                fh.write(f">{name}\n")
                seq = b"".join(parts).decode()
                for i in range(0, len(seq), 80):
                    fh.write(seq[i : i + 80] + "\n")
            name_map[name] = ltax
            tax_to_paths[ltax] = [path]
    return parent_map, name_map, tax_to_paths
