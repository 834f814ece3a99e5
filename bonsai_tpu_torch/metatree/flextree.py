"""FlexMap / FMEmitter: scoring and emission of candidate taxonomy nodes.

Counterpart of ``bonsai_tpu/metatree/flextree.py`` (the reference's
flextree.h:16-300).  A candidate node is a bit PATTERN (a subset of a
parent's child clades whose genomes share k-mers); its score is

    score = (bc - pc) * n + desc_pts          (get_score, flextree.h:36-38)

with n = #k-mers showing the pattern, pc = popcount, bc = #clades in the
subtree, and desc_pts the subsume-transfer term (fnode_t::subsume,
flextree.h:29-33).  run_collapse emits the top-scoring nodes as fresh
taxids until the budget (roundup64(|tax|) - |tax| by default) is spent.

The patterns come from ``bitsets`` on ``device``; the scoring, the
condensing and the emission are host Python, as in the JAX package, and
keep its order: ``condense`` walks the patterns in their row order and
``run_collapse`` sorts the candidates stably, so ties emit the same node.
Both deviations of the JAX package from the reference hold here too:
the emitted node is the one marked added (flextree.h:267-269 marks the
node after it), and condense_subtree is wired in (flextree.h:271 leaves
its call commented out).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, List, TextIO

import numpy as np

from ..core.spacer import Spacer
from ..db.build_device import as_device
from ..taxonomy.tree import TaxTree
from .bitsets import (
    KmerGenomeSets,
    bitmap_patterns,
    pairwise_veccmp,
    vec_popcnt,
)


def roundup64(x: int) -> int:
    """Next power of two (util.h roundup64)."""
    return 1 << max(int(x - 1).bit_length(), 0)


@dataclass
class FNode:
    """fnode_t (flextree.h:16-34)."""

    pattern: np.ndarray  # (W,) u64
    n: int  # k-mers with this pattern
    pc: int  # popcount
    bc: int  # clades in subtree
    subtree: int  # subtree index
    desc_pts: int = 0
    added: bool = False

    def score(self) -> int:
        return (self.bc - self.pc) * self.n + self.desc_pts

    def subsume(self, other: "FNode"):
        tmp = (self.bc - self.pc) * other.n
        self.desc_pts += tmp
        other.desc_pts -= tmp


class FlexMap:
    """Per-subtree pattern map (flextree.h:47-116)."""

    def __init__(self, parent: int, ntaxes: int, subtree_id: int,
                 device="cuda"):
        self.parent = int(parent)
        self.bitcount = int(ntaxes)
        self.id = int(subtree_id)
        self.device = as_device(device)
        self.taxes: List[int] = []
        self.nodes: List[FNode] = []
        self.n = 0

    def fill(
        self,
        tax_to_paths: Dict[int, List[str]],
        sp: Spacer,
        canonicalize: bool = True,
        acceptable=None,
    ):
        self.taxes = [int(t) for t in tax_to_paths]
        kgs = KmerGenomeSets(tax_to_paths, sp, canonicalize, acceptable,
                             device=self.device)
        patterns, counts = bitmap_patterns(kgs)
        pcs = vec_popcnt(patterns) if patterns.size else np.empty(0, np.int64)
        self.nodes = [
            FNode(
                pattern=patterns[i],
                n=int(counts[i]),
                pc=int(pcs[i]),
                bc=self.bitcount,
                subtree=self.id,
            )
            for i in range(patterns.shape[0])
        ]
        self.n = int(counts.sum()) if counts.size else 0

    def condense(self):
        """condense_subtree (flextree.h:196-236): transfer score between
        nested patterns via subsume."""
        if len(self.nodes) < 2:
            return
        pats = np.stack([nd.pattern for nd in self.nodes])
        sup, sub = pairwise_veccmp(pats, self.device)
        strict_sup = sup & ~sub
        for i in range(len(self.nodes)):
            if self.nodes[i].added:
                continue
            for j in np.nonzero(strict_sup[i])[0]:
                if j <= i or self.nodes[j].added:
                    continue
                self.nodes[i].subsume(self.nodes[j])


class FMEmitter:
    """Global emitter (flextree.h:118-300)."""

    def __init__(
        self,
        tree: TaxTree,
        tax_to_paths: Dict[int, List[str]],
        canonicalize: bool = True,
        max_heap_size: int = 1 << 8,
        to_add: int = 0,
        condense: bool = True,
        device="cuda",
    ):
        self.tree = tree
        self.tpm = tax_to_paths
        self.canon = canonicalize
        self.max_heap_size = max_heap_size
        self.device = as_device(device)
        ntax = len(tree)
        self.left_to_add = (to_add if to_add else roundup64(ntax)) - ntax
        if self.left_to_add <= 0:
            self.left_to_add = to_add if to_add else 1
        self.subtrees: List[FlexMap] = []
        self.condense_flag = condense

    def process_subtree(
        self,
        parent: int,
        taxes,
        sp: Spacer,
        acceptable=None,
    ) -> bool:
        """Build a FlexMap over the child taxes of `parent`
        (flextree.h:287-299)."""
        tmp = {t: self.tpm[t] for t in taxes if t in self.tpm and self.tpm[t]}
        if len(tmp) < 2:
            return False  # emplace_subtree skips single-element subtrees
        fm = FlexMap(parent, len(tmp), len(self.subtrees), self.device)
        fm.fill(tmp, sp, self.canon, acceptable)
        if self.condense_flag:
            fm.condense()
        self.subtrees.append(fm)
        return True

    def run_collapse(self, maxtax: int, fp: TextIO = sys.stdout) -> List[dict]:
        """Emit the top-scoring candidate nodes as new taxids
        (flextree.h:240-292).  Returns the emitted records."""
        fp.write("#Taxid (inserted)\tScore\tParent\tChildren [comma-separated]\n")
        emitted = []
        while self.left_to_add > 0:
            candidates = [
                nd
                for fm in self.subtrees
                for nd in fm.nodes
                if not nd.added
            ]
            if not candidates:
                break
            candidates.sort(key=lambda nd: nd.score(), reverse=True)
            for nd in candidates[: self.max_heap_size]:
                if self.left_to_add <= 0:
                    break
                maxtax += 1
                nd.added = True
                fm = self.subtrees[nd.subtree]
                children = [
                    fm.taxes[t]
                    for t in range(fm.bitcount)
                    if nd.pattern[t >> 6] >> np.uint64(t & 63) & np.uint64(1)
                ]
                rec = dict(
                    taxid=maxtax,
                    score=nd.score(),
                    parent=fm.parent,
                    children=children,
                )
                emitted.append(rec)
                fp.write(
                    f"{maxtax}\t{nd.score()}\t{fm.parent}\t"
                    + ",".join(str(c) for c in children)
                    + "\n"
                )
                self.left_to_add -= 1
        return emitted
