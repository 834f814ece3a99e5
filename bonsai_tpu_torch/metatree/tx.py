"""TaxonomyReformation: renumber a taxonomy 1..N by depth, splitting taxa
with multiple genomes into fresh synthetic leaves.

Counterpart of ``bonsai_tpu/metatree/tx.py`` (the reference's
tx.h:36-198), host Python with the same maps: when several genomes map
to the same taxid, each gets a new taxid (max_tax + 1, ..., in sorted
path order; the reference draws them from mt19937, tx.h:84-97) whose
parent is the original taxon; every taxon is then renumbered 1..N in
order of (node depth, taxid), and old<->new maps are kept.
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Sequence, TextIO

from ..taxonomy.ncbi import accession_from_header
from ..taxonomy.tree import TaxTree


def _taxid_of_path(path: str, name_map: Dict[str, int]):
    """Accession of the first header -> taxid, None if unmapped (the
    reference's get_taxid returns tax_t(-1) there, tx.h:150-153)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        first = fh.readline()
    return name_map.get(accession_from_header(first.strip()))


class TaxonomyReformation:
    def __init__(
        self,
        name_map: Dict[str, int],
        paths: Sequence[str],
        tree: TaxTree,
        panic_on_undef: bool = False,
    ):
        self.tree = tree
        # 1. group genomes by taxid
        path_map: Dict[int, List[str]] = {}
        for p in paths:
            tid = _taxid_of_path(p, name_map)
            if tid is None:
                if panic_on_undef:
                    raise KeyError(f"no taxid for {p}")
                continue
            path_map.setdefault(tid, []).append(p)

        # 2. split multi-genome taxa into synthetic leaves
        parent_aug: Dict[int, int] = dict(tree.parent_map)
        self.newid_path_map: Dict[int, str] = {}
        next_id = max(parent_aug, default=1) + 1
        for tid in sorted(t for t, ps in path_map.items() if len(ps) > 1):
            for p in sorted(path_map[tid]):
                parent_aug[next_id] = tid
                path_map[next_id] = [p]
                self.newid_path_map[next_id] = p
                next_id += 1
            del path_map[tid]

        # 3. renumber 1..N sorted by depth (root-path length in the
        #    augmented taxonomy)
        aug_tree = TaxTree(parent_aug)
        order = sorted(parent_aug, key=lambda t: (aug_tree.node_depth(t), t))
        self.old_to_new: Dict[int, int] = {}
        self.new_to_old: List[int] = [0]  # new id 0 unused; 1 = root
        for tid in order:
            self.old_to_new[tid] = len(self.new_to_old)
            self.new_to_old.append(tid)

        # 4. new parent map in renumbered space
        new_parent: Dict[int, int] = {}
        for tid, pid in parent_aug.items():
            new_parent[self.old_to_new[tid]] = (
                self.old_to_new.get(pid, 0) if pid != 0 else 0
            )
        self.new_tree = TaxTree(new_parent)

        # 5. name map and genome map in new-id space
        self.name_map_new: Dict[str, int] = {
            name: self.old_to_new[tid]
            for name, tid in name_map.items()
            if tid in self.old_to_new
        }
        self.path_map_new: Dict[int, List[str]] = {
            self.old_to_new[tid]: ps for tid, ps in path_map.items()
        }

    def taxid_of(self, old: int) -> int:
        return self.old_to_new[old]

    def old_id(self, new: int) -> int:
        return self.new_to_old[new]

    def write_mapping(self, fp: TextIO):
        """newtaxprintf (tx.h:129-143)."""
        fp.write("#New ID\tGenome path (NEW FIRST)\n")
        for nid in sorted(self.newid_path_map):
            fp.write(f"{self.old_to_new[nid]}\t{self.newid_path_map[nid]}\n")
        fp.write("#Old ID\tNew ID\n")
        for old in sorted(self.old_to_new):
            fp.write(f"{old}\t{self.old_to_new[old]}\n")
