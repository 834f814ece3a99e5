"""The JAX package's content digests of the other-alphabet builds that
``chip_smoke.py`` phase 9j holds the port's device builds to
(``ALPHABET_JAX`` there).  Imports the JAX package; ``chip_smoke.py``
imports none of it and carries the digests as constants.

The data: each of the 5 genomes of the golden manifest's "kraken" entry
(``tests/data/ec``, in its order), its three forward frames translated
into one FASTA file (``bonsai_tpu_torch.tools.synthetic.write_frames``),
whose first accession ``tests/data/golden/ec_nameidmap.txt`` resolves to
the genome's taxid; the tree ``tests/data/golden/ec_nodes.dmp``.  Each
build is the JAX host build (``use_device=False``), its digest the sha256
of the sorted little-endian keys, then values (``content_digest``):

    JAX_PLATFORMS=cpu python tests/alphabet_build_jax.py [OUT_DIR]

prints one line a build, ``name digest n seconds``, in ``BUILDS``'
order (about 2 min on one CPU core).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "data", "golden")

# name -> (input type, k, w, spacing, phase-1 map it is scored by, or None;
# "lca" for the classify map): the builds of phase 9j
BUILDS = {
    "PROTEIN20 -k 7 -t": ("PROTEIN20", 7, 7, "", None),
    "PROTEIN20 -k 7 -w 20": ("PROTEIN20", 7, 20, "", "PROTEIN20 -k 7 -t"),
    "PROTEIN_14 -k 10 -t": ("PROTEIN_14", 10, 10, "", None),
    "PROTEIN_14 -k 10 -w 24": ("PROTEIN_14", 10, 24, "",
                               "PROTEIN_14 -k 10 -t"),
    "PROTEIN_6 -k 12 -S 1x11 -t": ("PROTEIN_6", 12, 23, "1x11", None),
    "PROTEIN_6 -k 12 -S 1x11 -w 30": ("PROTEIN_6", 12, 30, "1x11",
                                      "PROTEIN_6 -k 12 -S 1x11 -t"),
    "PROTEIN20 -k 7 lca": ("PROTEIN20", 7, 7, "", "lca"),
}


def frame_files(out_dir: str):
    """The 5 translated genomes in ``out_dir``, in the manifest's order."""
    from bonsai_tpu_torch.tools.synthetic import write_frames

    kk = json.load(open(os.path.join(GOLD, "manifest.json")))["kraken"]
    return [write_frames(os.path.join(ROOT, "tests", "data", "ec", g),
                         os.path.join(out_dir, g.split(".fna")[0] + ".faa"))
            for g in kk["genomes"]]


def digest(table) -> str:
    h = hashlib.sha256()
    h.update(table.keys_sorted.astype("<u8").tobytes())
    h.update(table.vals_sorted.astype("<u8").tobytes())
    return h.hexdigest()


def main(out_dir: str) -> None:
    sys.path.insert(0, ROOT)
    from bonsai_tpu.core.alphabet import InputType
    from bonsai_tpu.core.spacer import Spacer, parse_spacing
    from bonsai_tpu.db import build
    from bonsai_tpu.taxonomy.tree import TaxTree

    paths = frame_files(out_dir)
    tree = TaxTree.from_nodes_dmp(os.path.join(GOLD, "ec_nodes.dmp"))
    nameid = os.path.join(GOLD, "ec_nameidmap.txt")
    done = {}
    for name, (it, k, w, spacing, by) in BUILDS.items():
        t0 = time.perf_counter()
        sp = Spacer(k, w, parse_spacing(spacing, k))
        it = InputType[it]
        if by is None:
            table = build.taxdepth_map(paths, tree, nameid, sp, True, it)
        elif by == "lca":
            table = build.lca_map(paths, tree, nameid, sp, True, "lex", it)
        else:
            table = build.minimized_map(paths, done[by], tree, nameid, sp,
                                        True, it)
        done[name] = table
        print(f"{name}\t{digest(table)}\t{table.n}\t"
              f"{time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        main(sys.argv[1])
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(tmp)
