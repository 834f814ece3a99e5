"""The JAX package's Kraken text of the other-alphabet classify runs that
``chip_smoke.py`` phase 9k holds the port to (``CLASSIFY_JAX`` there).
Imports the JAX package; ``chip_smoke.py`` imports none of it and carries
the digests as constants.

The data: the 5 ec genomes' forward frames translated
(``alphabet_build_jax.frame_files``), the tree
``tests/data/golden/ec_nodes.dmp``; the databases, JAX host builds
(``lca_map``): PROTEIN20 -k 7 over the 5 genomes (its digest is
``alphabet_build_jax``'s "PROTEIN20 -k 7 lca") and PROTEIN_3BIT -k 12 -S
1x11 over the first 2; the reads ``bonsai_tpu_torch.tools.synthetic
.protein_reads`` of ``ALPHABET_READ_SETS``.  The reference is the JAX
step on int8 codes: ``ShardedClassifier`` on a 1 x 1 CPU mesh with the
input type, ``classify_batch`` a batch of 8192 reads (``batch_reads``),
each formatted by ``format_batch`` with emit_all (``-a``):

    JAX_PLATFORMS=cpu python tests/alphabet_classify_jax.py [OUT_DIR]

prints the sha256 of each read file, each database's content digest and
k-mers, and each run's Kraken text sha256 and lines (a few minutes on
one CPU core).
"""

from __future__ import annotations

import hashlib
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from alphabet_build_jax import GOLD, ROOT, digest, frame_files  # noqa: E402

# name -> (input type, k, spacing, genomes, the read set it classifies)
DATABASES = {
    "PROTEIN20 -k 7": ("PROTEIN20", 7, "", 5,
                       ("PROTEIN20 single", "PROTEIN20 paired")),
    "PROTEIN_3BIT -k 12 -S 1x11": ("PROTEIN_3BIT", 12, "1x11", 2,
                                   ("PROTEIN_3BIT single",)),
}
BATCH = 8192


def sha(path: str) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def main(out_dir: str) -> None:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from bonsai_tpu.classify.output import format_batch
    from bonsai_tpu.core.alphabet import InputType
    from bonsai_tpu.core.spacer import Spacer, parse_spacing
    from bonsai_tpu.db import build
    from bonsai_tpu.db.formats import Database
    from bonsai_tpu.io import fastx
    from bonsai_tpu.parallel.mesh import make_mesh
    from bonsai_tpu.parallel.sharded import ShardedClassifier
    from bonsai_tpu.taxonomy.tree import TaxTree
    from bonsai_tpu_torch.tools.synthetic import (ALPHABET_READ_SETS,
                                                  protein_reads, write_reads)

    frames = frame_files(out_dir)
    tree = TaxTree.from_nodes_dmp(os.path.join(GOLD, "ec_nodes.dmp"))
    nameid = os.path.join(GOLD, "ec_nameidmap.txt")
    for name, (it, k, spacing, ng, sets) in DATABASES.items():
        t0 = time.perf_counter()
        sp = Spacer(k, 0, parse_spacing(spacing, k))
        table = build.lca_map(frames[:ng], tree, nameid, sp, True, "lex",
                              InputType[it])
        print(f"db {name}\t{digest(table)}\t{table.n}\t"
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        db = Database(table=table, k=k, w=sp.w, gaps=list(sp.gaps))
        sc = ShardedClassifier(db, tree, make_mesh({"dp": 1, "db": 1}),
                               input_type=InputType[it], emit_all=True)
        for rs in sets:
            n, seed, paired, rng_ng = ALPHABET_READ_SETS[rs]
            got = protein_reads(frames[:rng_ng], n, seed, paired=paired)
            stem = os.path.join(out_dir, rs.replace(" ", "_"))
            paths = ([write_reads(f"{stem}.1.fa", got[0]),
                      write_reads(f"{stem}.2.fa", got[1])] if paired else
                     [write_reads(f"{stem}.fa", got)])
            t0 = time.perf_counter()
            text = "".join(
                format_batch(sc.classify_batch(b, paired), sc.sp.c,
                             emit_all=True)
                for b in fastx.batch_reads(
                    paths[0], sc.lut, batch_size=BATCH,
                    mate_path=paths[1] if paired else None))
            print(f"reads {rs}\t{' '.join(sha(p) for p in paths)}", flush=True)
            print(f"text {rs}\t"
                  f"{hashlib.sha256(text.encode()).hexdigest()}\t"
                  f"{len(text.splitlines())}\t"
                  f"{time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        main(sys.argv[1])
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(tmp)
