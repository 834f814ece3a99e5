"""Port parity: ``classify`` against a spaced-seed database, on the CPU.

The ``spaced_k21`` golden database (``-k 21 -S 0x16,1x4``: span 25, W = 1,
never canonical) of the golden genomes, built by the port's CLI (its
content digest is the manifest's), classified by the port's
``Classifier(device="cpu")`` (the plain torch versions of K1-K3, with
K1's spaced encode) and by the JAX package's ``Classifier`` through each
package's CLI: single-end ``reads.fa`` with and without ``-a``, the
paired mates, FASTQ re-emission, and a probe image of the database that
the JAX CLI writes.  The ``A:`` counts use the seed's span, 25, not k.
Tolerance: the same bytes.
"""

import json
import os

import numpy as np
import pytest
import torch

from bonsai_tpu.cli import main as jmain

from bonsai_tpu_torch import cli
from bonsai_tpu_torch.classify.pipeline import Classifier
from bonsai_tpu_torch.db import formats
from bonsai_tpu_torch.db.build import content_digest
from bonsai_tpu_torch.taxonomy.tree import TaxTree

torch.set_num_threads(1)
GOLD = os.path.join(os.path.dirname(__file__), "data", "golden")
MANIFEST = json.load(open(os.path.join(GOLD, "manifest.json")))
SPACED = next(c for c in MANIFEST["configs"] if c["name"] == "spaced_k21")
GENOMES = [os.path.join(GOLD, f) for f in ("g_phix.fa", "g_phixmut.fa",
                                           "g_rand.fa")]
NODES = os.path.join(GOLD, "nodes.dmp")
NAMEID = os.path.join(GOLD, "nameidmap.txt")
READS = os.path.join(GOLD, "reads.fa")
MATES = [os.path.join(GOLD, f) for f in ("mate1.fa", "mate2.fa")]


@pytest.fixture(scope="module")
def spaced_db(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spaced") / "spaced.btpu")
    assert cli.main(["build", path, *GENOMES, *SPACED["flags"], "-T", NODES,
                     "-M", NAMEID]) == 0
    db = formats.load_database(path)
    assert content_digest(db.table) == SPACED["db_digest"]
    assert db.k == 21 and sum(db.gaps) == 4
    return path


def _both(db, argv, tmp_path):
    """The Kraken text of the JAX CLI and of the port's CLI on the CPU."""
    jout, tout = str(tmp_path / "jax.out"), str(tmp_path / "torch.out")
    assert jmain(["classify", db, NODES, *argv, "-o", jout]) == 0
    assert cli.main(["classify", db, NODES, *argv, "--device", "cpu", "-o",
                     tout]) == 0
    return open(jout, "rb").read(), open(tout, "rb").read()


@pytest.mark.parametrize("argv", [["-a", READS], [READS], ["-a", *MATES],
                                  ["-a", "-f", READS]],
                         ids=["single-a", "single", "paired-a", "fastq-a"])
def test_spaced_classify_matches_jax(spaced_db, argv, tmp_path):
    want, got = _both(spaced_db, argv, tmp_path)
    assert len(want.splitlines()) >= 100
    assert got == want


def test_spaced_probe_image_matches_jax(spaced_db, tmp_path):
    img = str(tmp_path / "image")
    assert jmain(["probe-image", spaced_db, NODES, img]) == 0
    assert formats.is_probe_image(img)
    want, _ = _both(spaced_db, ["-a", READS], tmp_path)
    out = str(tmp_path / "image.out")
    assert cli.main(["classify", img, NODES, "-a", READS, "--device", "cpu",
                     "-o", out]) == 0
    assert open(out, "rb").read() == want


def test_spaced_classifier_uses_the_span(spaced_db):
    """P = lproc - c + 1 positions a read; canonicalization is off."""
    tree = TaxTree.from_nodes_dmp(NODES)
    clf = Classifier(formats.load_database(spaced_db), tree, device="cpu")
    assert clf.sp.c == 25 and not clf.canon
    assert clf.positions[-1] == 24 and len(clf.positions) == 21
    seq = open(GENOMES[0]).read().split("\n", 1)[1].replace("\n", "")[:90]
    taxon = clf.classify_reads([seq.encode()])
    assert np.asarray(taxon).shape == (1,) and int(taxon[0]) != 0
