"""Port parity: the sharded classifier through the CLI on the CPU.

``classify --db-shards 2 --route a2a|psum --device cpu`` of the lex_k25
golden database gives the oracle goldens and the JAX CLI's text (its
``--db-shards 2`` on the virtual 8-device mesh); a ``build --shards 4``
directory classified a rank at a time (``--db-shards 4``, and 2: two
files a rank) and from per-rank images (``probe-image DIR --db-ranks
N``); ``merge-parts`` of per-rank output; the errors.  Tolerance: equal
bytes.
"""

import gzip
import io
import json
import os

import pytest

from bonsai_tpu.cli import main as jmain

from bonsai_tpu_torch import cli
from bonsai_tpu_torch.db import formats as tformats
from bonsai_tpu_torch.parallel import sharded
from bonsai_tpu_torch.parallel.mesh import make_mesh
from bonsai_tpu_torch.taxonomy.tree import TaxTree

GOLD = os.path.join(os.path.dirname(__file__), "data", "golden")
MANIFEST = json.load(open(os.path.join(GOLD, "manifest.json")))
GENOMES = [os.path.join(GOLD, f)
           for f in ("g_phix.fa", "g_phixmut.fa", "g_rand.fa")]
NODES = os.path.join(GOLD, "nodes.dmp")
READS = os.path.join(GOLD, "reads.fa")


def _golden(gz):
    with gzip.open(os.path.join(GOLD, gz), "rb") as fh:
        return fh.read()


def _args(extra):
    return [a if a.startswith("-") else os.path.join(GOLD, os.path.basename(a))
            for a in extra]


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """The lex_k25 database as a BTPU1 file and a --shards 4 directory."""
    d = tmp_path_factory.mktemp("db")
    cfg = next(c for c in MANIFEST["configs"]
               if c["name"] == MANIFEST["classify"]["db"])
    base = [*GENOMES, *cfg["flags"], "-T", NODES, "-M",
            os.path.join(GOLD, "nameidmap.txt")]
    assert cli.main(["build", str(d / "lex.btpu"), *base]) == 0
    assert cli.main(["build", str(d / "sh4"), *base, "--shards", "4",
                     "--device", "cpu"]) == 0
    return d


@pytest.mark.parametrize("route", ["a2a", "psum"])
@pytest.mark.parametrize("gz", sorted(MANIFEST["classify"]["outputs"]))
def test_classify_db_shards_matches_the_goldens(dbs, tmp_path, route, gz):
    extra = _args(MANIFEST["classify"]["outputs"][gz])
    out = str(tmp_path / "out")
    assert cli.main(["classify", str(dbs / "lex.btpu"), NODES,
                     *[a for a in extra if not a.startswith("-")],
                     *[a for a in extra if a.startswith("-")],
                     "--db-shards", "2", "--route", route, "--device", "cpu",
                     "-o", out]) == 0
    assert open(out, "rb").read() == _golden(gz)


@pytest.mark.parametrize("route", ["a2a", "psum"])
def test_classify_db_shards_matches_the_jax_cli(dbs, tmp_path, route):
    for reads in ([READS], [os.path.join(GOLD, "mate1.fa"),
                            os.path.join(GOLD, "mate2.fa")]):
        out, jout = str(tmp_path / "t"), str(tmp_path / "j")
        common = ["classify", str(dbs / "lex.btpu"), NODES, *reads, "-a",
                  "--db-shards", "2", "--route", route, "-o"]
        assert jmain(common + [jout]) == 0
        assert cli.main(common + [out, "--device", "cpu"]) == 0
        assert open(out, "rb").read() == open(jout, "rb").read()


@pytest.mark.parametrize("shards", ["4", "2", "3"])
def test_classify_a_sharded_directory_a_rank_at_a_time(dbs, tmp_path, shards):
    """One file a rank (4), two (2), and a split that does not divide the
    files (3: merge-loaded), each the golden text."""
    out = str(tmp_path / "out")
    assert cli.main(["classify", str(dbs / "sh4"), NODES, READS, "-a",
                     "--db-shards", shards, "--device", "cpu", "-o",
                     out]) == 0
    assert open(out, "rb").read() == _golden("classify_se.tsv.gz")


@pytest.mark.parametrize("ranks", ["4", "2"])
def test_probe_image_db_ranks_then_classify(dbs, tmp_path, ranks):
    d = tmp_path / "sh"
    os.makedirs(d)
    for f in os.listdir(dbs / "sh4"):
        if not os.path.isdir(dbs / "sh4" / f):
            (d / f).write_bytes((dbs / "sh4" / f).read_bytes())
    assert cli.main(["probe-image", str(d), NODES, "--db-ranks", ranks]) == 0
    tree = TaxTree.from_nodes_dmp(NODES)
    sc = sharded.ShardedClassifier.from_sharded_dir(
        str(d), tree, make_mesh({"dp": 1, "db": int(ranks)}, ["cpu"]))
    assert sc._rank_images_used
    out = str(tmp_path / "out")
    assert cli.main(["classify", str(d), NODES, READS, "-a", "--db-shards",
                     ranks, "--device", "cpu", "-o", out]) == 0
    assert open(out, "rb").read() == _golden("classify_se.tsv.gz")


def test_merge_parts_gives_the_one_process_stream(dbs, tmp_path, capsys):
    """Per-rank output in one process over in-process ranks: one part,
    which merge-parts turns back into the one-process text; a stale part
    of another run's process count is refused."""
    tree = TaxTree.from_nodes_dmp(NODES)
    db = tformats.load_database(str(dbs / "lex.btpu"))
    for route in ("a2a", "psum"):
        sc = sharded.ShardedClassifier(db, tree, make_mesh({"dp": 2, "db": 2}, ["cpu"]),
                                       route=route, emit_all=True)
        parts = tmp_path / route
        n = sc.process_dataset_distributed(READS, str(parts), batch_size=64)
        assert sorted(os.listdir(parts)) == ["part-00000.tsv",
                                             "part-00000.tsv.idx"]
        out = str(tmp_path / f"{route}.tsv")
        assert cli.main(["merge-parts", str(parts), "-o", out]) == 0
        got = open(out, "rb").read()
        assert got == _golden("classify_se.tsv.gz")
        assert n == got.count(b"\n")
        idx = json.load(open(parts / "part-00000.tsv.idx"))
        idx["pid"], idx["nproc"] = 1, 2
        json.dump(idx, open(parts / "part-00001.tsv.idx", "w"))
        (parts / "part-00001.tsv").write_bytes(b"")
        (parts / "part-00002.tsv").write_bytes(b"")
        json.dump(dict(idx, pid=2, nproc=3),
                  open(parts / "part-00002.tsv.idx", "w"))
        with pytest.raises(ValueError, match="do not form one complete run"):
            sharded.merge_distributed_output(str(parts), io.StringIO())
    assert "merged" in capsys.readouterr().err


def test_db_shards_errors(dbs, tmp_path, capsys):
    img = str(tmp_path / "img")
    assert cli.main(["probe-image", str(dbs / "lex.btpu"), NODES, img]) == 0
    assert cli.main(["classify", img, NODES, READS, "--db-shards", "2",
                     "--device", "cpu"]) == 2
    assert "not a probe image" in capsys.readouterr().err
    assert cli.main(["classify", str(dbs / "lex.btpu"), NODES, READS,
                     "--db-shards", "2", "--distributed", "-o",
                     str(tmp_path / "p"), "--device", "cpu"]) == 2
    assert "torchrun" in capsys.readouterr().err
