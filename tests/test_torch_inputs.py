"""The port's input and output paths beside the kernels, on the CPU.

* ``classify`` reads .xz and .bz2 reads (single-end and paired) through
  the record reader, to the goldens' bytes and the JAX CLI's;
* ``.zst`` goes through the zstd binary, else the zstandard module, else
  raises as the JAX package does;
* ``classify`` of a database or input the port refuses (not BTPU1,
  k > 32) exits 2;
* ``build -z`` writes gzipped BTPU1 whatever the file's name, with the
  bytes of ``build`` inside and of the JAX CLI's ``build -z``.

Every file is made in ``tmp_path``.  Tolerance: exact bytes.
"""

import bz2
import gzip
import json
import lzma
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from bonsai_tpu_torch import cli
from bonsai_tpu_torch.core.alphabet import DNA4
from bonsai_tpu_torch.db import formats as tformats
from bonsai_tpu_torch.io import fastx

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(__file__), "data")
GOLD = os.path.join(DATA, "golden")
MANIFEST = json.load(open(os.path.join(GOLD, "manifest.json")))
GENOMES = [os.path.join(GOLD, f) for f in ("g_phix.fa", "g_phixmut.fa", "g_rand.fa")]
NODES = os.path.join(GOLD, "nodes.dmp")
NAMEID = os.path.join(GOLD, "nameidmap.txt")
LEX = next(c for c in MANIFEST["configs"] if c["name"] == MANIFEST["classify"]["db"])
COMPRESSORS = {".xz": lzma.compress, ".bz2": bz2.compress}


@pytest.fixture(scope="module")
def lex_db(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("inputs") / "lex.btpu")
    assert cli.main(["build", path, *GENOMES, *LEX["flags"], "-T", NODES,
                     "-M", NAMEID]) == 0
    return path


def _copy(src, dst_dir, ext):
    dst = os.path.join(dst_dir, os.path.basename(src) + ext)
    with open(src, "rb") as fh, open(dst, "wb") as out:
        out.write(COMPRESSORS[ext](fh.read()))
    return dst


def _golden(name):
    with gzip.open(os.path.join(GOLD, name), "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("ext", sorted(COMPRESSORS))
@pytest.mark.parametrize("golden,reads", [
    ("classify_se.tsv.gz", ["reads.fa"]),
    ("classify_pe.tsv.gz", ["mate1.fa", "mate2.fa"]),
], ids=["single", "paired"])
def test_classify_compressed_reads(lex_db, tmp_path, ext, golden, reads):
    from bonsai_tpu.cli import main as jmain

    paths = [_copy(os.path.join(GOLD, r), str(tmp_path), ext) for r in reads]
    out = str(tmp_path / "torch.out")
    assert cli.main(["classify", lex_db, NODES, *paths, "-a", "--device",
                     "cpu", "-o", out]) == 0
    got = open(out, "rb").read()
    assert got == _golden(golden)
    jout = str(tmp_path / "jax.out")
    assert jmain(["classify", lex_db, NODES, *paths, "-a", "-o", jout]) == 0
    assert got == open(jout, "rb").read()


def test_python_batches_equal_native_batches(tmp_path):
    """The record reader's batches of an .xz copy equal the C++ parser's
    batches of the plain file, paired, in every field."""
    m1, m2 = (os.path.join(GOLD, f) for f in ("mate1.fa", "mate2.fa"))
    x1, x2 = (_copy(p, str(tmp_path), ".xz") for p in (m1, m2))
    for a, b in zip(fastx.batch_reads(m1, DNA4.lut, 64, m2),
                    fastx.batch_reads(x1, DNA4.lut, 64, x2), strict=True):
        assert a.names == b.names and a.seqs == b.seqs and a.quals == b.quals
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.lengths, b.lengths)


def test_zst_without_a_decompressor_raises_as_jax(tmp_path, monkeypatch):
    from bonsai_tpu.io import fastx as jfastx

    path = str(tmp_path / "reads.fa.zst")
    open(path, "wb").write(b"\x28\xb5\x2f\xfd")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setitem(__import__("sys").modules, "zstandard", None)
    with pytest.raises(RuntimeError) as want:
        jfastx.open_maybe_compressed(path)
    with pytest.raises(RuntimeError) as got:
        next(iter(fastx.batch_reads(path, DNA4.lut)))
    assert str(got.value) == str(want.value)


def test_classify_zst_reads_with_zstd(lex_db, tmp_path):
    if shutil.which("zstd") is None:
        pytest.skip("no zstd binary on the path")
    src = os.path.join(GOLD, "reads.fa")
    path = str(tmp_path / "reads.fa.zst")
    subprocess.run(["zstd", "-q", "-o", path, src], check=True)
    out = str(tmp_path / "torch.out")
    assert cli.main(["classify", lex_db, NODES, path, "-a", "--device", "cpu",
                     "-o", out]) == 0
    assert open(out, "rb").read() == _golden("classify_se.tsv.gz")


def _k33_db(lex_db, path):
    db = tformats.load_database(lex_db)
    db.k, db.w, db.gaps = 33, 33, [0] * 32
    tformats.save_database(db, path)


@pytest.mark.parametrize("which", ["not BTPU1", "k > 32"])
def test_classify_refused_database_exits_2(lex_db, tmp_path, capsys, which):
    """A file that is neither BTPU1 nor a reference khash image is no
    database; a k > 32 database is not ported (item 8.6)."""
    db = str(tmp_path / "refused.db")
    if which == "not BTPU1":
        open(db, "wb").write(b"not a database\n")
    else:
        _k33_db(lex_db, db)
    rc = cli.main(["classify", db, NODES, os.path.join(GOLD, "reads.fa"),
                   "--device", "cpu", "-o", str(tmp_path / "out")])
    assert rc == 2
    err = capsys.readouterr().err
    if which == "not BTPU1":
        assert "neither a BTPU1 file nor a reference khash" in err
    else:
        assert "not ported" in err and "8.6" in err


@pytest.mark.parametrize("name", ["lex.btpu", "lex.btpu.gz"])
def test_build_z_writes_gzip(lex_db, tmp_path, name):
    from bonsai_tpu.cli import main as jmain

    argv = [*GENOMES, *LEX["flags"], "-T", NODES, "-M", NAMEID, "-z"]
    path, jpath = str(tmp_path / name), str(tmp_path / f"jax_{name}")
    assert cli.main(["build", path, *argv]) == 0
    assert jmain(["build", jpath, *argv]) == 0
    with open(path, "rb") as fh:
        assert fh.read(2) == b"\x1f\x8b"
    with gzip.open(path, "rb") as fh:
        body = fh.read()
    assert body == open(lex_db, "rb").read()
    with gzip.open(jpath, "rb") as fh:
        assert body == fh.read()
    if name.endswith(".gz"):  # the load path reads gzip by its name alone
        got = tformats.load_database(path)
        assert got.table.n == tformats.load_database(lex_db).table.n
