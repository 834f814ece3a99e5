"""The port's slice end to end on the CPU: CLI build + classify.

* ``python -m bonsai_tpu_torch build`` reproduces the golden database
  digests (lex_k25, and the ec k=31 database of the kraken goldens);
* ``classify --device cpu`` writes byte-identical output to the JAX
  package's CLI and to the oracle goldens for every classify golden
  (single-end, no-emit-all, paired, non-canonical, FASTQ);
* the HiSeq, MiSeq and ec_k12 kraken sets reproduce the oracle sha256s;
* probe images and ``Classifier`` arrays cross between the packages.

On the CPU every kernel wrapper takes its plain torch version.
Tolerance: exact bytes.
"""

import gzip
import hashlib
import io
import json
import os

import numpy as np
import pytest
import torch

from bonsai_tpu_torch import cli
from bonsai_tpu_torch.classify.pipeline import Classifier
from bonsai_tpu_torch.db import build as tbuild
from bonsai_tpu_torch.db import formats as tformats
from bonsai_tpu_torch.taxonomy.tree import TaxTree

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(__file__), "data")
GOLD = os.path.join(DATA, "golden")
MANIFEST = json.load(open(os.path.join(GOLD, "manifest.json")))
GENOMES = [os.path.join(GOLD, f) for f in ("g_phix.fa", "g_phixmut.fa", "g_rand.fa")]
NODES = os.path.join(GOLD, "nodes.dmp")


def _args(extra):
    """Golden flags with the reads re-rooted at this checkout."""
    return [a if a.startswith("-") else os.path.join(GOLD, os.path.basename(a))
            for a in extra]


@pytest.fixture(scope="module")
def lex_db(tmp_path_factory):
    cfg = next(c for c in MANIFEST["configs"]
               if c["name"] == MANIFEST["classify"]["db"])
    path = str(tmp_path_factory.mktemp("torchdb") / "lex.btpu")
    rc = cli.main(["build", path, *GENOMES, *cfg["flags"], "-T", NODES, "-M",
                   os.path.join(GOLD, "nameidmap.txt")])
    assert rc == 0
    return path, cfg


def test_build_matches_golden_digest(lex_db):
    path, cfg = lex_db
    db = tformats.load_database(path)
    assert tbuild.content_digest(db.table) == cfg["db_digest"]


def test_btpu_file_is_the_jax_packages(lex_db, tmp_path):
    """The port writes the BTPU1 bytes the JAX CLI writes."""
    from bonsai_tpu.cli import main as jmain

    path, cfg = lex_db
    jpath = str(tmp_path / "jax.btpu")
    assert jmain(["build", jpath, *GENOMES, *cfg["flags"], "-T", NODES, "-M",
                  os.path.join(GOLD, "nameidmap.txt")]) == 0
    assert open(jpath, "rb").read() == open(path, "rb").read()


@pytest.mark.parametrize("gz", sorted(MANIFEST["classify"]["outputs"]))
def test_classify_cli_matches_jax_and_golden(gz, lex_db, tmp_path):
    from bonsai_tpu.cli import main as jmain

    path, _ = lex_db
    extra = _args(MANIFEST["classify"]["outputs"][gz])
    reads = [a for a in extra if not a.startswith("-")]
    flags = [a for a in extra if a.startswith("-")]
    out = str(tmp_path / "torch.out")
    assert cli.main(["classify", path, NODES, *reads, *flags, "--device", "cpu",
                     "-o", out]) == 0
    got = open(out, "rb").read()
    with gzip.open(os.path.join(GOLD, gz), "rb") as fh:
        assert got == fh.read(), f"{gz}: port output differs from the golden"
    jout = str(tmp_path / "jax.out")
    assert jmain(["classify", path, NODES, *reads, *flags, "-o", jout]) == 0
    assert got == open(jout, "rb").read()


@pytest.mark.parametrize("flag", ["-v", "--version"])
def test_version_matches_jax(flag, capsys):
    from bonsai_tpu.cli import main as jmain

    rc = cli.main([flag])
    got = capsys.readouterr().out
    assert (rc, got) == (0, "bonsai-tpu|0.1.0\n")
    assert (jmain([flag]), capsys.readouterr().out) == (rc, got)


@pytest.mark.parametrize("gz", ["classify_se.tsv.gz", "classify_pe.tsv.gz"])
def test_classify_trace_dir_traces_every_thread(gz, lex_db, tmp_path,
                                                capsys):
    """--trace-dir writes one torch.profiler trace into a directory it
    makes, holding each stage's ranges in the thread that runs it; the
    text is the golden's, and --profile still prints its line."""
    from bonsai_tpu_torch.tools import trace_summary

    path, _ = lex_db
    extra = _args(MANIFEST["classify"]["outputs"][gz])
    reads = [a for a in extra if not a.startswith("-")]
    flags = [a for a in extra if a.startswith("-")]
    out, tdir = str(tmp_path / "torch.out"), str(tmp_path / "t" / "trace")
    assert cli.main(["classify", path, NODES, *reads, *flags, "--device",
                     "cpu", "--profile", "--trace-dir", tdir, "-o", out]) == 0
    assert "# profile: " in capsys.readouterr().err
    with gzip.open(os.path.join(GOLD, gz), "rb") as fh:
        assert open(out, "rb").read() == fh.read()
    assert len(os.listdir(tdir)) == 1
    threads = {s: set(rows) for s, rows in trace_summary.stage_threads(
        trace_summary.load(tdir)).items()}
    assert all(len(t) == 1 for t in threads.values()), threads
    assert threads["materialize"] == threads["format"]
    assert len(threads["parse"] | threads["dispatch"] | threads["format"]) \
        == 3


def test_trace_dir_leaves_the_sharded_path_untraced(lex_db, tmp_path):
    """As in the JAX CLI, --db-shards runs without the trace."""
    path, _ = lex_db
    extra = _args(MANIFEST["classify"]["outputs"]["classify_se.tsv.gz"])
    out, tdir = str(tmp_path / "torch.out"), str(tmp_path / "trace")
    assert cli.main(["classify", path, NODES, *extra, "--db-shards", "2",
                     "--device", "cpu", "--trace-dir", tdir, "-o", out]) == 0
    with gzip.open(os.path.join(GOLD, "classify_se.tsv.gz"), "rb") as fh:
        assert open(out, "rb").read() == fh.read()
    assert not os.path.exists(tdir)


def test_trace_dir_refuses_a_torch_that_cannot_trace_threads(
        lex_db, tmp_path, monkeypatch, capsys):
    """Where the profiler has no profile_all_threads, --trace-dir exits 2
    rather than write a trace of the main thread alone."""
    def no_threads(**kw):
        raise TypeError("__init__(): incompatible constructor arguments")

    monkeypatch.setattr(torch._C._profiler, "_ExperimentalConfig",
                        no_threads)
    path, _ = lex_db
    tdir = str(tmp_path / "trace")
    assert cli.main(["classify", path, NODES, os.path.join(GOLD, "reads.fa"),
                     "--device", "cpu", "--trace-dir", tdir,
                     "-o", str(tmp_path / "out")]) == 2
    assert "cannot trace every thread" in capsys.readouterr().err
    assert not os.path.exists(tdir)


def _ev(cat, name, ts, dur, tid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid, "args": args}


def test_trace_summary_sums_a_card_trace():
    """The sums of a hand-made trace: K1-K3 by variant, copies by
    direction, the device's busy union and its idle gaps with the stage
    ranges over them."""
    from bonsai_tpu_torch.tools import trace_summary as ts

    k1 = ("void (anonymous namespace)::encode_probe_kernel<{}, {}>"
          "(unsigned int const*, long)")
    events = [
        _ev("Trace", "PyTorch Profiler (0)", 0, 100),
        _ev("user_annotation", "parse", 0, 30, tid=1),
        _ev("user_annotation", "dispatch", 30, 20, tid=2),
        _ev("user_annotation", "format", 60, 40, tid=3),
        _ev("kernel", k1.format("false", 3), 35, 5),
        _ev("kernel", k1.format("false", 0), 38, 4),  # overlaps the first
        _ev("kernel", k1.format("true", 1), 44, 1),
        _ev("kernel", k1.format("false", 3), 45, 1),
        _ev("kernel", "void (anonymous namespace)::resolve_warp(int const*)",
            46, 2),
        _ev("kernel", "void (anonymous namespace)::resolve_block(int const*)",
            48, 1),
        _ev("kernel", "void (anonymous namespace)::step_outputs_kernel"
            "<unsigned int>(unsigned int const*)", 55, 5),
        _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 32, 2, bytes=64),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 60, 5, bytes=8),
        _ev("gpu_memset", "Memset (Device)", 90, 20),  # cut at the span
    ]
    s = ts.summary(events)
    assert s["classify_kernels"] == {
        "encode_probe sparse": [2, 6], "encode_probe contiguous": [1, 4],
        "encode_probe spaced range": [1, 1], "resolve": [2, 3],
        "step_outputs": [1, 5]}
    assert s["copies"] == {"HtoD": [1, 64, 2], "DtoH": [1, 8, 5]}
    # busy: [32, 34) [35, 42) [44, 49) [55, 65) [90, 100)
    assert s["span_us"] == 100 and s["device_busy_us"] == 34
    assert [(g["at_us"], g["us"]) for g in s["idle_gaps"]] == [
        (0, 32), (65, 25), (49, 6)]
    assert s["idle_gaps"][0]["host"] == {"parse@1": 30, "dispatch@2": 2}
    assert s["idle_gaps"][1]["host"] == {"format@3": 25}
    assert s["stages"]["parse"] == {"1": [1, 30]}
    assert s["kernels"]["encode_probe_kernel<false, 3>"] == [2, 6]


def test_run_overflow_falls_back_to_the_full_matrix(lex_db):
    """max_runs=1: reads with more hit runs decode from the positional
    matrix, and the run capacity doubles after a few such batches."""
    path, _ = lex_db
    tree = TaxTree.from_nodes_dmp(NODES)
    clf = Classifier(tformats.load_database(path), tree, emit_all=True,
                     device="cpu", max_runs=1)
    out = io.StringIO()
    clf.process_dataset(os.path.join(GOLD, "reads.fa"), out, batch_size=64)
    with gzip.open(os.path.join(GOLD, "classify_se.tsv.gz"), "rt") as fh:
        assert out.getvalue() == fh.read()
    assert clf.max_runs > 1


def test_probe_images_cross_between_packages(lex_db, tmp_path):
    from bonsai_tpu.classify.pipeline import Classifier as JClassifier
    from bonsai_tpu.db import formats as jformats
    from bonsai_tpu.taxonomy.tree import TaxTree as JTree

    path, _ = lex_db
    reads = os.path.join(GOLD, "reads.fa")
    with gzip.open(os.path.join(GOLD, "classify_se.tsv.gz"), "rt") as fh:
        want = fh.read()
    # JAX-written image -> port
    jimg = str(tmp_path / "jax_img")
    jformats.save_probe_image(jimg, jformats.load_database(path),
                              JTree.from_nodes_dmp(NODES))
    tree = TaxTree.from_nodes_dmp(NODES)
    out = io.StringIO()
    Classifier.from_probe_image(jimg, tree, emit_all=True, device="cpu") \
        .process_dataset(reads, out)
    assert out.getvalue() == want
    # port-written image: the JAX image's bytes, and it loads in JAX
    timg = str(tmp_path / "torch_img")
    tformats.save_probe_image(timg, tformats.load_database(path), tree)
    for f in ("slots.npy", "vals.npy", "meta.json"):
        assert open(os.path.join(jimg, f), "rb").read() == \
            open(os.path.join(timg, f), "rb").read()
    out = io.StringIO()
    JClassifier.from_probe_image(timg, JTree.from_nodes_dmp(NODES),
                                 emit_all=True).process_dataset(reads, out)
    assert out.getvalue() == want


def test_classifier_from_jax_arrays(lex_db):
    """The slot image and taxonomy a JAX Classifier holds classify
    identically in the port."""
    from bonsai_tpu.classify.pipeline import Classifier as JClassifier
    from bonsai_tpu.db import formats as jformats
    from bonsai_tpu.taxonomy.tree import TaxTree as JTree

    path, _ = lex_db
    jc = JClassifier(jformats.load_database(path), JTree.from_nodes_dmp(NODES),
                     emit_all=True, trim_table=False)
    slots, vals, inline = jc._arrays
    clf = Classifier.from_arrays(
        np.asarray(slots), np.asarray(vals), inline, jc.db.table.lgnb,
        jc.db.table.vbits, jc._n_distinct, jc.sp.k,
        TaxTree.from_nodes_dmp(NODES), emit_all=True, device="cpu")
    reads = os.path.join(GOLD, "reads.fa")
    out, jout = io.StringIO(), io.StringIO()
    clf.process_dataset(reads, out)
    jc.process_dataset(reads, jout)
    assert out.getvalue() == jout.getvalue()


def test_classify_reads_and_full_batches_match_jax(lex_db):
    """classify_reads, and classify_batch with the positional matrices
    forced (full=True), equal the JAX Classifier's on the same reads,
    including a read shorter than k and one with an N."""
    from bonsai_tpu.classify.pipeline import Classifier as JClassifier
    from bonsai_tpu.db import formats as jformats
    from bonsai_tpu.io import fastx as jfastx
    from bonsai_tpu.taxonomy.tree import TaxTree as JTree

    from bonsai_tpu_torch.io import fastx

    path, _ = lex_db
    jc = JClassifier(jformats.load_database(path), JTree.from_nodes_dmp(NODES))
    clf = Classifier(tformats.load_database(path), TaxTree.from_nodes_dmp(NODES),
                     device="cpu")
    seqs = [s for _, s, _ in fastx.read_fastx(os.path.join(GOLD, "reads.fa"))][:40]
    seqs += [seqs[0][:10], seqs[1][:50] + b"N" + seqs[1][51:]]
    np.testing.assert_array_equal(clf.classify_reads(seqs),
                                  jc.classify_reads(seqs))
    reads = os.path.join(GOLD, "reads.fa")
    got = clf.classify_batch(next(iter(fastx.batch_reads(reads, clf.lut, 64))),
                             full=True)
    want = jc.classify_batch(next(iter(jfastx.batch_reads(reads, jc.lut, 64))),
                             full=True)
    for name in ("taxon", "taxa", "hit_mask", "n_missing", "n_kmers", "n_kmers1"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))


@pytest.fixture(scope="module")
def ec_classifier():
    """The ec k=31 database of the kraken goldens, built by the port."""
    from bonsai_tpu_torch.core.spacer import Spacer
    from bonsai_tpu_torch.db.formats import Database

    kk = MANIFEST["kraken"]
    tree = TaxTree.from_nodes_dmp(os.path.join(GOLD, kk["nodes"]))
    table = tbuild.lca_map([os.path.join(DATA, "ec", g) for g in kk["genomes"]],
                           tree, os.path.join(GOLD, kk["nameid"]),
                           Spacer(kk["k"], kk["k"]))
    digest = tbuild.content_digest(table)
    db = Database(table=table, k=kk["k"], w=kk["k"], gaps=[0] * (kk["k"] - 1))
    return Classifier(db, tree, emit_all=True, device="cpu"), digest, kk


def test_ec_database_digest(ec_classifier):
    _, digest, kk = ec_classifier
    assert digest == kk["db_digest"]


@pytest.mark.parametrize("which", ["HiSeq", "MiSeq", "ec_k12"])
def test_kraken_sets_match_oracle_sha256(ec_classifier, which):
    clf, _, kk = ec_classifier
    s = kk["sets"][which]
    out = io.StringIO()
    clf.process_dataset(os.path.join(DATA, s["reads"]), out, batch_size=4096)
    text = out.getvalue().encode()
    assert hashlib.sha256(text).hexdigest() == s["sha256"]
    assert text.count(b"\n") == s["n_lines"]
