"""A batch's names, sequences and qualities as byte arenas
(``io.fastx.Strings``), from the C++ parser to the C++ formatter, on the
CPU.

* the C++ parser's batches (``Strings``) equal the record reader's lists
  in every field, FASTA and FASTQ, plain and gzip, over names with mate
  suffixes, comments, two bytes or fewer, a non-digit suffix, and empty
  sequences; the mate suffix is trimmed in C++, with no Python call a
  read;
* ``Strings`` indexes, slices and iterates as the list of its bytes;
* the Kraken text and the ``-f`` FASTQ re-emission of a ``Strings``
  batch are the bytes of the same batch given as lists, compact and
  full-matrix, with and without ``emit_all``, and the goldens';
* ``process_dataset`` joins no names (``name_join`` counts 0) where the
  C++ parser reads the file, and joins each batch's list where the
  reads come as lists (paired, .xz), to the goldens' bytes.

Every file is made in ``tmp_path``.  Tolerance: exact bytes.
"""

import dataclasses
import gzip
import io
import lzma
import os
import shutil

import numpy as np
import pytest
import torch

from bonsai_tpu_torch.classify import output as out_mod
from bonsai_tpu_torch.classify.pipeline import Classifier
from bonsai_tpu_torch.core.alphabet import DNA4
from bonsai_tpu_torch.core.spacer import Spacer
from bonsai_tpu_torch.db.build_device import device_lca_map
from bonsai_tpu_torch.db.formats import Database
from bonsai_tpu_torch.io import fastx
from bonsai_tpu_torch.io.fastx import Strings
from bonsai_tpu_torch.taxonomy.tree import TaxTree

torch.set_num_threads(1)
GOLD = os.path.join(os.path.dirname(__file__), "data", "golden")
GENOMES = [os.path.join(GOLD, f) for f in ("g_phix.fa", "g_phixmut.fa",
                                           "g_rand.fa")]
NODES = os.path.join(GOLD, "nodes.dmp")
READS = os.path.join(GOLD, "reads.fa")
MATES = [os.path.join(GOLD, f) for f in ("mate1.fa", "mate2.fa")]
BATCH = 64

# (header, sequence): the names the trims must agree on
RECORDS = [
    ("r0/1", "ACGTACGTAC"),
    ("r0/2", "TTGCAN"),
    ("r1/1 a comment", "GATTACA"),
    ("r2\ttabbed/1", "CCCC"),
    ("/1", "AC"),
    ("/", "G"),
    ("x", "T"),
    ("ab/x", "ACGTTGCA"),
    ("ab/12", "ACG"),
    ("e0", ""),
    ("r3/9", "NNNNACGT"),
    ("e1/1", ""),
    ("r4 x/1", "A" * 150),
]


def _write(tmp_path, fmt, gz):
    """The records as FASTA or FASTQ (FASTQ headers without tabs: the
    record reader cuts a FASTQ name at a space alone)."""
    lines = []
    for hdr, seq in RECORDS:
        if fmt == "fa":
            lines += [f">{hdr}", seq]
        elif "\t" not in hdr:
            lines += [f"@{hdr}", seq, "+", "I" * len(seq)]
    text = ("\n".join(lines) + "\n").encode()
    path = str(tmp_path / f"reads.{fmt}") + (".gz" if gz else "")
    with (gzip.open if gz else open)(path, "wb") as fh:
        fh.write(text)
    return path


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("fmt", ["fa", "fq"])
@pytest.mark.parametrize("batch_size", [4, 64])
def test_native_batches_equal_the_record_readers(tmp_path, fmt, gz,
                                                 batch_size):
    path = _write(tmp_path, fmt, gz)
    nat = list(fastx._batch_reads_native(path, DNA4.lut, batch_size, None))
    py = list(fastx._batch_reads_python(path, DNA4.lut, batch_size, None))
    assert len(nat) == len(py) > 0
    for a, b in zip(nat, py):
        assert isinstance(a.names, Strings) and isinstance(a.seqs, Strings)
        assert isinstance(b.names, list)
        assert a.names == b.names and a.seqs == b.seqs and a.quals == b.quals
        assert b.names == a.names and list(a.names) == b.names
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.lengths, b.lengths)
        if fmt == "fq":
            assert isinstance(a.quals, Strings)
        else:
            assert a.quals == [None] * len(a.names)
    want = [fastx.trim_readno(h.split(" ")[0].split("\t")[0].encode())
            for h, _ in RECORDS if fmt == "fa" or "\t" not in h]
    assert [n for b in nat for n in b.names] == want
    assert want[:2] == [b"r0", b"r0"] and b"/1" in want and b"ab/x" in want


def test_native_batches_make_no_python_trim(tmp_path, monkeypatch):
    """The mate suffix comes off in C++: a native batch is made with
    ``trim_readno`` raising."""

    def refuse(name):
        raise AssertionError("a per-read Python trim")

    path = _write(tmp_path, "fa", False)
    monkeypatch.setattr(fastx, "trim_readno", refuse)
    got = [n for b in fastx.batch_reads(path, DNA4.lut, 64) for n in b.names]
    assert got[:4] == [b"r0", b"r0", b"r1", b"r2"]
    assert len(got) == len(RECORDS)


def _lists_and_strings(tmp_path):
    path = _write(tmp_path, "fq", False)
    b = next(fastx._batch_reads_native(path, DNA4.lut, 64, None))
    return list(b.names), b.names


@pytest.mark.parametrize("key", [
    0, 3, -1, -len(RECORDS) + 1, slice(None), slice(2, 7), slice(-3, None),
    slice(5, 2), slice(0, 0), slice(None, None, 2), slice(1, None, 2),
    slice(None, None, -1), slice(1, 9, 3), slice(100, 200),
], ids=repr)
def test_strings_index_and_slice_as_a_list(tmp_path, key):
    lst, s = _lists_and_strings(tmp_path)
    got, want = s[key], lst[key]
    assert got == want
    if isinstance(key, slice):
        assert list(got) == want and len(got) == len(want)
        assert isinstance(got, Strings if key.step is None else list)
    else:
        assert isinstance(got, bytes)


def test_strings_iterate_compare_and_refuse_as_a_list(tmp_path):
    lst, s = _lists_and_strings(tmp_path)
    assert len(s) == len(lst) and list(s) == lst and bool(s)
    assert b"".join(s) == b"".join(lst)
    assert s[2:6][1:3] == lst[2:6][1:3]
    assert list(reversed(s)) == lst[::-1]
    assert b"ab/x" in s and s.index(b"x") == lst.index(b"x")
    assert s != lst[:-1] and s != lst[:-1] + [b"?"] and s != "r0"
    assert s == Strings.of(lst) and Strings.of(lst) == s
    assert Strings.of([]) == [] and len(Strings.of([])) == 0
    assert not s[3:3]
    with pytest.raises(IndexError):
        s[len(lst)]
    with pytest.raises(IndexError):
        s[-len(lst) - 1]


@pytest.fixture(scope="module")
def built():
    """(tree, table) of the classify goldens' lex k=25 database."""
    tree = TaxTree.from_nodes_dmp(NODES)
    table = device_lca_map(GENOMES, tree, os.path.join(GOLD, "nameidmap.txt"),
                           Spacer(25, 25), True, device="cpu")
    return tree, table


def _classifier(built, **kw):
    tree, table = built
    return Classifier(Database(table, 25, 25, [0] * 24), tree, device="cpu",
                      trim_table=False, **kw)


def _golden(name):
    with gzip.open(os.path.join(GOLD, name), "rt") as fh:
        return fh.read()


def _as_lists(res):
    def lists(x):
        return None if x is None else list(x)

    return dataclasses.replace(
        res, names=list(res.names), seqs=list(res.seqs),
        quals=lists(res.quals), seqs2=lists(res.seqs2),
        quals2=lists(res.quals2))


@pytest.mark.parametrize("emit_all,golden", [
    (True, "classify_se.tsv.gz"), (False, "classify_se_noall.tsv.gz")])
@pytest.mark.parametrize("full", [False, True], ids=["compact", "full"])
def test_kraken_text_of_strings_is_the_lists(built, emit_all, golden, full):
    clf = _classifier(built, emit_all=emit_all)
    got, lists = [], []
    for batch in fastx.batch_reads(READS, clf.lut, batch_size=BATCH):
        assert isinstance(batch.names, Strings)
        res = clf.classify_batch(batch, full=full)
        assert res.compact != full and res.names is batch.names
        acc = {}
        got.append(out_mod.format_batch(res, clf.sp.c, emit_all=emit_all,
                                        acc=acc))
        assert "name_join" not in acc
        lists.append(out_mod.format_batch(_as_lists(res), clf.sp.c,
                                          emit_all=emit_all, acc=acc))
        assert acc["name_join"][2] == 1
    assert got == lists
    assert "".join(got) == _golden(golden)


@pytest.mark.parametrize("fmt", ["fa", "fq", "pe"])
def test_fastq_reemission_of_strings_is_the_lists(built, tmp_path, fmt):
    clf = _classifier(built, emit_all=True)
    path, mate = READS, None
    if fmt == "pe":
        path, mate = MATES
    qual = "".join(chr(33 + (i * 7) % 41) for i in range(200))
    if fmt == "fq":
        path = str(tmp_path / "reads.fq")
        with open(path, "w") as fh:
            for name, seq, _ in fastx.read_fastx(READS):
                fh.write(f"@{name.decode()}\n{seq.decode()}\n+\n"
                         f"{qual[:len(seq)]}\n")
    got, lists = [], []
    for batch in fastx.batch_reads(path, clf.lut, batch_size=BATCH,
                                   mate_path=mate):
        res = clf.classify_batch(batch, paired=mate is not None)
        if mate is not None:
            # the mates come interleaved as lists: hold them as Strings
            res = dataclasses.replace(
                res, names=Strings.of(res.names), seqs=Strings.of(res.seqs),
                seqs2=Strings.of(res.seqs2))
        assert isinstance(res.seqs, Strings)
        assert isinstance(res.quals, Strings if fmt == "fq" else list)
        kw = dict(emit_all=True, emit_kraken=True, emit_fastq=True)
        got.append(out_mod.format_batch(res, clf.sp.c, **kw))
        lists.append(out_mod.format_batch(_as_lists(res), clf.sp.c, **kw))
    assert got == lists
    text = "".join(got)
    if fmt == "fa":
        assert text == _golden("classify_fastq.txt.gz")
    assert text.count("\n+\n") == (240 if fmt == "pe" else 402)
    assert (f"\n+\n{qual[:20]}" in text) == (fmt == "fq")


@pytest.mark.parametrize("case", ["single", "single_xz", "paired"])
def test_name_join_counts_batches_that_came_as_lists(built, tmp_path, case):
    clf = _classifier(built, emit_all=True)
    reads, mate = READS, None
    golden = "classify_se.tsv.gz"
    if case == "paired":
        (reads, mate), golden = MATES, "classify_pe.tsv.gz"
    elif case == "single_xz":
        reads = str(tmp_path / "reads.fa.xz")
        with open(READS, "rb") as src, lzma.open(reads, "wb") as dst:
            shutil.copyfileobj(src, dst)
    out = io.StringIO()
    clf.process_dataset(reads, out, mate_path=mate, batch_size=BATCH)
    assert out.getvalue() == _golden(golden)
    n_batches = clf.span_seconds["format"][2]
    assert n_batches > 1
    joins = clf.span_seconds["name_join"][2]
    assert joins == (0 if case == "single" else n_batches)
