"""Port parity: classify reads of the other input types (queue A item 14).

For PROTEIN, PROTEIN20, PROTEIN_3BIT, PROTEIN_14, PROTEIN_6, DNA2 and
DNAC, each at a contiguous seed and at a spaced seed (every other
residue; PROTEIN_3BIT at k = 22, whose 66-bit fold of a run of 'P' is
U64_MAX), the database is the JAX ``lca_map(..., input_type=it,
canonicalize=False)`` of three small genomes (the second shares a stretch
with the first, so that some k-mers hold their LCA), handed to both
packages as arrays.  The reads are substrings of the genomes with
substitutions and ambiguous residues, random reads, reads shorter than
the seed's span, an empty read and a run of 'P'.  The reference is the
JAX package's intent: its ``ShardedClassifier`` on a CPU mesh, whose step
encodes the int8 codes (``_make_step`` on codes).  Covered: the port's
``Classifier(input_type=)`` (K1's radix instantiations, plain on the
CPU) in ``classify_batch``, ``classify_reads`` and ``process_dataset``
(single and paired, with and without ``-a``: the JAX ``format_batch``
bytes), ``from_probe_image(input_type=)``, ``ShardedClassifier
(input_type=)`` on the psum (2, 1) and a2a (1, 2) routes against the JAX
step on the same meshes, ``canonicalize=True`` (dropped for these
types), the JAX single-chip fault (its 2-bit upload: PROTEIN20 reads
unclassified, a wrong taxon for PROTEIN_3BIT; DNA2 right), and DNA given
explicitly against the golden Kraken text.  Tolerance: exact equality.
"""

import gzip
import io
import json
import os

import numpy as np
import pytest
import torch

import bonsai_tpu  # noqa: F401  (enables jax x64)
from bonsai_tpu.classify import output as jout
from bonsai_tpu.classify.pipeline import Classifier as JClassifier
from bonsai_tpu.core.alphabet import InputType as JInputType
from bonsai_tpu.core.spacer import Spacer as JSpacer
from bonsai_tpu.db import build as jbuild
from bonsai_tpu.db import formats as jformats
from bonsai_tpu.io import fastx as jfastx
from bonsai_tpu.parallel.mesh import make_mesh as jmesh
from bonsai_tpu.parallel.sharded import ShardedClassifier as JSharded
from bonsai_tpu.taxonomy.tree import TaxTree as JTree

from bonsai_tpu_torch.classify.pipeline import Classifier
from bonsai_tpu_torch.core.alphabet import InputType, alphabet_of
from bonsai_tpu_torch.db import formats as tformats
from bonsai_tpu_torch.db.table import KmerTable
from bonsai_tpu_torch.io import fastx
from bonsai_tpu_torch.parallel.mesh import make_mesh
from bonsai_tpu_torch.parallel.sharded import ShardedClassifier
from bonsai_tpu_torch.taxonomy.tree import TaxTree

torch.set_num_threads(1)
PARENTS = {1: 0, 2: 1, 3: 1, 11: 2, 12: 2, 13: 3}
PROTEIN_CHARS = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
GOLD = os.path.join(os.path.dirname(__file__), "data", "golden")
DNA_TYPES = (InputType.DNA2, InputType.DNAC)
# input type -> (k of the contiguous seed, k of the spaced seed)
KS = {
    InputType.PROTEIN: (5, 4),
    InputType.PROTEIN20: (7, 5),
    InputType.PROTEIN_3BIT: (9, 22),
    InputType.PROTEIN_14: (6, 5),
    InputType.PROTEIN_6: (8, 8),
    InputType.DNA2: (20, 16),
    InputType.DNAC: (20, 16),
}
SEEDS = [(it, k, None) for it, (k, _) in KS.items()] + [
    (it, k, (1,) * (k - 1)) for it, (_, k) in KS.items()]


def _id(seed):
    it, k, gaps = seed
    return f"{it.name}-k{k}{'-spaced' if gaps else ''}"


def _residues(rng, n, dna, ambiguous=0.0):
    chars = np.frombuffer(b"ACGT", np.uint8) if dna else PROTEIN_CHARS
    seq = rng.choice(chars, n)
    amb = rng.random(n) < ambiguous
    seq[amb] = ord("N") if dna else ord("X")
    return seq


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Per kind ("protein", "dna"): the three genomes' paths, the name map
    and the reads (bytes)."""
    tmp = tmp_path_factory.mktemp("alphabets")
    out = {}
    for kind, n in (("protein", 3000), ("dna", 6000)):
        rng = np.random.default_rng(25 if kind == "protein" else 52)
        dna = kind == "dna"
        seqs = [_residues(rng, n, dna, 0.01) for _ in range(3)]
        seqs[1][: n // 3] = seqs[0][: n // 3]  # shared: LCA 2
        if not dna:
            seqs[0][2000:2100] = ord("P")  # PROTEIN_3BIT's U64_MAX at k = 22
            # genome 13 ends with residues 300-500 of genome 11 as their
            # PROTEIN_3BIT codes keep 2 bits (code & 3, spelt S, C, H, K,
            # PROTEIN20 codes past 3 but C): what the JAX 2-bit upload
            # makes of reads of that stretch
            c3 = alphabet_of(InputType.PROTEIN_3BIT).lut[seqs[0][300:500]]
            seqs[2][n - 200:] = np.where(
                c3 < 0, ord("X"), np.frombuffer(b"SCHK", np.uint8)[c3 & 3])
        paths, name_map = [], {}
        for i, s in enumerate(seqs):
            p = str(tmp / f"{kind}{i}.fa")
            open(p, "wb").write(b">G_%d x\n%s\n" % (i, s.tobytes()))
            paths.append(p)
            name_map[f"G_{i}"] = (11, 12, 13)[i]
        reads = []
        for _ in range(48):
            g = seqs[int(rng.integers(3))]
            ln = int(rng.integers(40, 121))
            at = int(rng.integers(0, n - 200 - ln))
            r = g[at: at + ln].copy()
            sub = rng.random(ln) < 0.03
            r[sub] = _residues(rng, int(sub.sum()), dna)
            amb = rng.random(ln) < 0.02
            r[amb] = ord("N") if dna else ord("X")
            reads.append(r.tobytes())
        reads += [seqs[0][310:400].tobytes(), seqs[0][400:490].tobytes()]
        reads += [_residues(rng, int(rng.integers(40, 100)), dna).tobytes()
                  for _ in range(8)]
        reads += [seqs[0][100: 100 + m].tobytes() for m in (3, 8, 15)]
        reads += [b"", seqs[0][1990:2110].tobytes()]
        out[kind] = (paths, name_map, reads)
    return out


def _kind(it):
    return "dna" if it in DNA_TYPES else "protein"


def _batch(mod, reads, it):
    lut = np.asarray(alphabet_of(it).lut, np.int8)
    L = fastx.bucket_len(max(len(r) for r in reads))
    codes = np.full((len(reads), L), -1, np.int8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = lut[np.frombuffer(r, np.uint8)]
    lengths = np.array([len(r) for r in reads], np.int32)
    return mod.ReadBatch(names=[b"r%d" % i for i in range(len(reads))],
                         seqs=list(reads), codes=codes, lengths=lengths,
                         quals=[None] * len(reads))


_DBS = {}


def _dbs(data, seed):
    """The JAX lca_map of the seed over its kind's genomes, as each
    package's Database (cached a module)."""
    if seed not in _DBS:
        it, k, gaps = seed
        paths, name_map, _ = data[_kind(it)]
        jsp = JSpacer(k, 0, list(gaps) if gaps else None)
        t = jbuild.lca_map(paths, JTree(PARENTS), name_map, jsp, False,
                           "lex", JInputType(int(it)))
        assert t.n > 100
        g = list(jsp.gaps)
        _DBS[seed] = (
            jformats.Database(table=t, k=k, w=jsp.w, gaps=g,
                              canonicalize=False),
            tformats.Database(table=KmerTable(t.keys_sorted, t.vals_sorted),
                              k=k, w=jsp.w, gaps=g, canonicalize=False))
    return _DBS[seed]


def _jsharded(jdb, it, dp=1, db=1, route="auto", canonicalize=False,
              emit_all=False):
    return JSharded(jdb, JTree(PARENTS), jmesh({"dp": dp, "db": db}),
                    canonicalize=canonicalize,
                    input_type=JInputType(int(it)), route=route,
                    emit_all=emit_all)


def _same_results(got, want):
    """The port's BatchResult (full) equals the JAX sharded one: the
    positional matrices agree on the port's P columns, and the JAX
    columns past them (positions past every read) hold no hit."""
    for f in ("taxon", "n_missing", "n_kmers", "n_kmers1"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    P = got.taxa.shape[1]
    wt, wh = np.asarray(want.taxa), np.asarray(want.hit_mask)
    assert P <= wt.shape[1]
    np.testing.assert_array_equal(got.taxa, wt[:, :P])
    np.testing.assert_array_equal(got.hit_mask, wh[:, :P])
    assert not wh[:, P:].any()


@pytest.mark.parametrize("seed", SEEDS, ids=[_id(s) for s in SEEDS])
def test_classify_batch_matches_the_jax_step(data, seed):
    it = seed[0]
    jdb, tdb = _dbs(data, seed)
    reads = data[_kind(it)][2]
    want = _jsharded(jdb, it).classify_batch(_batch(jfastx, reads, it))
    clf = Classifier(tdb, TaxTree(PARENTS), canonicalize=False,
                     input_type=it, device="cpu")
    assert clf.lut is not None and not clf.canon
    prep = clf._prepare_batch(_batch(fastx, reads, it))
    assert prep.channel == "codes" and prep.pcodes.dtype == torch.int8
    assert prep.naux is None and prep.lengths.dtype == torch.uint16
    got = clf.classify_batch(_batch(fastx, reads, it), full=True)
    _same_results(got, want)
    taxa = set(np.asarray(want.taxon).tolist())
    assert {0, 11}.issubset(taxa) and len(taxa) >= 3, taxa
    np.testing.assert_array_equal(clf.classify_reads(reads[:-2]),
                                  np.asarray(want.taxon)[:-2])


# (seed, emit_all, paired) of the Kraken text
TEXT = [((InputType.PROTEIN20, 7, None), True, False),
        ((InputType.PROTEIN20, 7, None), False, True),
        ((InputType.PROTEIN_3BIT, 22, (1,) * 21), True, True),
        ((InputType.PROTEIN_6, 8, (1,) * 7), False, False),
        ((InputType.PROTEIN, 5, None), True, True),
        ((InputType.DNAC, 16, (1,) * 15), True, True),
        ((InputType.DNA2, 20, None), False, True)]


@pytest.mark.parametrize("seed,emit_all,paired", TEXT,
                         ids=[f"{_id(s)}-{'a' if a else 'noall'}-"
                              f"{'paired' if p else 'single'}"
                              for s, a, p in TEXT])
def test_process_dataset_matches_jax_format_batch(data, seed, emit_all,
                                                  paired, tmp_path):
    """The port's process_dataset (batches of 16 rows: several batches,
    the last partial) against the JAX format_batch of the JAX sharded
    step's results over the JAX reader's batches."""
    it, k, gaps = seed
    jdb, tdb = _dbs(data, seed)
    reads = data[_kind(it)][2]
    path = str(tmp_path / "reads.fa")
    with open(path, "wb") as fh:
        for i, r in enumerate(reads[: 2 * (len(reads) // 2)]):
            fh.write(b">r%d\n%s\n" % (i, r))
    mate = None
    if paired:  # mate i is read i's neighbour
        mate = str(tmp_path / "mates.fa")
        with open(mate, "wb") as fh:
            for i, r in enumerate(reads[1: 2 * (len(reads) // 2)] + [b"A"]):
                fh.write(b">r%d\n%s\n" % (i, r))
    sc = _jsharded(jdb, it, emit_all=emit_all)
    c = sc.sp.c
    want = "".join(
        jout.format_batch(sc.classify_batch(b, paired), c, emit_all=emit_all)
        for b in jfastx.batch_reads(path, sc.lut, batch_size=16,
                                    mate_path=mate))
    clf = Classifier(tdb, TaxTree(PARENTS), canonicalize=False,
                     emit_all=emit_all, input_type=it, device="cpu")
    got = io.StringIO()
    clf.process_dataset(path, got, mate_path=mate, batch_size=16)
    assert got.getvalue() == want
    assert len(want.splitlines()) >= 25


@pytest.mark.parametrize("seed", [(InputType.PROTEIN20, 7, None),
                                  (InputType.PROTEIN_14, 5, (1,) * 4)],
                         ids=_id)
def test_probe_image_takes_the_input_type(data, seed, tmp_path):
    it = seed[0]
    jdb, tdb = _dbs(data, seed)
    tree = TaxTree(PARENTS)
    img = str(tmp_path / "image")
    tformats.save_probe_image(img, tdb, tree)
    reads = data[_kind(it)][2]
    want = _jsharded(jdb, it).classify_batch(_batch(jfastx, reads, it))
    clf = Classifier.from_probe_image(img, tree, input_type=it,
                                      device="cpu")
    assert clf.it == it and not clf.canon
    _same_results(clf.classify_batch(_batch(fastx, reads, it), full=True),
                  want)


@pytest.mark.parametrize("route,dp,db", [("psum", 2, 1), ("a2a", 1, 2)])
@pytest.mark.parametrize("seed", SEEDS, ids=[_id(s) for s in SEEDS])
def test_sharded_routes_match_the_jax_step(data, seed, route, dp, db):
    """The raw step on the reads (rows padded to 64, even: single and
    paired) on each route's mesh against the JAX step on that mesh."""
    it = seed[0]
    jdb, tdb = _dbs(data, seed)
    reads = data[_kind(it)][2]
    b = _batch(fastx, reads + [b""] * (64 - len(reads)), it)
    for paired in (False, True):
        want = _jsharded(jdb, it, dp, db, route).step(b.codes, b.lengths,
                                                     paired)
        sc = ShardedClassifier(tdb, TaxTree(PARENTS),
                               make_mesh({"dp": dp, "db": db}, ["cpu"]),
                               canonicalize=False, input_type=it, route=route)
        got = sc.step(b.codes, b.lengths, paired)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert (got[0] != 0).any()


def test_sharded_process_dataset_and_sharded_dir(data, tmp_path):
    """ShardedClassifier.process_dataset and from_sharded_dir(input_type=)
    give the one-device classifier's text."""
    seed = (InputType.PROTEIN_3BIT, 9, None)
    it = seed[0]
    _, tdb = _dbs(data, seed)
    reads = data[_kind(it)][2]
    path = str(tmp_path / "reads.fa")
    with open(path, "wb") as fh:
        for i, r in enumerate(reads):
            fh.write(b">r%d\n%s\n" % (i, r))
    tree = TaxTree(PARENTS)
    want = io.StringIO()
    Classifier(tdb, tree, emit_all=True, input_type=it,
               device="cpu").process_dataset(path, want, batch_size=16)
    d = str(tmp_path / "shards")
    tformats.save_database_sharded(tdb, d, 2, device="cpu")
    for clf in (
            ShardedClassifier(tdb, tree, make_mesh({"dp": 1, "db": 2},
                                                   ["cpu"]),
                              input_type=it, emit_all=True),
            ShardedClassifier.from_sharded_dir(
                d, tree, make_mesh({"dp": 1, "db": 2}, ["cpu"]),
                input_type=it, emit_all=True)):
        got = io.StringIO()
        clf.process_dataset(path, got, batch_size=16)
        assert got.getvalue() == want.getvalue()


@pytest.mark.parametrize("seed", [(InputType.PROTEIN20, 7, None),
                                  (InputType.DNA2, 16, (1,) * 15),
                                  (InputType.DNAC, 20, None)], ids=_id)
def test_canonicalize_is_dropped_for_another_input_type(data, seed):
    it = seed[0]
    jdb, tdb = _dbs(data, seed)
    reads = data[_kind(it)][2]
    want = _jsharded(jdb, it).classify_batch(_batch(jfastx, reads, it))
    jcanon = _jsharded(jdb, it, canonicalize=True).classify_batch(
        _batch(jfastx, reads, it))
    np.testing.assert_array_equal(np.asarray(jcanon.taxa),
                                  np.asarray(want.taxa))
    clf = Classifier(tdb, TaxTree(PARENTS), canonicalize=True,
                     input_type=it, device="cpu")
    assert not clf.canon
    _same_results(clf.classify_batch(_batch(fastx, reads, it), full=True),
                  want)


@pytest.mark.parametrize("it,k,fault", [
    (InputType.PROTEIN20, 7, "unclassified"),
    (InputType.PROTEIN_3BIT, 9, "wrong taxon"),
    (InputType.DNA2, 20, None)])
def test_the_jax_single_chip_upload_fault(data, it, k, fault):
    """The JAX Classifier packs every alphabet's codes into 2 bits, so a
    code past 3 loses its high bit: for PROTEIN20 every read comes back
    unclassified, and for PROTEIN_3BIT the two reads of genome 11's
    residues 310-490 (taxon 2: genome 12 shares them) take taxon 13, whose
    genome holds that stretch as its codes' low 2 bits.  The JAX step on
    codes (its ShardedClassifier) and the port give the reads' taxa; for
    DNA2 (codes 0 and 1) all three agree."""
    seed = (it, k, None)
    jdb, tdb = _dbs(data, seed)
    reads = data[_kind(it)][2][:50]  # the genomes' substrings
    right = np.asarray(_jsharded(jdb, it).classify_batch(
        _batch(jfastx, reads, it)).taxon)
    jc = JClassifier(jdb, JTree(PARENTS), canonicalize=False,
                     input_type=JInputType(int(it)), trim_table=False)
    single = np.asarray(jc.classify_reads(reads))
    port = Classifier(tdb, TaxTree(PARENTS), canonicalize=False,
                      input_type=it, device="cpu").classify_reads(reads)
    np.testing.assert_array_equal(port, right)
    assert (right != 0).sum() >= 40
    if fault is None:
        np.testing.assert_array_equal(single, right)
    elif fault == "unclassified":
        assert (single == 0).all()
    else:
        np.testing.assert_array_equal(right[48:], [2, 2])
        np.testing.assert_array_equal(single[48:], [13, 13])


@pytest.mark.parametrize("gz", ["classify_se.tsv.gz", "classify_pe.tsv.gz"])
def test_dna_given_explicitly_keeps_the_golden_text(gz, tmp_path):
    """input_type=DNA takes the 2-bit words (no codes channel) and writes
    the golden Kraken text."""
    from bonsai_tpu_torch import cli

    mf = json.load(open(os.path.join(GOLD, "manifest.json")))
    cfg = next(c for c in mf["configs"] if c["name"] == mf["classify"]["db"])
    path = str(tmp_path / "lex.btpu")
    assert cli.main(["build", path, *[os.path.join(GOLD, f) for f in (
        "g_phix.fa", "g_phixmut.fa", "g_rand.fa")], *cfg["flags"], "-T",
        os.path.join(GOLD, "nodes.dmp"), "-M",
        os.path.join(GOLD, "nameidmap.txt")]) == 0
    reads = [os.path.join(GOLD, os.path.basename(a))
             for a in mf["classify"]["outputs"][gz] if not a.startswith("-")]
    clf = Classifier(tformats.load_database(path),
                     TaxTree.from_nodes_dmp(os.path.join(GOLD, "nodes.dmp")),
                     emit_all=True, input_type=InputType.DNA, device="cpu")
    assert clf.canon and clf.it == InputType.DNA
    assert clf._prepare_batch(next(iter(fastx.batch_reads(
        reads[0], clf.lut)))).channel != "codes"
    out = io.StringIO()
    clf.process_dataset(reads[0], out, mate_path=reads[1] if len(reads) > 1
                        else None)
    with gzip.open(os.path.join(GOLD, gz), "rt") as fh:
        assert out.getvalue() == fh.read()


def test_radix_wrappers_refuse_what_k1_does_not_take():
    """On any device: int8 codes only, k within the type's fold, never
    canonical (a spaced seed neither), and DNA takes the 2-bit words."""
    from bonsai_tpu_torch.classify import pipeline as pl
    from bonsai_tpu_torch.db.table import ProbeArrays

    t = KmerTable(np.arange(1, 100, dtype=np.uint64),
                  np.ones(99, np.uint32))
    s, v, inline = t.arrays_np()
    arr = ProbeArrays.from_numpy(s, v, inline, t.lgnb, t.vbits, "cpu")
    codes = torch.zeros((4, 40), dtype=torch.int8)
    ln = torch.full((4,), 40, dtype=torch.int32)
    p20 = InputType.PROTEIN20
    with pytest.raises(TypeError, match="codes"):
        pl.encode_probe_radix(codes.to(torch.int32), ln, 7, False, p20, arr,
                              False)
    with pytest.raises(TypeError, match="lengths"):
        pl.encode_only_radix(codes, ln.to(torch.int64), 7, False, p20)
    with pytest.raises(ValueError, match="k=15"):
        pl.encode_probe_radix(codes, ln, 15, False, p20, arr, False)
    with pytest.raises(ValueError, match="never canonicalized"):
        pl.encode_only_radix(codes, ln, 7, True, p20)
    with pytest.raises(ValueError, match="never canonicalized"):
        pl.encode_only_radix(codes, ln, 4, True, p20, (0, 2, 4, 6))
    with pytest.raises(ValueError, match="2-bit words"):
        pl.encode_probe_radix(codes, ln, 7, False, InputType.DNA, arr, False)
    with pytest.raises(ValueError, match="positions"):
        pl.encode_only_radix(codes, ln, 4, False, p20, (0, 2, 2, 6))
    before = pl.encode_probe.launches
    kmers, valid = pl.encode_only_radix(codes, ln, 7, False, p20)
    assert pl.encode_probe.launches == before  # the plain version: no launch
    assert kmers.shape == valid.shape == (4, 34) and valid.all()


@pytest.mark.parametrize("seed", [(InputType.PROTEIN20, 7, None),
                                  (InputType.PROTEIN_3BIT, 22, (1,) * 21)],
                         ids=_id)
def test_a_batch_of_reads_shorter_than_the_seed(data, seed):
    """A batch whose every read is shorter than the seed's span: its
    reads are unclassified, as such reads are in any other batch, also
    where the processing width (the longest read rounded up to 8) leaves
    no position at all (the spaced seed's span of 43).  There the JAX
    Classifier's resolve raises on the empty rows (a reduction of zero
    size)."""
    it, k, gaps = seed
    jdb, tdb = _dbs(data, seed)
    reads = [r[:k - 1] for r in data[_kind(it)][2][:6]] + [b""]
    clf = Classifier(tdb, TaxTree(PARENTS), input_type=it, device="cpu")
    got = clf.classify_batch(_batch(fastx, reads, it), full=True)
    assert (got.taxon == 0).all() and (got.n_kmers == 0).all()
    assert not got.hit_mask.any()
    no_position = clf._prepare_batch(_batch(fastx, reads, it)).lproc < clf.sp.c
    assert no_position == (gaps is not None)
    np.testing.assert_array_equal(clf.classify_reads(reads[:-1]), 0)
    jc = JClassifier(jdb, JTree(PARENTS), input_type=JInputType(int(it)),
                     trim_table=False)
    if no_position:
        with pytest.raises(ValueError, match="zero-size"):
            jc.classify_reads(reads[:-1])
    else:
        np.testing.assert_array_equal(jc.classify_reads(reads[:-1]), 0)
