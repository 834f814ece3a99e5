"""Port parity: classify's read lengths shipped as u16, on the CPU.

Where a batch's longest read is at most 0xFFFF bases, the JAX
``Classifier._prepare_batch`` ships the lengths as u16, 2 B a read
(pipeline.py:667-668), and its step widens them to int32 (``slice_cast``,
:496-501); past that it ships int32.  Checked against the JAX package on
the CPU:

* the width (and values) the port's ``_prepare_batch`` ships equals the
  JAX package's at a longest read of 100, 40,000, 65,535 and 65,536
  bases;
* the plain K1 (``encode_probe`` in the mask, none and sparse channels,
  contiguous canonical and not, spaced, the bucket range, and
  ``encode_only``) on u16 lengths of 40,000 and 65,535 equals the same
  call on int32 lengths, and the contiguous one the JAX step's composition
  of unpack, encoder and probe;
* classify's Kraken text of a batch holding one read of 40,000 bases
  equals the JAX Classifier's;
* the sharded classifier's ranks receive the width the batch chose.

On the CPU every kernel wrapper takes its plain torch version; the
kernel's own u16 loads are held to it on the card
(``tests/test_torch_kernels.py``).  Tolerance: equal values and equal
bytes.
"""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bonsai_tpu  # noqa: F401  (enables jax x64)
from bonsai_tpu.classify import pipeline as jpl
from bonsai_tpu.classify.pipeline import Classifier as JClassifier
from bonsai_tpu.core.encoder import BatchEncoder as JEncoder
from bonsai_tpu.core.spacer import Spacer as JSpacer
from bonsai_tpu.db import formats as jformats
from bonsai_tpu.db import table as jtable
from bonsai_tpu.io import fastx as jfastx
from bonsai_tpu.taxonomy.tree import TaxTree as JTree

from bonsai_tpu_torch import cli
from bonsai_tpu_torch.classify import pipeline as pl
from bonsai_tpu_torch.classify.pipeline import Classifier
from bonsai_tpu_torch.core.alphabet import DNA4
from bonsai_tpu_torch.db import formats as tformats
from bonsai_tpu_torch.db.table import KmerTable, ProbeArrays
from bonsai_tpu_torch.io import fastx
from bonsai_tpu_torch.parallel import sharded
from bonsai_tpu_torch.parallel.mesh import make_mesh
from bonsai_tpu_torch.taxonomy.tree import TaxTree

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(__file__), "data")
GOLD = os.path.join(DATA, "golden")
NODES = os.path.join(GOLD, "nodes.dmp")
NAMEID = os.path.join(GOLD, "nameidmap.txt")
GENOMES = [os.path.join(GOLD, f) for f in ("g_phix.fa", "g_phixmut.fa",
                                           "g_rand.fa")]
READS = os.path.join(GOLD, "reads.fa")


def _long_batch(rng, longest, n=3):
    """n reads, the first ``longest`` bases, the others 50-300, a few
    in-read Ns; (JAX batch, port batch)."""
    lengths = np.concatenate([[longest], rng.integers(50, 301, n - 1)]
                             ).astype(np.int32)
    codes = rng.integers(0, 4, (n, longest)).astype(np.int8)
    codes[np.arange(longest)[None, :] >= lengths[:, None]] = -1
    codes[0, rng.choice(longest, 3, replace=False)] = -1
    names = [f"r{i}".encode() for i in range(n)]
    seqs = [b"A" * int(x) for x in lengths]
    return (jfastx.ReadBatch(names=names, seqs=seqs, codes=codes,
                             lengths=lengths, quals=None),
            fastx.ReadBatch(names=names, seqs=seqs, codes=codes,
                            lengths=lengths, quals=[None] * n))


@pytest.mark.parametrize("longest", [100, 40_000, 65_535, 65_536])
def test_the_width_of_the_lengths_matches_jax(longest):
    jb, tb = _long_batch(np.random.default_rng(longest), longest)
    want = np.asarray(JClassifier.__new__(JClassifier)._prepare_batch(jb)[2])
    tc = Classifier.__new__(Classifier)
    tc.device = torch.device("cpu")
    got = tc._prepare_batch(tb).lengths
    n = len(tb.codes)
    assert want.dtype == (np.uint16 if longest <= 0xFFFF else np.int32)
    assert got.dtype == (torch.uint16 if want.dtype == np.uint16
                         else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want[:n])
    assert int(got.to(torch.int32)[0]) == longest


def _table(rng, keys):
    vals = ((rng.integers(0, 6, keys.size).astype(np.uint64) + np.uint64(7))
            << np.uint64(32)) | np.uint64(3)
    return jtable.KmerTable(keys, vals), KmerTable(keys, vals)


def _jax_k1(pc, nm, lengths, lproc, k, canon, jt):
    """unpack -> lproc slice -> emissions -> probe -> hit/cidx/oidx, as
    the JAX step composes them with its u16 lengths widened."""
    slots, vals, inline = jt.arrays_np()
    codes = jpl.unpack_2bit(jnp.asarray(pc),
                            None if nm is None else jnp.asarray(nm))[:, :lproc]
    em = JEncoder(JSpacer(k, k), canon, "lex").emissions(
        codes, jnp.asarray(lengths).astype(jnp.int32))
    packed, found, sel = jtable.probe_slots_device(
        em.values, jnp.asarray(slots), jnp.asarray(vals), inline, jt.lgnb,
        jt.vbits, want_idx=True)
    hit = em.mask & found
    cidx = jnp.where(hit, (packed & jnp.uint64(0xFFFFFFFF)).astype(jnp.int32), 0)
    oidx = jnp.where(hit, sel, 0).astype(jnp.uint32)
    return [np.asarray(x) for x in (hit, em.mask, cidx, oidx)]


@pytest.fixture(scope="module")
def long_reads():
    """Four reads (lengths 65,535, 40,000, 32,768 and 20) packed by the JAX
    packer at a width of 65,536, and a table holding half their 21-mers;
    K1 runs at lproc 65,535."""
    rng = np.random.default_rng(19)
    k, L = 21, 65_535
    lengths = np.array([L, 40_000, 32_768, 20], dtype=np.int32)
    codes = rng.integers(0, 4, (4, L + 1)).astype(np.int8)
    codes[np.arange(L + 1)[None, :] >= lengths[:, None]] = -1
    codes[1, [0, 17, 39_999]] = -1
    em = JEncoder(JSpacer(k, k), True).emissions(codes, lengths)
    kmers = np.unique(np.asarray(em.values)[np.asarray(em.mask)])
    keys = np.unique(rng.choice(kmers, kmers.size // 2, replace=False))
    jt, tt = _table(rng, keys)
    lproc = L
    pc, nm = jpl.Classifier.pack_codes(codes)
    w16 = (lproc + 15) // 16
    pc = np.ascontiguousarray(pc[:, :w16])
    nm = np.ascontiguousarray(nm[:, : (w16 + 1) // 2])
    arr = ProbeArrays.from_numpy(*tt.arrays_np(), tt.lgnb, tt.vbits, "cpu")
    return dict(k=k, lproc=lproc, lengths=lengths, pc=pc, nm=nm, jt=jt,
                tt=tt, arr=arr, codes=codes)


def _t(a):
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("row", [0, 1], ids=["65535", "40000"])
@pytest.mark.parametrize("canon", [True, False])
def test_plain_k1_on_u16_lengths_matches_jax(long_reads, row, canon):
    d = long_reads
    sl = slice(row, row + 1) if row else slice(0, 4)
    pc, nm, ln = d["pc"][sl], d["nm"][sl], d["lengths"][sl]
    u16 = torch.from_numpy(ln.astype(np.uint16))
    assert int(u16.to(torch.int32)[0]) == int(ln[0])  # 40,000 / 65,535
    want = _jax_k1(pc, nm, ln.astype(np.uint16), d["lproc"], d["k"], canon,
                   d["jt"])
    got = pl.encode_probe(_t(pc), _t(nm), u16, d["lproc"], d["k"], canon,
                          d["arr"], True)
    same = pl.encode_probe(_t(pc), _t(nm), torch.from_numpy(ln), d["lproc"],
                           d["k"], canon, d["arr"], True)
    assert pl.encode_probe.launches == 0  # CPU tensors: the plain version
    for g, s, w in zip(got, same, want):
        assert torch.equal(g, s)
        np.testing.assert_array_equal(g.numpy().view(w.dtype), w)
    assert got[0].any() and (~got[0] & got[1]).any()  # hits and misses
    # the last valid position is the read's own, past 32,767: len - k, or
    # one less where the last base is an N (row 1)
    last = int(np.flatnonzero(got[1][0].numpy())[-1])
    assert last == int(ln[0]) - d["k"] - (row == 1)


@pytest.mark.parametrize("how", ["none", "sparse", "spaced", "spaced sparse",
                                 "range", "encode", "spaced encode"])
def test_every_plain_k1_instantiation_reads_u16_lengths(long_reads, how):
    """Each instantiation on u16 lengths equals the same call on int32."""
    d = long_reads
    k, lproc, ln = d["k"], d["lproc"], d["lengths"]
    codes = np.where(d["codes"] < 0, 1, d["codes"]).astype(np.int8)
    codes[np.arange(codes.shape[1])[None, :] >= ln[:, None]] = -1
    pc, _ = jpl.Classifier.pack_codes(codes)
    pc = _t(np.ascontiguousarray(pc[:, : (lproc + 15) // 16]))
    positions = (tuple(range(0, 2 * k, 2)) if how.startswith("spaced")
                 else None)
    canon = positions is None
    nidx = None
    if "sparse" in how:  # Ns at flat row * lproc + col, sorted, padded
        flat = np.array([0, 17, lproc + 5, lproc + 39_000, 2 * lproc + 32_000],
                        dtype=np.int64)
        nidx = torch.from_numpy(np.concatenate(
            [flat, np.full(59, pl.N_SENTINEL)]).astype(np.int32))
    arr = d["arr"]
    if how == "range":  # a psum rank's rows: the second eighth
        slots, vals, inline = d["tt"].arrays_np()
        rows = slots.shape[0] // 8
        arr = ProbeArrays.from_numpy(slots[rows:2 * rows], vals, inline,
                                     d["tt"].lgnb, d["tt"].vbits, "cpu",
                                     row0=rows, rows=rows)
    lens = {dt: torch.from_numpy(ln.astype(dt)) for dt in (np.int32, np.uint16)}
    if "encode" in how:
        outs = [pl.encode_only(pc, None, lens[dt], lproc, k, canon, positions)
                for dt in lens]
    else:
        outs = [pl.encode_probe(pc, None, lens[dt], lproc, k, canon, arr,
                                True, positions, nidx=nidx) for dt in lens]
    for a, b in zip(*outs):
        assert torch.equal(a, b), how
    valid = outs[1][1]
    c = k if positions is None else positions[-1] + 1
    for r, n in enumerate(ln[:3]):  # the last window of each long read
        v = np.flatnonzero(valid[r].numpy())
        assert v.size and int(v[-1]) == int(n) - c, (how, r)
    assert not valid[3].any()  # 20 bases: shorter than the seed


def test_the_kernel_wrappers_refuse_other_length_widths(long_reads):
    d = long_reads
    with pytest.raises(TypeError, match="int32 or uint16"):
        pl._k1_args(_t(d["pc"]), None, torch.zeros(4, dtype=torch.int16),
                    d["lproc"], d["k"], None)


@pytest.fixture(scope="module")
def lex_db(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lex_k25") / "lex_k25.btpu")
    assert cli.main(["build", path, *GENOMES, "-k", "25", "-T", NODES, "-M",
                     NAMEID]) == 0
    return path


def test_kraken_text_of_a_40000_base_read_matches_jax(lex_db, tmp_path):
    """The first 40 golden reads and one of 40,000 bases: 7 copies of
    phiX with a few substitutions and an N, then random bases."""
    rng = np.random.default_rng(40_000)
    phix = b"".join(s for _, s, _ in fastx.read_fastx(GENOMES[0]))
    long = bytearray((phix * 8)[:36_000] + rng.choice(
        np.frombuffer(b"ACGT", np.uint8), 4_000).tobytes())
    for i in rng.choice(len(long), 30, replace=False):
        long[i] = ord("ACGT"[rng.integers(4)])
    long[12_345] = ord("N")
    reads = tmp_path / "reads.fa"
    with open(READS, "rb") as fh:
        head = b"".join(fh.readlines()[:80])
    reads.write_bytes(head + b">long\n" + bytes(long) + b"\n")
    jc = JClassifier(jformats.load_database(lex_db),
                     JTree.from_nodes_dmp(NODES), emit_all=True)
    tc = Classifier(tformats.load_database(lex_db),
                    TaxTree.from_nodes_dmp(NODES), emit_all=True,
                    device="cpu")
    seen = []
    prep = tc._prepare_batch

    def spy(batch, paired=False, lproc=None):
        p = prep(batch, paired, lproc)
        seen.append(p.lengths.dtype)
        return p

    tc._prepare_batch = spy
    want, got = io.StringIO(), io.StringIO()
    jc.process_dataset(str(reads), want, batch_size=64)
    tc.process_dataset(str(reads), got, batch_size=64)
    assert got.getvalue() == want.getvalue()
    assert torch.uint16 in seen
    line = next(x for x in got.getvalue().splitlines() if "\tlong\t" in x)
    assert line.split("\t")[3] == "40000"


def test_sharded_ranks_receive_the_width_of_the_batch(lex_db):
    tdb = tformats.load_database(lex_db)
    tree = TaxTree.from_nodes_dmp(NODES)
    clf = sharded.ShardedClassifier(tdb, tree, make_mesh({"dp": 1, "db": 2},
                                                         ["cpu"]),
                                    route="a2a", emit_all=True)
    one = Classifier(tdb, tree, emit_all=True, device="cpu")
    for longest, dt in ((300, torch.uint16), (65_536, torch.int32)):
        _, tb = _long_batch(np.random.default_rng(longest), longest, n=4)
        prep = clf._prepare_batch(tb)
        assert prep.lengths.dtype == dt
        ups = clf._uploads(prep)
        assert len(ups) == 2
        for r, (_, _, ln) in ups.items():
            assert ln.dtype == dt and ln.shape == (2,)
        order = sorted(ups, key=clf._block)
        np.testing.assert_array_equal(
            torch.cat([ups[r][2] for r in order]).to(torch.int32).numpy(),
            tb.lengths)
        if longest == 300:  # and the text is the one-device classifier's
            got, want = clf.classify_batch(tb), one.classify_batch(tb)
            for name in ("taxon", "n_missing", "n_kmers"):
                np.testing.assert_array_equal(getattr(got, name),
                                              getattr(want, name))
