"""Port parity: classify's sparse-N upload channel, on the CPU.

A batch's in-read Ns reach the device through one of three channels, as
the JAX ``Classifier._prepare_batch`` picks them (``none``; ``sparse``: a
sorted list of at most ``max(64, Bp // 32)`` flat positions row * lproc +
col, Bp the JAX package's padded batch; ``mask``).  Checked against the
JAX package on the CPU:

* the port's (channel, list or mask) equals the JAX ``_prepare_batch``'s
  (nmode, naux) on the three batches of each kraken set at ``-c 4096``,
  on synthetic batches of 1, 300, 5000 and 8192 reads with 0, 1, cap and
  cap + 1 in-read Ns (at column 0, at len - 1, and Ns past a read's length
  that neither package lists), and on a paired batch with its Ns in
  mate 2;
* ``n_channel`` with small stand-in numbers for the sentinel hazard;
* ``classify_batch`` (taxon, counters, positional hits and runs) equals
  the JAX package's in each channel, against a contiguous and a spaced
  (``-S``) database;
* the plain sparse and mask channels of K1 give equal outputs;
* the sharded classifier never takes the sparse channel, and its text is
  the one-device classifier's.

On the CPU every kernel wrapper takes its plain torch version.
Tolerance: equal values and equal bytes.
"""

import gzip
import io
import json
import os

import numpy as np
import pytest
import torch

from bonsai_tpu.classify.pipeline import Classifier as JClassifier
from bonsai_tpu.db import formats as jformats
from bonsai_tpu.io import fastx as jfastx
from bonsai_tpu.taxonomy.tree import TaxTree as JTree

from bonsai_tpu_torch import cli
from bonsai_tpu_torch.classify import output as out_mod
from bonsai_tpu_torch.classify import pipeline as pl
from bonsai_tpu_torch.classify.pipeline import Classifier
from bonsai_tpu_torch.core.alphabet import DNA4
from bonsai_tpu_torch.db import formats as tformats
from bonsai_tpu_torch.io import fastx
from bonsai_tpu_torch.parallel import sharded
from bonsai_tpu_torch.parallel.mesh import make_mesh
from bonsai_tpu_torch.taxonomy.tree import TaxTree

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(__file__), "data")
GOLD = os.path.join(DATA, "golden")
MANIFEST = json.load(open(os.path.join(GOLD, "manifest.json")))
KRAKEN = MANIFEST["kraken"]
NODES = os.path.join(GOLD, "nodes.dmp")
NAMEID = os.path.join(GOLD, "nameidmap.txt")
GENOMES = [os.path.join(GOLD, f) for f in ("g_phix.fa", "g_phixmut.fa",
                                           "g_rand.fa")]
READS = os.path.join(GOLD, "reads.fa")
# the JAX package's channels at -c 4096, batch by batch
SET_CHANNELS = {"HiSeq": ["sparse", "none", "sparse"],
                "MiSeq": ["mask", "mask", "sparse"],
                "ec_k12": ["sparse", "mask", "sparse"]}


def _hosts():
    """A JAX and a port classifier for the host half alone: packing needs
    no database."""
    jc = JClassifier.__new__(JClassifier)
    tc = Classifier.__new__(Classifier)
    tc.device = torch.device("cpu")
    return jc, tc


def _u32(t):
    return t.numpy().view(np.uint32)


def _same_prep(jc, tc, jbatch, tbatch, paired=False):
    """The port's prep equals the JAX package's; returns the channel."""
    jp = jc._prepare_batch(jbatch, paired)
    tp = tc._prepare_batch(tbatch, paired)
    n = len(tbatch.codes)
    nmode, naux, lproc = jp[4], jp[1], jp[3]
    assert tp.channel == nmode and tp.lproc == lproc
    np.testing.assert_array_equal(_u32(tp.pcodes), np.asarray(jp[0])[:n])
    np.testing.assert_array_equal(tp.lengths.numpy(),
                                  np.asarray(jp[2])[:n].astype(np.int32))
    if nmode == "none":
        assert tp.naux is None and naux is None
    elif nmode == "sparse":
        # the whole list, sentinels included
        np.testing.assert_array_equal(_u32(tp.nidx), np.asarray(naux))
    else:
        np.testing.assert_array_equal(_u32(tp.nmask), np.asarray(naux)[:n])
    return nmode


@pytest.mark.parametrize("which", sorted(SET_CHANNELS))
def test_kraken_set_channels_match_jax(which):
    jc, tc = _hosts()
    path = os.path.join(DATA, KRAKEN["sets"][which]["reads"])
    got = [_same_prep(jc, tc, jb, tb) for jb, tb in zip(
        jfastx.batch_reads(path, DNA4.lut, batch_size=4096),
        fastx.batch_reads(path, DNA4.lut, batch_size=4096))]
    assert got == SET_CHANNELS[which]


def _synthetic(rng, n, n_ns, L=128):
    """n reads of 20..L bases (100..L for one read) with random bases past
    each length too, some of them Ns, which neither package lists, and
    ``n_ns`` in-read Ns, among them one at column 0 and one at len - 1
    where there are two or more."""
    lengths = rng.integers(20 if n > 1 else 100, L + 1, n).astype(np.int32)
    codes = rng.integers(0, 4, (n, L)).astype(np.int8)
    past = rng.random((n, L)) < 0.05
    past &= np.arange(L)[None, :] >= lengths[:, None]
    codes[past] = -1
    flat = np.flatnonzero(np.arange(L)[None, :] < lengths[:, None])
    pick = rng.choice(flat, n_ns, replace=False)
    if n_ns >= 2:
        r0, r1 = pick[0] // L, pick[1] // L
        pick[0], pick[1] = r0 * L, r1 * L + lengths[r1] - 1
        pick = np.unique(pick)
        while pick.size < n_ns:  # the edits collided with a pick
            pick = np.unique(np.append(pick, rng.choice(flat)))
    codes.reshape(-1)[pick] = -1
    return codes, lengths


def _batches(codes, lengths):
    n = len(lengths)
    names = [f"r{i}".encode() for i in range(n)]
    seqs = [b"A" * int(x) for x in lengths]
    return (jfastx.ReadBatch(names=names, seqs=seqs, codes=codes,
                             lengths=lengths, quals=None),
            fastx.ReadBatch(names=names, seqs=seqs, codes=codes,
                            lengths=lengths, quals=[None] * n))


@pytest.mark.parametrize("n", [1, 300, 5000, 8192])
def test_synthetic_channels_match_jax(n):
    jc, tc = _hosts()
    cap = pl.sparse_cap(pl.bucket_rows(n))
    assert cap == max(64, jc._bucket_batch(n) // 32)
    rng = np.random.default_rng(n)
    for n_ns, channel in ((0, "none"), (1, "sparse"), (cap, "sparse"),
                          (cap + 1, "mask")):
        got = _same_prep(jc, tc, *_batches(*_synthetic(rng, n, n_ns)))
        assert got == channel, (n, n_ns)


def test_paired_batch_with_ns_in_mate_2():
    jc, tc = _hosts()
    rng = np.random.default_rng(5)
    codes, lengths = _synthetic(rng, 600, 0)
    mate2 = rng.choice(np.arange(1, 600, 2), 40, replace=False)
    codes[mate2, 3] = -1
    assert _same_prep(jc, tc, *_batches(codes, lengths), paired=True) \
        == "sparse"
    codes[rng.choice(np.arange(1, 600, 2), 30, replace=False), 7] = -1
    assert _same_prep(jc, tc, *_batches(codes, lengths), paired=True) \
        == "mask"


def test_n_channel_takes_the_mask_where_positions_reach_the_sentinel():
    assert pl.n_channel(0, 64, 256, 104) == "none"
    assert pl.n_channel(1, 64, 256, 104) == "sparse"
    assert pl.n_channel(65, 64, 256, 104) == "mask"
    assert pl.n_channel(1, 64, 256, 104, sparse_ok=False) == "mask"
    # stand-in numbers: 10 x 10 flat positions against a sentinel of 99
    # and of 100
    assert pl.n_channel(1, 64, 10, 10, limit=99) == "mask"
    assert pl.n_channel(1, 64, 10, 10, limit=100) == "sparse"
    # the real sentinel: 2^20 rows of 2048 columns reach it
    assert pl.n_channel(1, 1 << 15, 1 << 20, 2048) == "mask"
    assert pl.n_channel(1, 1 << 15, 1 << 20, 2047) == "sparse"
    assert pl.bucket_rows(5000) == 8192 and pl.sparse_cap(8192) == 256
    assert 5000 // 32 == 156  # the cap of the rows themselves would differ


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """The golden lex_k25 and spaced_k21 databases, built by the port's
    CLI."""
    out = {}
    for name in ("lex_k25", "spaced_k21"):
        cfg = next(c for c in MANIFEST["configs"] if c["name"] == name)
        path = str(tmp_path_factory.mktemp(name) / f"{name}.btpu")
        assert cli.main(["build", path, *GENOMES, *cfg["flags"], "-T", NODES,
                         "-M", NAMEID]) == 0
        out[name] = path
    return out


def _channel_batch(channel):
    """The first 300 golden reads with their in-read Ns replaced by bases,
    then 0, 10 or 65 Ns (cap 64) put in."""
    b = next(iter(fastx.batch_reads(READS, DNA4.lut, batch_size=300)))
    codes, lengths = b.codes.copy(), b.lengths.copy()
    inread = np.arange(codes.shape[1])[None, :] < lengths[:, None]
    codes[(codes < 0) & inread] = 2
    rng = np.random.default_rng(11)
    n_ns = {"none": 0, "sparse": 10, "mask": 65}[channel]
    codes.reshape(-1)[rng.choice(np.flatnonzero(inread), n_ns,
                                 replace=False)] = -1
    return _batches(codes, lengths)


@pytest.mark.parametrize("db", ["lex_k25", "spaced_k21"])
@pytest.mark.parametrize("channel", ["none", "sparse", "mask"])
def test_classify_batch_matches_jax_in_each_channel(dbs, db, channel):
    jc = JClassifier(jformats.load_database(dbs[db]),
                     JTree.from_nodes_dmp(NODES), emit_all=True)
    tc = Classifier(tformats.load_database(dbs[db]),
                    TaxTree.from_nodes_dmp(NODES), emit_all=True,
                    device="cpu")
    jb, tb = _channel_batch(channel)
    assert tc._prepare_batch(tb).channel == channel
    assert jc._prepare_batch(jb)[4] == channel
    for full in (True, False):
        got = tc.classify_batch(tb, full=full)
        want = jc.classify_batch(jb, full=full)
        names = ("taxon", "n_missing", "n_kmers", "n_kmers1")
        names += (("taxa", "hit_mask") if full else
                  ("run_vals", "run_lens", "n_runs"))
        for name in names:
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(want, name)),
                                          err_msg=f"{db} {channel} {name}")


class MaskOnly(Classifier):
    def _sparse_n_ok(self):
        return False


@pytest.mark.parametrize("db", ["lex_k25", "spaced_k21"])
def test_plain_sparse_equals_plain_mask(dbs, db):
    tdb = tformats.load_database(dbs[db])
    tree = TaxTree.from_nodes_dmp(NODES)
    sc = Classifier(tdb, tree, device="cpu")
    mc = MaskOnly(tdb, tree, device="cpu")
    _, tb = _channel_batch("sparse")
    sp, mp = sc._prepare_batch(tb), mc._prepare_batch(tb)
    assert (sp.channel, mp.channel) == ("sparse", "mask")
    assert int((_u32(sp.nidx) != pl.N_SENTINEL).sum()) == 10
    args = (sp.lproc, sc.k, sc.canon, sc.arr, True, sc.positions)
    got = pl.encode_probe(sp.pcodes, None, sp.lengths, *args, nidx=sp.nidx)
    want = pl.encode_probe(mp.pcodes, mp.nmask, mp.lengths, *args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the same through the whole step
    a, b = sc.classify_batch(tb, full=True), mc.classify_batch(tb, full=True)
    for name in ("taxon", "taxa", "hit_mask", "n_missing", "n_kmers"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_unpack_n_drops_entries_past_the_batch():
    pc = torch.zeros((2, 1), dtype=torch.int32)
    nidx = torch.tensor([0, 17, 31, 32, 99, pl.N_SENTINEL], dtype=torch.int32)
    codes = pl.unpack_n(pc, None, 16, nidx)
    assert codes.shape == (2, 16)
    assert codes.reshape(-1).nonzero().reshape(-1).tolist() == [0, 17, 31]
    assert int(codes.sum()) == -3


def test_sharded_classifier_never_takes_the_sparse_channel(dbs):
    tdb = tformats.load_database(dbs["lex_k25"])
    tree = TaxTree.from_nodes_dmp(NODES)
    _, tb = _channel_batch("sparse")
    one = Classifier(tdb, tree, emit_all=True, device="cpu")
    assert one._prepare_batch(tb).channel == "sparse"
    want = out_mod.format_batch(one.classify_batch(tb), one.sp.c,
                                emit_all=True)
    for route, shape in (("a2a", {"dp": 1, "db": 2}),
                         ("psum", {"dp": 2, "db": 2})):
        sc = sharded.ShardedClassifier(tdb, tree, make_mesh(shape, ["cpu"]),
                                       route=route, emit_all=True)
        assert sc._prepare_batch(tb).channel == "mask"
        assert Classifier._prepare_batch(sc, tb).channel == "mask"
        got = out_mod.format_batch(sc.classify_batch(tb), sc.sp.c,
                                   emit_all=True)
        assert got == want, route


def test_classify_cli_golden_through_the_sparse_channel(dbs, tmp_path):
    """The golden single-end text, read by read in batches of 64: some
    batches carry 1-64 in-read Ns, and take the sparse channel."""
    tdb = tformats.load_database(dbs["lex_k25"])
    clf = Classifier(tdb, TaxTree.from_nodes_dmp(NODES), emit_all=True,
                     device="cpu")
    seen = []
    prep = clf._prepare_batch

    def spy(batch, paired=False, lproc=None):
        p = prep(batch, paired, lproc)
        seen.append(p.channel)
        return p

    clf._prepare_batch = spy
    out = io.StringIO()
    clf.process_dataset(READS, out, batch_size=64)
    with gzip.open(os.path.join(GOLD, "classify_se.tsv.gz"), "rt") as fh:
        assert out.getvalue() == fh.read()
    assert "sparse" in seen
