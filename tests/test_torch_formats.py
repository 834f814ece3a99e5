"""Port parity: database formats (queue A item 10) on the CPU.

The sharded directory (``save_database_sharded``, ``save_sharded_arrays``,
``load_database_sharded``, ``recommended_shards``), its partition
``shard_owner`` (KS5's plain torch version and the host numpy path) and
``HashShardedTable``, the reference binary's khash image
(``write_bonsai_database``, ``read_bonsai_database``, the fall-through
of ``load_database``), ``DiskBitArray`` / ``MMapTaxonomyBitmap``, and the
CLI (``build --shards N|auto``, ``--bonsai-format``, ``probe-image`` and
``classify`` of each) against the JAX package on the same seeded inputs
and the golden genomes.  Tolerance: equal values and equal file bytes.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from bonsai_tpu import cli as jcli
from bonsai_tpu.db import diskarray as jdisk
from bonsai_tpu.db import formats as jf
from bonsai_tpu.db import table as jtable

from bonsai_tpu_torch import cli
from bonsai_tpu_torch.db import diskarray
from bonsai_tpu_torch.db import formats as tf
from bonsai_tpu_torch.db import table

SEED = 20261018
GOLD = os.path.join(os.path.dirname(__file__), "data", "golden")
NODES = os.path.join(GOLD, "nodes.dmp")
NAMES = os.path.join(GOLD, "nameidmap.txt")
GENOMES = [os.path.join(GOLD, f)
           for f in ("g_phix.fa", "g_phixmut.fa", "g_rand.fa")]


def _keys(rng, n, top=True):
    """n sorted distinct u64 keys, bit 63 set in some."""
    hi = 2**64 if top else 2**62
    k = np.unique(rng.integers(0, hi, n + n // 10 + 10, dtype=np.uint64))
    return np.sort(rng.permutation(k)[:n])


def _dbs(n, vdtype=np.uint32, seed=0):
    """(JAX Database, port Database) of the same n keys and values."""
    rng = np.random.default_rng(SEED + seed)
    keys = _keys(rng, n)
    vals = rng.integers(1, 60, n).astype(vdtype)
    kw = dict(k=31, w=31, gaps=[0] * 30)
    return (jf.Database(table=jtable.KmerTable(keys, vals), **kw),
            tf.Database(table=table.KmerTable(keys, vals), **kw))


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


# -- KS5 and HashShardedTable -------------------------------------------------------

@pytest.mark.parametrize("ndb", [1, 2, 3, 4, 7, 128, 65536, 2**31 - 1])
def test_shard_owner_matches_jax(ndb):
    rng = np.random.default_rng(ndb)
    keys = rng.integers(0, 2**64, 50000, dtype=np.uint64)
    keys[:4] = [0, 2**64 - 1, 2**63, 2**63 - 1]
    want = jtable.shard_owner(keys, ndb)
    assert want.dtype == np.int32 and (want >= 0).all() and (want < ndb).all()
    np.testing.assert_array_equal(table.shard_owner(keys, ndb), want)
    t = torch.from_numpy(keys.view(np.int64))
    got = table.shard_owner(t, ndb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        table.shard_owner(t.reshape(100, 500), ndb).numpy().ravel(), want)


def test_shard_owner_refuses_ndb_out_of_range():
    x = torch.zeros(3, dtype=torch.int64)
    for ndb in (0, -1, 2**31):
        with pytest.raises(ValueError, match="ndb"):
            table.shard_owner(x, ndb)
        with pytest.raises(ValueError, match="ndb"):
            table.shard_owner(np.zeros(3, np.uint64), ndb)


@pytest.mark.parametrize("ndb", [1, 3, 8])
def test_hash_sharded_table_matches_jax(ndb):
    jdb, tdb = _dbs(20000, seed=ndb)
    want = jtable.HashShardedTable(jdb.table, ndb)
    got = table.HashShardedTable(tdb.table, ndb, device="cpu")
    assert (got.ndb, got.nb) == (want.ndb, want.nb)
    keys, vals = tdb.table.keys_sorted, tdb.table.vals_sorted
    for g, w in zip(got.parts, want.parts, strict=True):
        np.testing.assert_array_equal(g, w)
    for p, w in zip(got.parts, want.shards, strict=True):
        placed = table.KmerTable(keys[p], vals[p], min_nb=got.nb)
        assert (placed.lgnb, placed.vbits) == (w.lgnb, w.vbits)
        np.testing.assert_array_equal(placed.arrays_np()[0],
                                      w.arrays_np()[0])


# -- the sharded directory ------------------------------------------------------------

@pytest.mark.parametrize("ndb", [1, 4])
@pytest.mark.parametrize("vdtype", [np.uint32, np.uint64])
def test_sharded_directory_bytes_match_jax(tmp_path, ndb, vdtype):
    """save_database_sharded and save_sharded_arrays of both packages
    write the same shard files, manifest.json and uniq_vals.npy."""
    jdb, tdb = _dbs(30000, vdtype, seed=ndb)
    jf.save_database_sharded(jdb, str(tmp_path / "j"), ndb)
    tf.save_database_sharded(tdb, str(tmp_path / "t"), ndb, device="cpu")
    keys, vals = jdb.table.keys_sorted, jdb.table.vals_sorted
    jf.save_sharded_arrays(keys, vals, str(tmp_path / "ja"), ndb, 31, 31,
                           [0] * 30)
    tf.save_sharded_arrays(keys, vals, str(tmp_path / "ta"), ndb, 31, 31,
                           [0] * 30, device="cpu")
    want = _files(tmp_path / "j")
    assert len(want) == ndb + 2
    assert _files(tmp_path / "t") == want
    assert _files(tmp_path / "ta") == _files(tmp_path / "ja") == want


def test_gzipped_shards_hold_the_same_bytes(tmp_path):
    jdb, tdb = _dbs(5000)
    jf.save_database_sharded(jdb, str(tmp_path / "j"), 2, compress="gz")
    tf.save_database_sharded(tdb, str(tmp_path / "t"), 2, compress="gz",
                             device="cpu")
    for name in ("shard-00000.btpu.gz", "shard-00001.btpu.gz"):
        assert gzip.open(tmp_path / "t" / name).read() == gzip.open(
            tmp_path / "j" / name).read()
    assert _files(tmp_path / "t")["manifest.json"] == _files(
        tmp_path / "j")["manifest.json"]
    back = tf.load_database_sharded(str(tmp_path / "t"))
    np.testing.assert_array_equal(back.table.keys_sorted,
                                  jdb.table.keys_sorted)


def test_save_sharded_arrays_refuses_unsorted_or_repeated_keys(tmp_path):
    vals = np.ones(3, np.uint32)
    for keys in ([3, 1, 2], [1, 2, 2]):
        with pytest.raises(ValueError, match="sorted and unique"):
            tf.save_sharded_arrays(np.array(keys, np.uint64), vals,
                                   str(tmp_path / "x"), 2, 31, 31, [0] * 30,
                                   device="cpu")
    assert not os.path.exists(tmp_path / "x")


@pytest.mark.parametrize("ranks", [None, [2], [0, 3]])
def test_load_database_sharded_matches_jax(tmp_path, ranks):
    jdb, _ = _dbs(20000, seed=7)
    d = str(tmp_path / "sh")
    jf.save_database_sharded(jdb, d, 4)
    want = jf.load_database_sharded(d, ranks)
    got = tf.load_database_sharded(d, ranks)
    np.testing.assert_array_equal(got.table.keys_sorted,
                                  want.table.keys_sorted)
    np.testing.assert_array_equal(got.table.vals_sorted,
                                  want.table.vals_sorted)
    assert got.table.vals_sorted.dtype == want.table.vals_sorted.dtype
    assert (got.k, got.w, got.gaps, got.canonicalize, got.scheme, got.meta) \
        == (want.k, want.w, want.gaps, want.canonicalize, want.scheme,
            want.meta)
    np.testing.assert_array_equal(got.table.arrays_np()[0],
                                  want.table.arrays_np()[0])


def test_recommended_shards_matches_jax():
    """The cases of tests/test_scale.py: 128 MiB of slots a shard."""
    assert tf.table_slot_bytes(10_000_000) == 128 << 20
    for n, s in ((10_000_000, 1), (8_000_000, 1), (40_000_000, 4),
                 (110_000_000, 8), (1_000_000_000, 128), (10_351_234, 1)):
        assert tf.recommended_shards(n) == jf.recommended_shards(n) == s
    for n in (0, 1, 10**6, 10**7, 10**8, 10**9, 10**12, 10**15):
        assert tf.recommended_shards(n) == jf.recommended_shards(n)
        assert tf.table_slot_bytes(n) == jf.table_slot_bytes(n)
    assert tf.recommended_shards(10**15) == 65536


# -- the reference khash image --------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 3000])
@pytest.mark.parametrize("vdtype", [np.uint32, np.uint64])
def test_khash_image_crosses_between_packages(tmp_path, n, vdtype):
    """Each package writes the same bytes, and reads the other's file."""
    jdb, tdb = _dbs(n, vdtype, seed=n)
    jdb.gaps = tdb.gaps = [0] * 10 + [3] * 10 + [300] * 10  # one byte each
    jf.write_bonsai_database(jdb, str(tmp_path / "j.db"))
    tf.write_bonsai_database(tdb, str(tmp_path / "t.db"))
    raw = open(tmp_path / "j.db", "rb").read()
    assert open(tmp_path / "t.db", "rb").read() == raw
    for path in (tmp_path / "j.db", tmp_path / "t.db"):
        want = jf.read_bonsai_database(str(path))
        got = tf.read_bonsai_database(str(path))
        assert got[:3] == want[:3] and got[5] == want[5]
        np.testing.assert_array_equal(got[3], want[3])
        np.testing.assert_array_equal(got[4], want[4])
        assert got[4].dtype == want[4].dtype
        db = tf.load_database(str(path))  # the fall-through
        np.testing.assert_array_equal(db.table.keys_sorted,
                                      jdb.table.keys_sorted)
        np.testing.assert_array_equal(db.table.vals_sorted,
                                      jdb.table.vals_sorted)
        assert db.meta == jf.import_bonsai_database(str(path)).meta


def test_khash_image_gzipped(tmp_path):
    jdb, tdb = _dbs(2000, seed=9)
    tf.write_bonsai_database(tdb, str(tmp_path / "t.db"), compress=True)
    jf.write_bonsai_database(jdb, str(tmp_path / "j.db"))
    assert gzip.open(tmp_path / "t.db").read() == open(
        tmp_path / "j.db", "rb").read()
    tf.write_bonsai_database(tdb, str(tmp_path / "t.db.gz"))
    got = tf.load_database(str(tmp_path / "t.db.gz"))
    np.testing.assert_array_equal(got.table.keys_sorted,
                                  jdb.table.keys_sorted)


@pytest.mark.parametrize("content", [b"", b"BTPU", b"not a database\n",
                                     b"\x1f\x00\x00\x00\x1f\x00\x00\x00"])
def test_a_file_that_is_no_database_is_refused(tmp_path, content):
    path = tmp_path / "x.db"
    path.write_bytes(content)
    with pytest.raises(tf.NotADatabase, match="neither a BTPU1"):
        tf.load_database(str(path))


# -- DiskBitArray and MMapTaxonomyBitmap --------------------------------------------

def test_diskbitarray_matches_jax(tmp_path):
    rng = np.random.default_rng(SEED)
    rows, cols = rng.integers(0, 100, 500), rng.integers(0, 37, 500)
    got = diskarray.DiskBitArray(str(tmp_path / "t.bin"), 100, 37, True)
    want = jdisk.DiskBitArray(str(tmp_path / "j.bin"), 100, 37, True)
    for d in (got, want):
        d.set_bits(rows, cols)
        d.set_bits(np.array([0, 99]), np.array([36, 0]))
        d.flush()
    assert open(tmp_path / "t.bin", "rb").read() == open(
        tmp_path / "j.bin", "rb").read()
    np.testing.assert_array_equal(got.popcounts(), want.popcounts())
    for r in (0, 5, 99):
        np.testing.assert_array_equal(got.row(r), want.row(r))
        assert got.get_bit(r, 36) == want.get_bit(r, 36)
    again = diskarray.DiskBitArray(str(tmp_path / "j.bin"), 100, 37)
    np.testing.assert_array_equal(again.popcounts(), want.popcounts())


def test_mmap_taxonomy_bitmap_matches_jax(tmp_path):
    rng = np.random.default_rng(SEED + 1)
    keys = _keys(rng, 1000)
    got = diskarray.MMapTaxonomyBitmap(str(tmp_path / "t.bin"), keys, 8, True)
    want = jdisk.MMapTaxonomyBitmap(str(tmp_path / "j.bin"), keys, 8, True)
    for bm in (got, want):
        bm.set_kmers(keys[:100], 0)
        bm.set_kmers(keys[50:150], 3)
        bm.set_kmers(np.array([keys[0] + 1], dtype=np.uint64), 5)  # absent
        bm.flush()
    for f in ("t.bin", "t.bin.meta"):
        assert open(tmp_path / f, "rb").read() == open(
            tmp_path / f.replace("t", "j", 1), "rb").read()
    for kmer in (int(keys[60]), int(keys[200]), int(keys[0]) + 1):
        g, w = got.kmer_row(kmer), want.kmer_row(kmer)
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g, w)
    back = diskarray.MMapTaxonomyBitmap.open(str(tmp_path / "t.bin"), keys)
    assert back.kmer_row(int(keys[60]))[3]


# -- the CLI on the golden genomes ------------------------------------------------------

BUILDS = {  # output name -> the build's flags
    "sh2": ["--shards", "2"],
    "shauto": ["--shards", "auto"],
    "kh.db": ["--bonsai-format"],
    "kh.db.gz": ["--bonsai-format", "-z"],
    "both": ["--bonsai-format", "--shards", "3"],
    "lex.btpu": [],
}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The same builds, probe images and classifications through each
    package's CLI: {package: directory}."""
    out = {}
    for pkg, main, dev in (("jax", jcli.main, []),
                           ("torch", cli.main, ["--device", "cpu"])):
        d = tmp_path_factory.mktemp(pkg)
        for name, flags in BUILDS.items():
            assert main(["build", str(d / name), *GENOMES, "-k", "25", "-T",
                         NODES, "-M", NAMES, *flags,
                         *(dev if "--shards" in flags else [])]) == 0
        for db, img in (("lex.btpu", "img"), ("kh.db", "imgkh")):
            assert main(["probe-image", str(d / db), NODES, str(d / img)]) == 0
        for db in ("sh2", "shauto", "kh.db", "kh.db.gz", "both", "img",
                   "imgkh"):
            assert main(["classify", str(d / db), NODES,
                         os.path.join(GOLD, "reads.fa"), "-a", "-o",
                         str(d / f"{db}.out"), *dev]) == 0
        out[pkg] = d
    return out


@pytest.mark.parametrize("name", ["sh2", "shauto", "both"])
def test_cli_sharded_directories_match_jax(cli_runs, name):
    """--shards N and auto (1 here), and --shards with --bonsai-format
    (the shards take precedence), byte for byte."""
    want = _files(cli_runs["jax"] / name)
    assert _files(cli_runs["torch"] / name) == want
    assert len(want) == {"sh2": 4, "shauto": 3, "both": 5}[name]


def test_cli_khash_and_probe_images_match_jax(cli_runs):
    j, t = cli_runs["jax"], cli_runs["torch"]
    assert (t / "kh.db").read_bytes() == (j / "kh.db").read_bytes()
    assert gzip.open(t / "kh.db.gz").read() == (j / "kh.db").read_bytes()
    for img in ("img", "imgkh"):
        assert _files(t / img) == _files(j / img)


@pytest.mark.parametrize("db", ["sh2", "shauto", "kh.db", "kh.db.gz", "both",
                                "img", "imgkh"])
def test_cli_classify_of_each_format_matches_jax(cli_runs, db):
    """Kraken text of every read, from a sharded directory (merged), a
    khash image (plain and gzipped) and the probe images of a BTPU1 and a
    khash database: the JAX CLI's, and that of the BTPU1 database."""
    want = (cli_runs["jax"] / f"{db}.out").read_bytes()
    assert (cli_runs["torch"] / f"{db}.out").read_bytes() == want
    assert want == (cli_runs["jax"] / "sh2.out").read_bytes()


@pytest.mark.parametrize("argv", [
    ["classify", "{d}/sh2", NODES, "reads", "--db-shards", "2"],
    ["classify", "{d}/lex.btpu", NODES, "reads", "--route", "a2a"],
    ["classify", "{d}/lex.btpu", NODES, "reads", "--distributed"],
    ["probe-image", "{d}/sh2", NODES],
    ["probe-image", "{d}/lex.btpu", NODES, "{d}/x", "--db-ranks", "2"],
])
def test_cli_multi_gpu_options_exit_2_naming_item_11(cli_runs, argv, capsys,
                                                      tmp_path):
    """The multi-GPU options that the port refused while ROADMAP queue A
    item 11 was open now run as the JAX CLI's do: --db-shards 2 (the
    sharded directory a rank at a time) and --route a2a (no --db-shards:
    the one-device classifier) give the JAX CLI's text; --distributed
    outside torchrun's environment exits 2 naming what is missing;
    probe-image bakes per-rank images of a sharded directory, and of a
    BTPU1 file writes its probe image (--db-ranks ignored, as there)."""
    d = str(tmp_path)
    for name in ("sh2", "lex.btpu"):  # copies: the module's files stay
        src = cli_runs["torch"] / name
        if src.is_dir():
            os.makedirs(os.path.join(d, name))
            for f in os.listdir(src):
                with open(src / f, "rb") as a, open(os.path.join(d, name, f),
                                                   "wb") as b:
                    b.write(a.read())
        else:
            with open(src, "rb") as a, open(os.path.join(d, name), "wb") as b:
                b.write(a.read())
    args = [a.format(d=d) for a in argv]
    if argv[0] == "probe-image":
        assert cli.main(args) == 0
        if "--db-ranks" in argv:
            assert _files(tmp_path / "x") == _files(cli_runs["jax"] / "img")
        else:
            assert any(f.startswith("rankimg-db2-")
                       for f in os.listdir(os.path.join(d, "sh2")))
        return
    args[args.index("reads")] = os.path.join(GOLD, "reads.fa")
    out = os.path.join(d, "out.tsv")
    rc = cli.main(args + ["-a", "-o", out, "--device", "cpu"])
    if "--distributed" in argv:
        assert rc == 2
        assert "torchrun" in capsys.readouterr().err
        assert not os.path.exists(out)
        return
    assert rc == 0
    with open(out, "rb") as fh:
        assert fh.read() == (cli_runs["jax"] / "sh2.out").read_bytes()


def test_cli_probe_image_needs_an_out_dir(cli_runs, capsys):
    assert cli.main(["probe-image", str(cli_runs["torch"] / "lex.btpu"),
                     NODES]) == 2
    assert "needs OUT_DIR" in capsys.readouterr().err
