"""Port parity: the JAX package's small helpers that the port had no name
for, on inputs made from a numpy seed, against the JAX functions:
``TDdepth``, ``TDtax``, ``FMcount`` and ``FMtax`` (``db/build.py``),
``BatchEncoder.emitted_set`` (``core/encoder.py``), ``codes_from_bytes``,
``canonicalize`` and ``overflow_to_canonical_zero`` (``core/encode.py``),
``format_read`` (``classify/output.py``), the static ``pack_codes`` of
``Classifier`` and ``ShardedClassifier``; ``KmerTable.trim`` and
``lookup`` and ``Classifier(trim_table=)``, ``Database.spacer``,
``native.available`` and ``init_distributed(coordinator=,
num_processes=, process_id=)`` with the card it binds.  Tolerance: exact
equality (integer work and text)."""

import numpy as np
import pytest
import torch

import bonsai_tpu  # noqa: F401  (enables jax x64)
from bonsai_tpu.classify import output as joutput
from bonsai_tpu.classify.pipeline import Classifier as JClassifier
from bonsai_tpu.core import encode as jencode
from bonsai_tpu.core.alphabet import alphabet_of as jalphabet_of
from bonsai_tpu.core.encoder import BatchEncoder as JEncoder
from bonsai_tpu.core.spacer import Spacer as JSpacer
from bonsai_tpu.db import build as jbuild
from bonsai_tpu.parallel.sharded import ShardedClassifier as JSharded

from bonsai_tpu_torch.classify import output
from bonsai_tpu_torch.classify.pipeline import Classifier
from bonsai_tpu_torch.core import encode
from bonsai_tpu_torch.core.alphabet import InputType
from bonsai_tpu_torch.core.encoder import BatchEncoder
from bonsai_tpu_torch.core.spacer import Spacer
from bonsai_tpu_torch.db import build
from bonsai_tpu_torch.parallel.sharded import ShardedClassifier


@pytest.mark.parametrize("name", ["TDdepth", "TDtax", "FMcount", "FMtax"])
def test_value_fields_match_jax(name):
    rng = np.random.default_rng(len(name))
    v = rng.integers(0, 2**64, 1000, dtype=np.uint64)
    v[:4] = [0, 2**64 - 1, 1 << 32, 0xFFFFFFFF]
    depth = rng.integers(0, 50, 1000).astype(np.uint32)
    taxa = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    for x in (v, build.TDencode(depth, taxa), build.FMencode(depth, taxa)):
        got, want = getattr(build, name)(x), getattr(jbuild, name)(x)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(build.TDdepth(build.TDencode(depth, taxa)),
                                  depth)
    np.testing.assert_array_equal(build.TDtax(build.TDencode(depth, taxa)),
                                  taxa)
    np.testing.assert_array_equal(build.FMcount(build.FMencode(depth, taxa)),
                                  depth)
    np.testing.assert_array_equal(build.FMtax(build.FMencode(depth, taxa)),
                                  taxa)


SETS = {  # name -> (k, w, spacing, canonicalize, input type)
    "canonical -w": (21, 30, None, True, InputType.DNA),
    "unwindowed": (15, 15, None, True, InputType.DNA),
    "-C -w": (21, 30, None, False, InputType.DNA),
    "-S": (11, 30, "1x10", False, InputType.DNA),
    "PROTEIN20 -w": (5, 14, None, False, InputType.PROTEIN20),
}


@pytest.mark.parametrize("name", sorted(SETS))
def test_emitted_set_matches_jax(name):
    k, w, spacing, canon, it = SETS[name]
    rng = np.random.default_rng(k + w)
    chars = np.frombuffer(b"ACGTN" if it == InputType.DNA else
                          b"ACDEFGHIKLMNPQRSTVWYX", np.uint8)
    p = np.full(chars.size, 0.98 / (chars.size - 1))
    p[-1] = 0.02  # N or X: ambiguous
    seqs = rng.choice(chars, (6, 300), p=p)
    codes = jalphabet_of(it).lut[seqs]
    lengths = rng.integers(k - 1, 301, 6).astype(np.int32)
    codes[np.arange(300)[None, :] >= lengths[:, None]] = -1
    want = JEncoder(JSpacer(k, w, spacing), canon, "lex", it).emitted_set(
        codes, lengths)
    got = BatchEncoder(Spacer(k, w, spacing), canon, "lex", it).emitted_set(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    assert got.dtype == np.uint64 and got.size > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("it", [InputType.DNA, InputType.PROTEIN20,
                                InputType.PROTEIN],
                         ids=lambda t: t.name)
def test_codes_from_bytes_matches_jax(it):
    rng = np.random.default_rng(int(it))
    seq = rng.integers(0, 256, (3, 500)).astype(np.uint8)
    lut = jalphabet_of(it).lut
    got = encode.codes_from_bytes(torch.from_numpy(seq), lut)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(),
                                  jencode.codes_from_bytes(seq, lut))


@pytest.mark.parametrize("k", [1, 15, 31, 32])
def test_overflow_to_canonical_zero_matches_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (4, 200)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.05] = -1
    kmers, invalid = jencode.pack_kmers(codes, k)
    kmers = jencode.apply_mask(kmers, k, InputType.DNA)
    want = jencode.overflow_to_canonical_zero(kmers, invalid, k)
    got = encode.overflow_to_canonical_zero(
        torch.from_numpy(np.ascontiguousarray(kmers).view(np.int64)),
        torch.from_numpy(np.asarray(invalid)), k)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    assert (got[torch.from_numpy(np.asarray(invalid))] == 0).all()


def test_format_read_matches_jax():
    rng = np.random.default_rng(46)
    taxa = rng.choice(np.array([0, 11, 12, 0xFFFFFFFF], np.uint32), 40)
    for taxon in (0, 11, 0xFFFFFFFF):
        for missing, ambig in ((0, 0), (3, 0), (0, 7), (2, 2)):
            for hits in (taxa, taxa[:1], np.zeros(0, np.uint32)):
                got = output.format_read("read/1", taxon, 101, missing, ambig,
                                         hits)
                assert got == joutput.format_read("read/1", taxon, 101,
                                                  missing, ambig, hits)
    assert output.format_read("r", 0, 50, 0, 0, taxa) == "U\tr\t0\t50\t0:0\n"


@pytest.mark.parametrize("with_nmask", [True, False])
@pytest.mark.parametrize("L", [32, 96, 160])
def test_pack_codes_matches_jax(L, with_nmask):
    rng = np.random.default_rng(L + with_nmask)
    codes = rng.integers(-1, 4, (5, L)).astype(np.int8)
    want = JClassifier.pack_codes(codes, with_nmask)
    for cls in (Classifier, ShardedClassifier):
        got = cls.pack_codes(codes, with_nmask)
        np.testing.assert_array_equal(got[0], want[0])
        if with_nmask:
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got[1] is None and want[1] is None
    np.testing.assert_array_equal(JSharded.pack_codes(codes, with_nmask)[0],
                                  want[0])


# -- the gaps of the signature walk (classify of the other alphabets) ---------

def _tables(n=5000, seed=3):
    from bonsai_tpu.db.table import KmerTable as JTable

    from bonsai_tpu_torch.db.table import KmerTable

    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 2**64, n, dtype=np.uint64))
    vals = rng.integers(0, 9, keys.size).astype(np.uint32)
    return JTable(keys, vals), KmerTable(keys, vals), keys, vals


def test_kmer_table_trim_rebuilds_the_same_layout():
    """trim frees the placement's arrays and the kept image; every later
    use places again at the same bucket count, to the same slots (the
    JAX package's trim and _ensure_layout)."""
    jt, t, keys, vals = _tables()
    before = t.arrays_np()
    flat = t.encode_slots(vals, allow_inline=False)
    t.trim()
    jt.trim()
    assert t._occ is None and t._own is None and t._word is None
    assert t._np_arrays is None
    after = t.arrays_np()
    for a, b in zip(before[:2], after[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(after[0], jt.arrays_np()[0])
    t.trim()
    for a, b in zip(flat[:2], t.encode_slots(vals, allow_inline=False)[:2]):
        np.testing.assert_array_equal(a, b)


def test_kmer_table_lookup_matches_jax():
    jt, t, keys, _ = _tables()
    rng = np.random.default_rng(4)
    probe = np.concatenate([rng.choice(keys, 200),
                            rng.integers(0, 2**64, 200, dtype=np.uint64),
                            np.array([keys[0], keys[-1], 0, 2**64 - 1],
                                     np.uint64)])
    assert probe.dtype == np.uint64
    for key in probe:
        want, got = jt.lookup(int(key)), t.lookup(int(key))
        assert (got is None) == (want is None)
        if want is not None:
            assert got == want and got.dtype == want.dtype


@pytest.mark.parametrize("trim", [True, False])
def test_classifier_trims_the_table_after_its_upload(trim):
    from bonsai_tpu_torch.db import formats
    from bonsai_tpu_torch.taxonomy.tree import TaxTree

    _, t, keys, vals = _tables()
    db = formats.Database(table=t, k=31, w=31, gaps=[0] * 30)
    tree = TaxTree({1: 0, **{v: 1 for v in range(2, 9)}})
    clf = Classifier(db, tree, trim_table=trim, device="cpu")
    assert (t._occ is None) == trim
    assert clf.arr.slots.shape[0] == t.nb
    np.testing.assert_array_equal(t.keys_sorted, keys)  # content kept
    assert t.lookup(int(keys[7])) == vals[7]


@pytest.mark.parametrize("k,w,spacing", [(31, 31, None), (21, 40, "0x16,1x4"),
                                         (12, 30, "1x11")])
def test_database_spacer_matches_jax(k, w, spacing):
    from bonsai_tpu.core.spacer import parse_spacing as jparse
    from bonsai_tpu.db import formats as jformats

    from bonsai_tpu_torch.core.spacer import parse_spacing
    from bonsai_tpu_torch.db import formats

    _, t, _, _ = _tables(100)
    want = jformats.Database(table=None, k=k, w=w,
                             gaps=jparse(spacing, k)).spacer
    got = formats.Database(table=t, k=k, w=w,
                           gaps=parse_spacing(spacing, k)).spacer
    assert isinstance(got, Spacer)
    assert (got.k, got.w, got.c, got.window_kmers) == (
        want.k, want.w, want.c, want.window_kmers)
    assert list(got.gaps) == list(want.gaps)
    np.testing.assert_array_equal(np.asarray(got.positions),
                                  np.asarray(want.positions))


@pytest.mark.parametrize("k", [1, 16, 31, 32])
def test_canonicalize_matches_jax(k):
    rng = np.random.default_rng(k)
    kmers = rng.integers(0, 2**64, 1000, dtype=np.uint64)
    if k < 32:
        kmers &= np.uint64((1 << (2 * k)) - 1)
    want = np.asarray(jencode.canonicalize(kmers, k))
    got = encode.canonicalize(torch.from_numpy(kmers.view(np.int64)), k)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def test_native_available_matches_jax():
    from bonsai_tpu import native as jnative

    from bonsai_tpu_torch import native

    assert native.available() is True
    assert native.available() == jnative.available()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_distributed_takes_a_coordinator(tmp_path):
    """init_distributed(coordinator, num_processes, process_id) joins a
    group of one at tcp://coordinator, in a process of its own (a process
    group is global); without them it wants torchrun's environment."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import torch.distributed as d\n"
        "from bonsai_tpu_torch.parallel.mesh import init_distributed\n"
        f"r = init_distributed('localhost:{_free_port()}', 1, 0, "
        "device='cpu')\n"
        "print(r, d.get_world_size(), d.get_backend(), init_distributed())\n"
        "d.destroy_process_group()\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "1", "gloo", "0"]
    code = ("from bonsai_tpu_torch.parallel.mesh import init_distributed\n"
            "for a in ((), ('localhost:1',)):\n"
            "    try:\n"
            "        init_distributed(*a, device='cpu')\n"
            "    except (RuntimeError, ValueError) as e:\n"
            "        print(type(e).__name__, e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("RuntimeError") and "torchrun" in lines[0]
    assert lines[1].startswith("ValueError") and "num_processes" in lines[1]


def test_init_distributed_without_a_card_raises():
    """Without CUDA, init_distributed with a coordinator and no device
    raises rather than joining a gloo group on the CPU, and so do the
    mesh's defaults (in a process of its own: a process group is
    global)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import torch\n"
        "import torch.distributed as d\n"
        "from bonsai_tpu_torch.parallel import mesh\n"
        "torch.cuda.is_available = lambda: False\n"
        "for f in (lambda: mesh.init_distributed("
        f"'localhost:{_free_port()}', 1, 0), mesh._my_device,\n"
        "          lambda: mesh.make_mesh({'db': 2})):\n"
        "    try:\n"
        "        f()\n"
        "    except RuntimeError as e:\n"
        "        print(type(e).__name__, e)\n"
        "print('joined', d.is_initialized())\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 4, out.stdout
    for line in lines[:3]:
        assert line.startswith("RuntimeError") and "'cuda'" in line, line
    assert lines[3] == "joined False"


@pytest.mark.parametrize("local_rank,cards,rank,want", [
    (None, 2, 1, 1), (None, 4, 6, 2), (None, 1, 3, 0), ("1", 4, 5, 1),
    ("0", 2, 1, 0)])
def test_init_distributed_binds_the_process_card(monkeypatch, local_rank,
                                                 cards, rank, want):
    """On CUDA, a coordinator launch binds the process of ``process_id``
    to its card on the host (process_id modulo the host's cards) unless
    torchrun's LOCAL_RANK names one; ``make_mesh``'s default device is
    the same card.  The card calls are stubbed: the choice is host
    logic."""
    import torch.distributed as dist

    from bonsai_tpu_torch.parallel import mesh

    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    bound, joined = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: joined.append((a, kw)))
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    assert mesh.init_distributed("localhost:29500", 8, rank) == rank
    assert bound == [want]
    assert joined == [(("nccl",), dict(init_method="tcp://localhost:29500",
                                       world_size=8, rank=rank))]
    assert mesh._my_device() == torch.device("cuda", want)
