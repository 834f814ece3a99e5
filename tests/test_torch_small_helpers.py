"""Port parity: the JAX package's small helpers that the port had no name
for, on inputs made from a numpy seed, against the JAX functions:
``TDdepth``, ``TDtax``, ``FMcount`` and ``FMtax`` (``db/build.py``),
``BatchEncoder.emitted_set`` (``core/encoder.py``), ``codes_from_bytes``
and ``overflow_to_canonical_zero`` (``core/encode.py``), ``format_read``
(``classify/output.py``) and the static ``pack_codes`` of ``Classifier``
and ``ShardedClassifier``.  Tolerance: exact equality (integer work and
text)."""

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
