"""Port parity: u64 bit kit, k-mer encoding and 2-bit unpacking.

The same numpy-seeded inputs go through the JAX package (jnp arrays, on
the CPU) and through ``bonsai_tpu_torch`` (torch int64 tensors holding u64
bits).  Tolerance: exact equality, since everything here is integer work.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bonsai_tpu  # noqa: F401  (enables jax x64)
from bonsai_tpu.classify import pipeline as jpl
from bonsai_tpu.core import bitops as jbit
from bonsai_tpu.core import hashes as jhash
from bonsai_tpu.core.encoder import BatchEncoder as JEncoder
from bonsai_tpu.core.spacer import Spacer as JSpacer

from bonsai_tpu_torch.classify.pipeline import unpack_2bit
from bonsai_tpu_torch.core import bitops, hashes
from bonsai_tpu_torch.core.encoder import BatchEncoder
from bonsai_tpu_torch.core.spacer import Spacer

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U64_MAX = (1 << 64) - 1


def t64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def random_u64(rng, n=4096) -> np.ndarray:
    x = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    edge = np.array([0, 1, U64_MAX, U64_MAX - 1, 1 << 63, (1 << 63) - 1,
                     (1 << 63) | 1, 0xAAAAAAAAAAAAAAAA], dtype=np.uint64)
    x[: edge.size] = edge
    x[edge.size : 1024] |= np.uint64(1 << 63)  # many with bit 63 set
    return x


def test_splitmix64_matches_jax():
    x = random_u64(np.random.default_rng(1))
    want = np.asarray(jhash.splitmix64(jnp.asarray(x)))
    np.testing.assert_array_equal(u64(hashes.splitmix64(t64(x))), want)


@pytest.mark.parametrize("k", [21, 25, 31, 32])
def test_reverse_complement_and_canonical_match_jax(k):
    x = random_u64(np.random.default_rng(k))
    xs = [x, x & np.uint64(jbit.kmer_mask_bits(k))]  # raw bits and k-mers
    for a in xs:
        rc = np.asarray(jbit.reverse_complement(jnp.asarray(a), k))
        np.testing.assert_array_equal(u64(bitops.reverse_complement(t64(a), k)), rc)
        can = np.asarray(jbit.canonical(jnp.asarray(a), k))
        np.testing.assert_array_equal(u64(bitops.canonical(t64(a), k)), can)


def test_shr_and_umin_are_unsigned():
    x = random_u64(np.random.default_rng(2))
    y = random_u64(np.random.default_rng(3))
    for s in (0, 1, 30, 31, 62, 63):
        np.testing.assert_array_equal(u64(bitops.shr(t64(x), s)), x >> np.uint64(s))
    np.testing.assert_array_equal(u64(bitops.umin(t64(x), t64(y))), np.minimum(x, y))


def _reads(rng, B, L, k, n_prob=0.02):
    """int8 codes (B, L) padded with -1, with in-read Ns and some reads
    shorter than k."""
    lengths = rng.integers(k, L + 1, size=B).astype(np.int32)
    lengths[rng.choice(B, B // 8, replace=False)] = rng.integers(0, k, B // 8)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < n_prob] = -1
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return codes, lengths


@pytest.mark.parametrize("k", [21, 25, 31, 32])
@pytest.mark.parametrize("canon", [True, False])
def test_unwindowed_emissions_match_jax(k, canon):
    rng = np.random.default_rng(100 + k)
    codes, lengths = _reads(rng, 64, 160, k)
    jem = JEncoder(JSpacer(k, k), canon, "lex").emissions(
        jnp.asarray(codes), jnp.asarray(lengths))
    em = BatchEncoder(Spacer(k, k), canon).emissions(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    np.testing.assert_array_equal(em.mask.numpy(), np.asarray(jem.mask))
    # only emitted values are defined: compare them where the mask is set
    m = np.asarray(jem.mask)
    np.testing.assert_array_equal(u64(em.values)[m], np.asarray(jem.values)[m])
    # and every value, since both encode the same windows
    np.testing.assert_array_equal(u64(em.values), np.asarray(jem.values))


def test_emissions_of_reads_shorter_than_k():
    codes = np.full((3, 16), -1, dtype=np.int8)
    codes[:, :10] = 1
    em = BatchEncoder(Spacer(21, 21)).emissions(
        torch.from_numpy(codes), torch.tensor([10, 0, 16], dtype=torch.int32))
    assert em.values.shape == (3, 0) and em.mask.shape == (3, 0)


def test_other_disciplines_raise():
    BatchEncoder(Spacer(25, 37))  # canonical windowed: ported
    BatchEncoder(Spacer(25, 37), canonicalize=False)  # uncanonical windowed
    BatchEncoder(Spacer(21, 21, "0x16,1x4"))  # spaced
    BatchEncoder(Spacer(25, 37), scheme="entropy-file")  # build -e
    BatchEncoder(Spacer(25, 37), scheme="hash")  # build -t/-f --phase1-db
    BatchEncoder(Spacer(21, 21), scheme="entropy")  # the Python API
    with pytest.raises(NotImplementedError):
        BatchEncoder(Spacer(33, 33))  # 128-bit k-mers


@pytest.mark.parametrize("with_n", [True, False])
def test_unpack_2bit_matches_jax(with_n):
    rng = np.random.default_rng(7)
    codes, lengths = _reads(rng, 32, 128, 21)
    pc, nm = jpl.Classifier.pack_codes(codes, with_nmask=with_n)
    want = np.asarray(jpl.unpack_2bit(jnp.asarray(pc),
                                      None if nm is None else jnp.asarray(nm)))
    got = unpack_2bit(torch.from_numpy(pc.view(np.int32)),
                      None if nm is None else torch.from_numpy(nm.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_package_imports_without_jax():
    """bonsai_tpu_torch never imports jax or bonsai_tpu."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['bonsai_tpu'] = None\n"
        "import pkgutil, importlib, bonsai_tpu_torch\n"
        "for m in pkgutil.walk_packages(bonsai_tpu_torch.__path__, 'bonsai_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [n for n in sys.modules if n.startswith(('jax', 'bonsai_tpu.'))\n"
        "       and sys.modules[n] is not None]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
