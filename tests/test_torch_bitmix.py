"""KS4's functions in the port against the JAX package, on the CPU: the
plain torch versions of ``wang_hash``, ``khash_int64_hash``,
``popcount64`` and ``nuccount`` (``bonsai_tpu_torch/core/hashes.py``,
``core/bitops.py``) against ``bonsai_tpu.core.hashes`` / ``bitops`` on
numpy, and ``bonsai_tpu_torch.util`` against ``bonsai_tpu.util``.  Inputs
are random u64 values from a numpy seed with 0, U64_MAX, bit 63 alone and
values with bit 63 set among them.  Tolerance: exact equality (integer
work; ``kmer_entropy`` evaluates the JAX package's numpy expression).
"""

import numpy as np
import pytest
import torch

from bonsai_tpu.core import bitops as jbitops
from bonsai_tpu.core import hashes as jhashes
from bonsai_tpu import util as jutil
from bonsai_tpu_torch import util
from bonsai_tpu_torch.core import bitops, hashes

SEED = 20261017


def _values(n=20000):
    rng = np.random.default_rng(SEED)
    v = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    v[:4] = [0, 2**64 - 1, 2**63, 2**63 - 1]
    return v


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _u64(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("name,jax_fn", [
    ("wang_hash", jhashes.wang_hash),
    ("khash_int64_hash", jhashes.khash_int64_hash),
    ("popcount64", jbitops.popcount64),
])
def test_bitmix_matches_jax(name, jax_fn):
    v = _values()
    fn = getattr(hashes, name, None) or getattr(bitops, name)
    got = fn(_t(v))
    assert got.dtype == torch.int64 and got.shape == (v.size,)
    np.testing.assert_array_equal(_u64(got), jax_fn(v))


def test_bitmix_keeps_the_shape():
    v = _values(600).reshape(20, 30)
    np.testing.assert_array_equal(_u64(hashes.wang_hash(_t(v))),
                                  jhashes.wang_hash(v))
    assert hashes.khash_int64_hash(_t(v[:0])).shape == (0, 30)


@pytest.mark.parametrize("k", [1, 5, 31, 32])
def test_nuccount_matches_jax(k):
    v = _values() & np.uint64(jbitops.kmer_mask_bits(k))
    got = bitops.nuccount(_t(v), k)
    assert got.dtype == torch.int64 and got.shape == (v.size, 4)
    np.testing.assert_array_equal(got.numpy(),
                                  jbitops.nuccount(v, k).astype(np.int64))
    np.testing.assert_array_equal(util.nuccount(_t(v), k).numpy(),
                                  jutil.nuccount(v, k))
    # the counts of a k-mer sum to k, in code order A, C, G, T
    assert (got.sum(-1) == k).all()


def test_nuccount_of_poly_runs():
    for code, base in enumerate("ACGT"):
        kmer = sum(code << (2 * i) for i in range(31))
        got = bitops.nuccount(torch.tensor([kmer]), 31)[0].tolist()
        assert got == [31 if c == code else 0 for c in range(4)], base


@pytest.mark.parametrize("k", [1, 31, 32])
def test_gccount_and_entropy_match_jax(k):
    v = _values() & np.uint64(jbitops.kmer_mask_bits(k))
    np.testing.assert_array_equal(util.gccount(_t(v), k).numpy(),
                                  jutil.gccount(v, k))
    got = util.kmer_entropy(_t(v), k)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), jutil.kmer_entropy(v, k))


def test_wrappers_refuse_other_devices():
    x = torch.zeros(4, dtype=torch.int64, device="meta")
    for fn in (hashes.wang_hash, hashes.khash_int64_hash, bitops.popcount64):
        with pytest.raises(ValueError, match="no kernel"):
            fn(x)
    with pytest.raises(ValueError, match="no kernel"):
        bitops.nuccount(x, 31)
    with pytest.raises(ValueError, match="k=33"):
        bitops.nuccount(torch.zeros(4, dtype=torch.int64), 33)
