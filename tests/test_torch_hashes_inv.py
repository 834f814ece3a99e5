"""Port parity: the inverse hashes, the rotates and the string hashes of
``bonsai_tpu_torch/core/hashes.py`` on the CPU (the plain torch versions
of KS4's ``frev64_inv``, ``wang_hash_inv`` and ``rotl`` modes) against
``bonsai_tpu/core/hashes.py`` on numpy uint64: 4096 seeded values plus 0,
1, 2^63 and U64_MAX, r in {0, 1, 31, 32, 63, 64}; the round trips
through ``frev64`` and ``wang_hash``; ``rrot`` of any r; ``lrot`` out of
0..64 raising in both packages; ``dbm_hash`` and ``x31_hash`` on bytes
with the empty string and bytes past 0x7F.  Tolerance: equal bits.
"""

import numpy as np
import pytest
import torch

from bonsai_tpu.core import hashes as jh

from bonsai_tpu_torch.core import hashes as th

R = [0, 1, 31, 32, 63, 64]


def _values():
    rng = np.random.default_rng(20261017)
    return np.concatenate([rng.integers(0, 2**64, 4096, dtype=np.uint64),
                           np.array([0, 1, 2**63, 2**64 - 1], np.uint64)])


def _t(x):
    return torch.from_numpy(x.view(np.int64))


def _np(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("name", ["frev64_inv", "wang_hash_inv"])
def test_inverse_mix_matches_jax(name):
    x = _values()
    np.testing.assert_array_equal(_np(getattr(th, name)(_t(x))),
                                  getattr(jh, name)(x))


@pytest.mark.parametrize("fwd,inv", [("frev64", "frev64_inv"),
                                     ("wang_hash", "wang_hash_inv")])
def test_round_trips(fwd, inv):
    x = _values()
    t = _t(x)
    np.testing.assert_array_equal(_np(getattr(th, inv)(getattr(th, fwd)(t))),
                                  x)
    np.testing.assert_array_equal(_np(getattr(th, fwd)(getattr(th, inv)(t))),
                                  x)


@pytest.mark.parametrize("r", R)
@pytest.mark.parametrize("name", ["lrot", "rrot"])
def test_rotates_match_jax(name, r):
    x = _values()
    np.testing.assert_array_equal(_np(getattr(th, name)(_t(x), r)),
                                  getattr(jh, name)(x, r))


def test_rotate_edges():
    x = _values()
    t = _t(x)
    for got in (th.lrot(t, 0), th.lrot(t, 64), th.rrot(t, 0)):
        np.testing.assert_array_equal(_np(got), x)
    np.testing.assert_array_equal(_np(th.rrot(t, 65)), _np(th.rrot(t, 1)))
    np.testing.assert_array_equal(_np(th.rrot(t, 65)), jh.rrot(x, 65))
    np.testing.assert_array_equal(_np(th.rrot(t, -3)), jh.rrot(x, -3))
    np.testing.assert_array_equal(_np(th.lrot(th.rrot(t, 17), 17)), x)
    for r in (65, -1):
        with pytest.raises(OverflowError):
            jh.lrot(x, r)
        with pytest.raises(ValueError):
            th.lrot(t, r)
    with pytest.raises(ValueError):
        th.rotl(t, 64)


@pytest.mark.parametrize("s", [b"", b"a", b"ACGT" * 50, bytes(range(256)),
                               b"\x80\xff\xfe", "NC_000913.3".encode()])
def test_string_hashes_match_jax(s):
    assert th.dbm_hash(s) == jh.dbm_hash(s)
    assert th.x31_hash(s) == jh.x31_hash(s)
