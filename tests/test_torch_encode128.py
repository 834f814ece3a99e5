"""Port parity: 128-bit k-mers (``core/encode128.py``, queue A item 8.6).

The same numpy-seeded codes and pairs go through the JAX package's numpy
path (``bonsai_tpu.core.encode128``) and through the port's plain torch
versions of K128 (the wrappers take them for CPU tensors), at k = 33,
40, 55 and 64 (where the JAX formula shifts by 64), with Ns, codes past
3, pairs with bit 63 set in either lane and a pure-Python oracle of the
2k-bit k-mer.  Tolerance: exact equality (integer work).
"""

import numpy as np
import pytest
import torch

from bonsai_tpu.core import encode128 as j128

from bonsai_tpu_torch.core import encode128 as e
from bonsai_tpu_torch.core.bitops import i64

KS = (33, 40, 55, 64)
COMP = {0: 3, 1: 2, 2: 1, 3: 0}


def u64(t):
    return t.numpy().view(np.uint64)


def _codes(rng, shape, n_prob=0.04):
    codes = rng.integers(0, 4, shape).astype(np.int8)
    codes[rng.random(shape) < n_prob] = -1
    return codes


def _oracle(codes, k):
    out = []
    for i in range(len(codes) - k + 1):
        win = codes[i:i + k]
        v = 0
        for c in win:
            v = (v << 2) | int(c)
        out.append(None if (win < 0).any() else v)
    return out


def _rc(v, k):
    r = 0
    for _ in range(k):
        r = (r << 2) | COMP[v & 3]
        v >>= 2
    return r


@pytest.mark.parametrize("k", KS)
def test_pack_rc_and_canonical_match_jax(k):
    rng = np.random.default_rng(k)
    codes = _codes(rng, (3, 300))
    codes[1, :] = -1  # an all-N row
    hi, lo, inv = e.pack_kmers128(torch.from_numpy(codes), k)
    jhi, jlo, jinv = j128.pack_kmers128(codes, k)
    np.testing.assert_array_equal(u64(hi), jhi)
    np.testing.assert_array_equal(u64(lo), jlo)
    np.testing.assert_array_equal(inv.numpy(), jinv)
    for got, want in ((e.reverse_complement128(hi, lo, k),
                       j128.reverse_complement128(jhi, jlo, k)),
                      (e.canonical128(hi, lo, k),
                       j128.canonical128(jhi, jlo, k))):
        np.testing.assert_array_equal(u64(got[0]), want[0])
        np.testing.assert_array_equal(u64(got[1]), want[1])
    chi, clo, cinv = e.pack_kmers128(torch.from_numpy(codes), k, canon=True)
    want = j128.canonical128(jhi, jlo, k)
    np.testing.assert_array_equal(u64(chi), want[0])
    np.testing.assert_array_equal(u64(clo), want[1])
    np.testing.assert_array_equal(cinv.numpy(), jinv)


@pytest.mark.parametrize("k", KS)
def test_pack_matches_the_oracle_and_rc_is_an_involution(k):
    rng = np.random.default_rng(k + 100)
    codes = _codes(rng, (150,))
    hi, lo, inv = e.pack_kmers128(torch.from_numpy(codes), k)
    chi, clo = e.canonical128(hi, lo, k)
    for i, want in enumerate(_oracle(codes, k)):
        assert bool(inv[i]) == (want is None)
        if want is None:
            continue
        assert e.to_python_int(hi[i], lo[i]) == want
        assert e.to_python_int(chi[i], clo[i]) == min(want, _rc(want, k))
    rhi, rlo = e.reverse_complement128(hi, lo, k)
    back = e.reverse_complement128(rhi, rlo, k)
    assert torch.equal(back[0], hi) and torch.equal(back[1], lo)


@pytest.mark.parametrize("k", KS)
def test_given_pairs_with_bit_63_match_jax(k):
    """rc and canonical of arbitrary pairs: bits in hi past its 2(k - 32)
    (which rc ignores and canonical compares), bit 63 in either lane."""
    rng = np.random.default_rng(k + 200)
    hi = rng.integers(0, 2**64, 4000, dtype=np.uint64)
    lo = rng.integers(0, 2**64, 4000, dtype=np.uint64)
    hi[:4] = [2**63, 0, 2**64 - 1, 2**63 - 1]
    lo[:4] = [0, 2**63, 2**64 - 1, 1]
    th, tl = (torch.from_numpy(a.view(np.int64)) for a in (hi, lo))
    for got, want in ((e.reverse_complement128(th, tl, k),
                       j128.reverse_complement128(hi, lo, k)),
                      (e.canonical128(th, tl, k),
                       j128.canonical128(hi, lo, k))):
        np.testing.assert_array_equal(u64(got[0]), want[0])
        np.testing.assert_array_equal(u64(got[1]), want[1])


@pytest.mark.parametrize("k", (33, 64))
def test_codes_past_three_pack_as_jax(k):
    """Codes past 3 are or-ed into their neighbours' bits as the JAX
    package or-s them (no DNA input has them; the kernel packs such a
    window again from its codes)."""
    rng = np.random.default_rng(k + 300)
    codes = rng.integers(-3, 128, (2, 200)).astype(np.int8)
    got = e.pack_kmers128(torch.from_numpy(codes), k, canon=False)
    want = j128.pack_kmers128(codes, k)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(u64(g), w)
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_shapes_p1_and_refusals():
    """(..., L) inputs, P = 1, and the JAX package's ValueErrors."""
    rng = np.random.default_rng(5)
    codes = _codes(rng, (2, 3, 64), n_prob=0.0)
    hi, lo, inv = e.pack_kmers128(torch.from_numpy(codes), 64)
    jhi, jlo, _ = j128.pack_kmers128(codes, 64)
    assert hi.shape == (2, 3, 1)
    np.testing.assert_array_equal(u64(hi), jhi)
    np.testing.assert_array_equal(u64(lo), jlo)
    assert not inv.any()
    for k in (32, 65):
        with pytest.raises(ValueError, match="32 < k <= 64"):
            e.pack_kmers128(torch.from_numpy(codes), k)
        with pytest.raises(ValueError, match="32 < k <= 64"):
            e.canonical128(hi, lo, k)
    with pytest.raises(ValueError, match="k=40 > length 39"):
        e.pack_kmers128(torch.zeros((1, 39), dtype=torch.int8), 40)
    v = 2**127 + 5
    assert e.to_python_int(i64(v >> 64), i64(v)) == v
    assert e.to_python_int(torch.tensor(-1), torch.tensor(-2)) == \
        j128.to_python_int(np.uint64(2**64 - 1), np.uint64(2**64 - 2))
