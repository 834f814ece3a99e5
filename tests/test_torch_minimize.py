"""Port parity: frev64 / rotl64, sliding minimums and the windowed
canonical lex encoder.

The same numpy-seeded inputs go through the JAX package (jnp arrays on
the CPU) and through ``bonsai_tpu_torch`` (int64 tensors holding u64
bits; on the CPU the encoder takes KB1's plain torch version).
Tolerance: exact equality, since everything here is integer work.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bonsai_tpu  # noqa: F401  (enables jax x64)
from bonsai_tpu.core import hashes as jhash
from bonsai_tpu.core import minimize as jmin
from bonsai_tpu.core.alphabet import InputType
from bonsai_tpu.core.encoder import BatchEncoder as JEncoder
from bonsai_tpu.core.spacer import Spacer as JSpacer

from bonsai_tpu_torch.core import hashes, minimize
from bonsai_tpu_torch.core.encoder import BatchEncoder, minimizers
from bonsai_tpu_torch.core.spacer import Spacer

torch.set_num_threads(1)
U64_MAX = (1 << 64) - 1


def t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def u64(t):
    return t.numpy().view(np.uint64)


def random_u64(rng, n=4096):
    x = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    edge = np.array([0, 1, U64_MAX, U64_MAX - 1, 1 << 63, (1 << 63) - 1,
                     (1 << 63) | 1], dtype=np.uint64)
    x[: edge.size] = edge
    x[edge.size : 1024] |= np.uint64(1 << 63)
    return x


def test_frev64_matches_jax():
    x = random_u64(np.random.default_rng(1))
    np.testing.assert_array_equal(u64(hashes.frev64(t64(x))),
                                  np.asarray(jhash.frev64(jnp.asarray(x))))


@pytest.mark.parametrize("r", [1, 31, 33, 63])
def test_rotl64_matches_jax(r):
    x = random_u64(np.random.default_rng(r))
    np.testing.assert_array_equal(u64(hashes.rotl64(t64(x), r)),
                                  np.asarray(jhash.rotl64(jnp.asarray(x), r)))


def _scores_kmers(rng, B=8, P=200):
    """Scores from a small domain (many ties) with bit 63 set in half of
    them, k-mers over the whole u64 range."""
    s = rng.integers(0, 6, (B, P)).astype(np.uint64)
    s |= rng.integers(0, 2, (B, P)).astype(np.uint64) << np.uint64(63)
    k = rng.integers(0, 2**64, (B, P), dtype=np.uint64)
    k[:, ::7] = U64_MAX
    return s, k


@pytest.mark.parametrize("W", [1, 2, 3, 5, 10, 16, 17])
def test_sliding_min_matches_jax(W):
    s, k = _scores_kmers(np.random.default_rng(W))
    js, jk = jmin.sliding_min(jnp.asarray(s), jnp.asarray(k), W)
    ts, tk = minimize.sliding_min(t64(s), t64(k), W)
    np.testing.assert_array_equal(u64(ts), np.asarray(js))
    np.testing.assert_array_equal(u64(tk), np.asarray(jk))


@pytest.mark.parametrize("W", [1, 4, 9])
def test_positional_minimizers_match_jax(W):
    rng = np.random.default_rng(40 + W)
    s, k = _scores_kmers(rng)
    n_push = rng.integers(0, 201, 8).astype(np.int32)
    jk, jv = jmin.positional_minimizers(jnp.asarray(s), jnp.asarray(k), W,
                                        jnp.asarray(n_push))
    tk, tv = minimize.positional_minimizers(t64(s), t64(k), W,
                                            torch.from_numpy(n_push))
    np.testing.assert_array_equal(u64(tk), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _reads(rng, B, L, k, n_prob=0.02):
    """int8 codes (B, L) padded with -1: in-read Ns, an N run, rows
    shorter than k and rows of T (k = 32 k-mers with every bit set)."""
    lengths = rng.integers(k, L + 1, size=B).astype(np.int32)
    lengths[rng.choice(B, B // 8, replace=False)] = rng.integers(0, k, B // 8)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < n_prob] = -1
    codes[0, 10:80] = -1
    codes[1, :] = 3
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return codes, lengths


def _emissions_equal(k, w, codes, lengths, canon=True):
    jem = JEncoder(JSpacer(k, w), canon, "lex").emissions(
        jnp.asarray(codes), jnp.asarray(lengths))
    em = BatchEncoder(Spacer(k, w), canon).emissions(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    np.testing.assert_array_equal(em.mask.numpy(), np.asarray(jem.mask))
    np.testing.assert_array_equal(u64(em.values), np.asarray(jem.values))
    return em


@pytest.mark.parametrize("k", [21, 31, 32])
@pytest.mark.parametrize("dw", [0, 9, 31])
def test_windowed_canonical_emissions_match_jax(k, dw):
    rng = np.random.default_rng(k * 10 + dw)
    codes, lengths = _reads(rng, 48, 220, k)
    em = _emissions_equal(k, k + dw, codes, lengths)
    assert em.mask.any()
    if dw:  # an N window pushes key 0, a real key that can win a window
        assert (em.values[em.mask] == 0).any()


def test_windowed_emissions_without_a_full_window_match_jax():
    rng = np.random.default_rng(5)
    codes, lengths = _reads(rng, 8, 50, 25)
    em = _emissions_equal(25, 60, codes, lengths)  # P = 26 < W = 36
    assert em.values.shape == (8, 0)
    em = _emissions_equal(25, 50, codes, lengths)  # P = W: one slot
    assert em.values.shape == (8, 1)
    _emissions_equal(31, 40, codes[:, :20].copy(), lengths)  # L < k


def test_minimizers_at_w1_are_the_unwindowed_emissions():
    rng = np.random.default_rng(9)
    codes, lengths = _reads(rng, 16, 100, 32)
    for canon in (True, False):
        em = minimizers(torch.from_numpy(codes), torch.from_numpy(lengths), 32,
                        1, canon)
        jem = JEncoder(JSpacer(32, 32), canon, "lex").emissions(
            jnp.asarray(codes), jnp.asarray(lengths))
        np.testing.assert_array_equal(em.mask.numpy(), np.asarray(jem.mask))
        np.testing.assert_array_equal(u64(em.values), np.asarray(jem.values))
    assert (u64(em.values)[em.mask.numpy()] == U64_MAX).any()  # row of T


@pytest.mark.parametrize("make", [lambda: BatchEncoder(Spacer(33, 33))],
                         ids=["k33"])
def test_unported_disciplines_raise(make):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make()


def _rows(rng, B, L, alphabet):
    """(B, L) codes of random characters of ``alphabet`` (bytes), with
    lengths from L // 2 to L."""
    seqs = rng.choice(np.frombuffer(alphabet, np.uint8), (B, L))
    return seqs, rng.integers(L // 2, L + 1, B).astype(np.int32)


@pytest.mark.parametrize("k,w,spacing,canon,scheme,it", [
    (21, 0, "0x16,1x4", False, "entropy", InputType.DNA),
    (25, 37, "", True, "entropy", InputType.DNA),
    (25, 37, "", False, "entropy", InputType.DNA),
    (7, 7, "", True, "lex", InputType.PROTEIN),
    (7, 7, "1x6", False, "lex", InputType.PROTEIN),
], ids=["spaced-entropy", "entropy", "uncanonical-windowed-entropy",
        "protein", "spaced-protein"])
def test_entropy_and_protein_disciplines_match_jax(k, w, spacing, canon,
                                                   scheme, it):
    """The disciplines that raised before the scheme entropy and the other
    input types were ported: the same emissions as the JAX package."""
    from bonsai_tpu.core.alphabet import alphabet_of

    rng = np.random.default_rng(k + w)
    seqs, lengths = _rows(rng, 6, 160, b"ACGTNacdefghiklmnpqrstvwy*X")
    codes = alphabet_of(it).lut[seqs]
    for b, n in enumerate(lengths):
        codes[b, n:] = -1
    jsp = JSpacer(k, w, spacing)
    jem = JEncoder(jsp, canon, scheme, it).emissions(codes, lengths)
    em = BatchEncoder(Spacer(k, w, spacing), canon, scheme, it).emissions(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    mask = np.asarray(jem.mask)
    np.testing.assert_array_equal(em.mask.numpy(), mask)
    np.testing.assert_array_equal(u64(em.values)[mask],
                                  np.asarray(jem.values)[mask])
