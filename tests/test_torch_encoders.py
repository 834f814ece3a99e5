"""Port parity: the DNA seed disciplines of ``BatchEncoder.emissions``.

Every row of the discipline table of ``bonsai_tpu_torch/core/encoder.py``
against the JAX package's ``BatchEncoder.emissions`` on the same
numpy-seeded codes: contiguous unwindowed, canonical windowed (lex and
entropy-file), uncanonical windowed (the compacted discipline, lex and
entropy-file) and spaced (lex and entropy-file), at k of 5, 21, 31 and
32 and windows of 1, 2, 13 and 16 seeds, contiguous and with spacings
``0x16,1x4`` and an irregular one; rows with Ns, N runs longer than the
span, rows shorter than the span, all-N rows and rows with fewer than W
valid seeds.  The JAX package runs on numpy inputs, as its own encoder
tests run it, and on jnp arrays on the CPU for one window; the port runs
the plain torch versions of KB1 and KB4.  The masks must be equal and
the values under them; the port's values elsewhere are its kernels'
contract, not the JAX package's.  Then the entropy-file score and its
x86 double -> u64 conversion at their edges, and the compaction's
U64_MAX sentinel, which must order last though it is held as int64 -1.
Tolerance: exact equality, since all of it is integer work and one
IEEE-rounded double divide.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bonsai_tpu  # noqa: F401  (enables jax x64)
from bonsai_tpu.core import entropy as jent
from bonsai_tpu.core import minimize as jmin
from bonsai_tpu.core.encoder import BatchEncoder as JEncoder
from bonsai_tpu.core.spacer import Spacer as JSpacer

from bonsai_tpu_torch.core import entropy, minimize
from bonsai_tpu_torch.core.encoder import BatchEncoder
from bonsai_tpu_torch.core.spacer import Spacer

torch.set_num_threads(1)
U64_MAX = 2**64 - 1

# discipline -> (canonicalize, scheme, spaced)
DISCIPLINES = {
    "canonical-lex": (True, "lex", False),
    "canonical-entropy-file": (True, "entropy-file", False),
    "uncanonical-lex": (False, "lex", False),
    "uncanonical-entropy-file": (False, "entropy-file", False),
    "spaced-lex": (True, "lex", True),
    "spaced-entropy-file": (False, "entropy-file", True),
}


def irregular(k):
    """k - 1 gaps that differ from one step to the next."""
    return [(3 * i) % 4 if i % 3 else 0 for i in range(k - 1)]


def u64(t):
    return t.numpy().view(np.uint64)


def t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def rows(rng, c, W, B=24, L=160):
    """int8 codes (B, L), -1 for N and padding, and lengths: 2% Ns, an N
    run longer than the span, a row of T (k = 32: U64_MAX), a row of G/T
    (bit 63 set), an all-N row, rows shorter than the span, rows with
    0 < n_valid < W."""
    L = max(L, c + W + 8)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.02] = -1
    lengths = rng.integers(c, L + 1, B).astype(np.int32)
    codes[0, 20 : 20 + c + 10] = -1
    codes[1] = 3
    lengths[1] = L
    codes[2] = rng.integers(2, 4, L)
    codes[3] = -1
    lengths[4:7] = rng.integers(0, c, 3)
    lengths[7:10] = c - 1 + rng.integers(1, W + 1, 3)  # n_valid <= W
    codes[7] = rng.integers(0, 4, L)  # one clean seed: n_valid = 1
    lengths[7] = c
    codes[10, :] = rng.integers(0, 4, L)
    codes[10, c + W // 2 :] = -1  # a clean row whose valid seeds end early
    lengths[10] = L
    codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return codes, lengths


def emissions_equal(sp_args, canon, scheme, codes, lengths, as_jnp=False):
    k, w, gaps = sp_args
    jcodes, jlen = ((jnp.asarray(codes), jnp.asarray(lengths)) if as_jnp
                    else (codes, lengths))
    jem = JEncoder(JSpacer(k, w, gaps), canon, scheme).emissions(jcodes, jlen)
    em = BatchEncoder(Spacer(k, w, gaps), canon, scheme).emissions(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    jm, jv = np.asarray(jem.mask), np.asarray(jem.values)
    m = em.mask.numpy()
    assert m.shape == jm.shape
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(u64(em.values)[m], jv[jm])
    return em


def _case(discipline, k, W, spacing):
    canon, scheme, spaced = DISCIPLINES[discipline]
    gaps = None
    if spaced:
        gaps = spacing if spacing is not None else irregular(k)
    c = JSpacer(k, k, gaps).c
    return (k, c + W - 1, gaps), canon, scheme, c


@pytest.mark.parametrize("W", [1, 2, 13, 16])
@pytest.mark.parametrize("k", [5, 21, 31, 32])
@pytest.mark.parametrize("discipline", sorted(DISCIPLINES))
def test_emissions_match_jax(discipline, k, W):
    sp_args, canon, scheme, c = _case(discipline, k, W, None)
    rng = np.random.default_rng(k * 100 + W)
    codes, lengths = rows(rng, c, W)
    em = emissions_equal(sp_args, canon, scheme, codes, lengths)
    assert em.mask.any()
    if discipline.startswith("uncanonical") and W > 1:
        assert em.mask[:, 0].any()  # a trailing partial window fired


@pytest.mark.parametrize("W", [1, 2, 13, 16])
@pytest.mark.parametrize("discipline", ["spaced-lex", "spaced-entropy-file"])
def test_golden_spacing_emissions_match_jax(discipline, W):
    """The spaced_k21 golden's spacing, 0x16,1x4: span 25."""
    from bonsai_tpu_torch.core.spacer import parse_spacing

    sp_args, canon, scheme, c = _case(discipline, 21, W,
                                      parse_spacing("0x16,1x4", 21))
    assert c == 25
    codes, lengths = rows(np.random.default_rng(W), c, W)
    assert emissions_equal(sp_args, canon, scheme, codes, lengths).mask.any()


@pytest.mark.parametrize("discipline", sorted(DISCIPLINES))
def test_emissions_match_jax_on_jnp_arrays(discipline):
    sp_args, canon, scheme, c = _case(discipline, 21, 13, None)
    codes, lengths = rows(np.random.default_rng(13), c, 13)
    emissions_equal(sp_args, canon, scheme, codes, lengths, as_jnp=True)


@pytest.mark.parametrize("discipline", sorted(DISCIPLINES))
def test_emissions_of_rows_shorter_than_the_span(discipline):
    """L < c: no column at all; P < W: the compacted discipline keeps its
    tail column."""
    sp_args, canon, scheme, c = _case(discipline, 21, 16, None)
    rng = np.random.default_rng(3)
    for L in (c - 1, c + 3):
        codes = rng.integers(0, 4, (4, L)).astype(np.int8)
        lengths = np.array([L, L - 1, 0, c], dtype=np.int32)
        codes[np.arange(L)[None, :] >= lengths[:, None]] = -1
        em = emissions_equal(sp_args, canon, scheme, codes, lengths)
        if L < c:
            assert em.values.shape == (4, 0)


def test_spaced_seeds_never_canonicalize():
    assert not BatchEncoder(Spacer(21, 21, "0x16,1x4"), True).canon
    assert BatchEncoder(Spacer(21, 40), True).canon


# -- the entropy-file score ----------------------------------------------------

EDGE_KMERS = np.array([0, 1, 2**53 - 1, 2**53, 2**53 + 1, 2**53 + 3,
                       2**62, 2**63 - 1, 2**63, 2**63 + 1,
                       int(0.9999 * 2**63), int(0.9999 * 2**63) + 4096,
                       2**64 - 2049, 2**64 - 1025, U64_MAX - 1, U64_MAX],
                      dtype=np.uint64)


def test_u64_to_f64_rounds_as_numpy():
    rng = np.random.default_rng(1)
    x = np.concatenate([EDGE_KMERS, rng.integers(0, 2**64, 4096,
                                                 dtype=np.uint64)])
    got = entropy.u64_to_f64(t64(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64),
                                  x.astype(np.float64).view(np.uint64))


def test_f64_to_u64_x86_matches_jax():
    two63, two64 = 2.0**63, 2.0**64
    x = np.array([0.0, -0.0, 0.5, -0.5, 1.5, -1.5, 2.0**53 + 2, -(2.0**53),
                  two63 - 1024, two63, two63 + 2048, two64 - 2048, two64,
                  -two63, -two63 - 2048, -two64, 1e300, -1e300, np.inf,
                  -np.inf, np.nan], dtype=np.float64)
    got = entropy.f64_to_u64_x86(torch.from_numpy(x))
    np.testing.assert_array_equal(u64(got),
                                  np.asarray(jent.f64_to_u64_x86(x)))


def test_entropy_scores_match_jax():
    """The file score kmer / (-1 + 1e-4): bit-63 k-mers and U64_MAX give
    out-of-range quotients, 0x8000000000000000."""
    rng = np.random.default_rng(2)
    x = np.concatenate([EDGE_KMERS, rng.integers(0, 2**64, 4096,
                                                 dtype=np.uint64)])
    got = u64(entropy.file_scores(t64(x)))
    np.testing.assert_array_equal(got, np.asarray(
        jent.entropy_scores(x, -1.0, 1e-4)))
    assert got[-1] == entropy.INT64_MIN_U and got[0] == 0


# -- the compaction's sentinel --------------------------------------------------

def test_compacted_minimizers_match_jax_with_real_u64_max():
    """Scores and k-mers with bit 63 set and real U64_MAX pairs, which tie
    the sentinel: the port's int64 -1 must order last, as JAX's U64_MAX."""
    rng = np.random.default_rng(4)
    B, P = 16, 90
    s = rng.integers(0, 6, (B, P)).astype(np.uint64)
    s |= rng.integers(0, 2, (B, P)).astype(np.uint64) << np.uint64(63)
    s[:, ::5] = U64_MAX
    k = rng.integers(0, 2**64, (B, P), dtype=np.uint64)
    k[:, ::5] = U64_MAX
    valid = rng.random((B, P)) < 0.6
    valid[0] = False
    valid[1, 3:] = False
    cs, ck = minimize.compact_valid(t64(s), t64(k), torch.from_numpy(valid))
    js, jk = jmin.compact_valid(s, k, valid)
    np.testing.assert_array_equal(u64(cs), js)
    np.testing.assert_array_equal(u64(ck), jk)
    for W in (1, 4, 13):
        got = minimize.compacted_minimizers(t64(s), t64(k),
                                            torch.from_numpy(valid), W)
        want = jmin.compacted_minimizers(s, k, valid, W)
        for g, w in zip(got, want):
            g = u64(g) if g.dtype == torch.int64 else g.numpy()
            np.testing.assert_array_equal(g, np.asarray(w))
