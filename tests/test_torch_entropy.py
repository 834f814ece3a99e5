"""Port parity: the scheme ``entropy`` (windowed Shannon entropy).

The same numpy-seeded inputs go through the JAX package's numpy path
(``bonsai_tpu/core/entropy.py``, ``BatchEncoder`` on numpy codes, as its
Python API runs it) and through ``bonsai_tpu_torch`` (int64 tensors
holding u64 bits; on the CPU the encoder takes KB1's and KB4's plain
torch versions).  Tolerance: exact equality, bit for bit: the counts are
integers, and H is the same float64 terms added in numpy's order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import bonsai_tpu  # noqa: F401  (enables jax x64)
from bonsai_tpu.core import entropy as jent
from bonsai_tpu.core.encoder import BatchEncoder as JEncoder
from bonsai_tpu.core.spacer import Spacer as JSpacer

from bonsai_tpu_torch.core import entropy
from bonsai_tpu_torch.core.encoder import BatchEncoder
from bonsai_tpu_torch.core.spacer import Spacer

from conftest import random_dna
from test_encode import batch_from_seqs

RADIXES = (2, 4, 6, 8, 14, 20, 256)


def u64(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("R", RADIXES)
@settings(max_examples=8, deadline=None, derandomize=True, database=None)
@given(data=st.data())
def test_counts_terms_and_h_match_numpy(R, data):
    """window_code_counts, spaced_code_counts and entropy_value at every
    radix of an input type, codes -1 among them.  R = 256 on one short
    row, the API's shape: the JAX package takes 256 cumulative sums, and
    numpy 2.0.2 crashes comparing a strided int8 view of several rows
    with a code past 127."""
    k = data.draw(st.integers(1, 8 if R == 256 else 32), label="k")
    L = data.draw(st.integers(k, k + (40 if R == 256 else 300)), label="L")
    seed = data.draw(st.integers(0, 2**32 - 1), label="seed")
    rng = np.random.default_rng(seed)
    codes = rng.integers(-1, R, (1 if R == 256 else 2, L))
    # BYTES: codes past 127 are negative int8, ambiguous
    codes = codes.astype(np.uint8 if R == 256 else np.int8).view(np.int8)
    ct = torch.from_numpy(codes)
    got = entropy.window_code_counts(ct, k, R)
    want = jent.window_code_counts(codes, k, R)
    np.testing.assert_array_equal(got.numpy(), want)
    h = entropy.entropy_value(got, k)
    np.testing.assert_array_equal(h.numpy(), jent.entropy_value(want, k))
    gaps = rng.integers(0, 3, k - 1)
    pos = np.concatenate([[0], np.cumsum(gaps + 1)]).astype(np.int32)
    if pos[-1] < L:
        got = entropy.spaced_code_counts(ct, pos, R)
        want = jent.spaced_code_counts(codes, pos, R)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(entropy.entropy_value(got, k).numpy(),
                                      jent.entropy_value(want, k))


@pytest.mark.parametrize("k", [1, 2, 7, 13, 21, 31, 32])
def test_shannon_terms_are_entropy_value_of_one_code(k):
    """Term c is entropy_value of counts holding c for one code and 0
    for the others: the table has entropy_value's bits."""
    terms = entropy.shannon_terms(k)
    assert terms[0] == 0.0 and terms[k] == 0.0
    counts = np.zeros((k + 1, 4), np.int32)
    counts[:, 2] = np.arange(k + 1)
    np.testing.assert_array_equal(terms, jent.entropy_value(counts, k))


@pytest.mark.parametrize("n", [1, 3, 7, 8, 9, 15, 16, 20, 127, 128, 129,
                               200, 256, 300])
def test_numpy_sum_is_numpy_order(n):
    rng = np.random.default_rng(n)
    a = -rng.random((500, n)) * rng.integers(0, 2, (500, n))
    got = entropy.numpy_sum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(0.0 + got, a.sum(axis=-1))


M1 = np.uint64(0x5555555555555555)
# (k, spacing): contiguous and spaced DNA seeds, the spacings of
# tests/test_torch_kernels.py SPACINGS among them
COUNT_SEEDS = [(1, None), (5, None), (5, "0,3,9,1"), (21, "0x16,1x4"),
               (31, None), (31, "0,2,0,1,3,0x10,5,0x14"), (32, None),
               (32, "1x31")]


def _popcount(x):
    x = x - ((x >> np.uint64(1)) & M1)
    x = (x & np.uint64(0x3333333333333333)) + (
        (x >> np.uint64(2)) & np.uint64(0x3333333333333333))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(
        np.int32)


def _kmer_counts(kmers, k):
    """The counts of codes 0..3 in each packed DNA k-mer (u64, k 2-bit
    groups, first base high) from four popcounts of its bit planes, as
    the kernels count them (csrc/scores.cuh shannon_dna_score)."""
    lo = kmers & M1
    hi = (kmers >> np.uint64(1)) & M1
    c1, c2, c3 = (_popcount(lo & ~hi), _popcount(hi & ~lo),
                  _popcount(lo & hi))
    return np.stack([k - c1 - c2 - c3, c1, c2, c3], axis=-1)


@pytest.mark.parametrize("k,spacing", COUNT_SEEDS,
                         ids=lambda m: str(m).replace(" ", ""))
def test_kmer_popcounts_are_the_code_counts(k, spacing):
    """The kernels' Shannon score of a DNA seed counts its codes from the
    packed uncanonical k-mer: four popcounts equal JAX's
    window_code_counts / spaced_code_counts on every valid seed, and the
    present codes' terms added in ascending code order give
    entropy_value's H and entropy_scores' scores, bit for bit.  Random
    rows with Ns, rows of one code, ACGT repeated, and complement-heavy
    rows."""
    from bonsai_tpu_torch.core import encode

    rng = np.random.default_rng(k * 7 + len(spacing or ""))
    L = 200
    codes = rng.integers(0, 4, (12, L)).astype(np.int8)
    codes[:4][rng.random((4, L)) < 0.03] = -1
    for c in range(4):
        codes[4 + c] = c
    codes[8] = np.tile(np.arange(4), L // 4)
    codes[9] = rng.choice([0, 3], L)
    codes[10] = rng.choice([1, 2], L)
    codes[11] = np.where(rng.random(L) < 0.95, 0, 3)
    sp = Spacer(k, k, spacing)
    ct = torch.from_numpy(codes)
    if spacing is None:
        kmers, invalid = encode.pack_kmers(ct, k)
        want = jent.window_code_counts(codes, k, 4)
    else:
        kmers, invalid = encode.pack_spaced_kmers(ct, sp.offsets)
        want = jent.spaced_code_counts(codes, sp.positions, 4)
    valid = ~invalid.numpy()
    kmers = u64(kmers)
    got = _kmer_counts(kmers, k)
    np.testing.assert_array_equal(got[valid], want[valid])
    terms = entropy.shannon_terms(k)
    h = np.zeros(kmers.shape)
    for c in range(4):  # ascending code order, absent codes skipped
        h = np.where(got[..., c] > 0, h + terms[got[..., c]], h)
    jh = jent.entropy_value(want, k)
    np.testing.assert_array_equal(h[valid], jh[valid])
    for eps in (entropy.WINDOWED_EPS, entropy.FILE_EPS):
        np.testing.assert_array_equal(
            jent.entropy_scores(kmers, h, eps)[valid],
            jent.entropy_scores(kmers, jh, eps)[valid])


# the modes of tests/test_encode.py:130-131,155, and the k = 31 w = 40
# and -S 0x16,1x4 w = 40 disciplines
MODES = [
    (13, 29, "", True),
    (13, 29, "", False),
    (9, 30, "2x8", False),
    (31, 40, "", True),
    (31, 40, "", False),
    (21, 40, "0x16,1x4", False),
]


@pytest.mark.parametrize("k,w,spacing,canon", MODES,
                         ids=lambda m: str(m).replace(" ", ""))
@pytest.mark.parametrize("n_prob", [0.0, 0.05])
def test_encoder_entropy_matches_jax(k, w, spacing, canon, n_prob):
    rng = np.random.default_rng(k * 100 + w)
    seqs = [random_dna(rng, int(rng.integers(max(w, 20), 400)), n_prob)
            for _ in range(8)]
    seqs.append(b"A" * 300)  # H = 0: the largest quotients
    codes, lengths = batch_from_seqs(seqs)
    jem = JEncoder(JSpacer(k, w, spacing), canon, "entropy").emissions(
        codes, lengths)
    em = BatchEncoder(Spacer(k, w, spacing), canon, "entropy").emissions(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    mask = np.asarray(jem.mask)
    np.testing.assert_array_equal(em.mask.numpy(), mask)
    np.testing.assert_array_equal(u64(em.values)[mask],
                                  np.asarray(jem.values)[mask])


def test_encoder_entropy_matches_jit():
    """The case of tests/test_jit_parity.py:19 against the jnp path."""
    rng = np.random.default_rng(11)
    enc = JEncoder(JSpacer(13, 29), True, "entropy")
    seqs = [random_dna(rng, int(rng.integers(34, 300)), 0.03)
            for _ in range(5)]
    codes, lengths = batch_from_seqs(seqs)
    j_vals, j_mask = jax.jit(lambda c, n: tuple(enc.emissions(c, n)))(
        jnp.asarray(codes), jnp.asarray(lengths))
    em = BatchEncoder(Spacer(13, 29), True, "entropy").emissions(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    mask = np.asarray(j_mask)
    np.testing.assert_array_equal(em.mask.numpy(), mask)
    np.testing.assert_array_equal(u64(em.values)[mask],
                                  np.asarray(j_vals)[mask])


@pytest.mark.parametrize("disc", ["kb4", "kb1 spaced"])
def test_the_order_of_the_dna_shannon_adds_decides_these_rows(disc):
    """The rows of ``tests/shannon_order.py``: -k 31 -w 40 canonical
    (KB4) and -k 21 -S 0x16,1x4 -w 40 (KB1 spaced).  On each, the JAX
    package's entropy_value moves some seed's H by exactly one ulp (and
    none by more than two) when G's term is added before C's, and a window
    minimum changes with it:
    the port's plain encoder, equal to the JAX BatchEncoder there, emits
    another minimizer than it emits in that order.  The card tests hold
    KB4 and KB1 spaced to the plain version on the same rows."""
    import shannon_order as so

    if disc == "kb4":
        codes, lengths = so.kb4_rows()
        k, spacer = 31, (31, 40, "")
        counts = jent.window_code_counts(codes, k, 4)
    else:
        codes, lengths = so.kb1_spaced_rows()
        k, spacer = 21, (21, 40, so.SPACING21)
        counts = jent.spaced_code_counts(codes, so.positions21(), 4)
    h = jent.entropy_value(counts, k)
    h_swapped = jent.entropy_value(counts[..., so.SWAP], k)
    ulps = np.abs(h - h_swapped) / np.spacing(np.abs(h))
    assert set(np.unique(ulps)) <= {0.0, 1.0, 2.0}
    assert (ulps == 1).any(-1).all()
    canon = disc == "kb4"
    jem = JEncoder(JSpacer(*spacer), canon, "entropy").emissions(codes,
                                                                 lengths)
    enc = BatchEncoder(Spacer(*spacer), canon, "entropy")
    ct, lt = torch.from_numpy(codes), torch.from_numpy(lengths)
    em = enc.emissions(ct, lt)
    mask = np.asarray(jem.mask)
    np.testing.assert_array_equal(em.mask.numpy(), mask)
    np.testing.assert_array_equal(u64(em.values)[mask],
                                  np.asarray(jem.values)[mask])
    with so.swapped_order():
        other = enc.emissions(ct, lt)
    differs = (em.values != other.values) & (em.mask | other.mask)
    assert (differs | (em.mask != other.mask)).any(-1).all()


@pytest.mark.parametrize("name", ["PROTEIN20", "PROTEIN_6"])
@pytest.mark.parametrize("disc", ["kb4", "kb1 spaced"])
def test_the_order_of_the_radix_shannon_adds_decides_these_rows(name, disc):
    """The rows of ``tests/shannon_order.py`` ``radix_rows``: PROTEIN20
    at k = 14 (numpy's eight accumulators for codes 0..15, then 16..19)
    and PROTEIN_6 at k = 24 (in code order), one window of W = 2 a row,
    contiguous (KB4) or the spaced seed of every other code (KB1).  On
    each row the JAX package's entropy_value gives some seed another H
    when the terms are added in another order (PROTEIN20's in code order,
    PROTEIN_6's with codes 1 and 2 exchanged), and the port's plain
    encoder, equal to the JAX BatchEncoder there, emits another minimizer
    in that order.  The card tests hold KB4 and KB1 to the plain version
    on the same rows."""
    import shannon_order as so
    from bonsai_tpu.core.alphabet import InputType as JInputType

    kernel = disc.split()[0]
    codes, lengths = so.radix_rows(name, kernel)
    k = so.RADIX[name][0]
    it = JInputType[name]
    R = 20 if name == "PROTEIN20" else 6
    if kernel == "kb4":
        spacer = (k, k + 1, "")
        counts = jent.window_code_counts(codes, k, R)
    else:
        spacer = (k, 2 * k, f"1x{k - 1}")
        counts = jent.spaced_code_counts(codes, so.radix_positions(k), R)
    terms = entropy.shannon_terms(k)
    h = jent.entropy_value(counts, k)
    if name == "PROTEIN20":  # in code order
        h_other = np.zeros(h.shape)
        for c in range(R):
            h_other = h_other + terms[counts[..., c]]
    else:
        h_other = jent.entropy_value(counts[..., [0, 2, 1, 3, 4, 5]], k)
    valid = (counts.sum(-1) == k)
    assert ((h != h_other) & valid).any(-1).all()
    jem = JEncoder(JSpacer(*spacer), False, "entropy",
                   input_type=it).emissions(codes, lengths)
    enc = BatchEncoder(Spacer(*spacer), False, "entropy", input_type=it)
    ct, lt = torch.from_numpy(codes), torch.from_numpy(lengths)
    em = enc.emissions(ct, lt)
    mask = np.asarray(jem.mask)
    assert mask.any(-1).all()
    np.testing.assert_array_equal(em.mask.numpy(), mask)
    np.testing.assert_array_equal(u64(em.values)[mask],
                                  np.asarray(jem.values)[mask])
    with so.radix_other_order(name):
        other = enc.emissions(ct, lt)
    differs = (em.values != other.values) & (em.mask | other.mask)
    assert (differs | (em.mask != other.mask)).any(-1).all()
