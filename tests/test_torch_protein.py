"""Port parity: the input types other than DNA (queue A item 8.5).

Every ``InputType`` of the JAX package through ``BatchEncoder`` in the
unwindowed, windowed (uncanonical, compacted) and spaced disciplines,
under the schemes lex and entropy, at k from 1 up to the type's
characters per u64 (``nper64``); the JAX package runs its numpy path, the
port the plain torch versions of KB1 and KB4 on the CPU.  Tolerance:
exact equality (integer folds, and the Shannon score's float64 terms in
numpy's order).  Rows are single (1, L) rows, the Python API's shape.
"""

import numpy as np
import pytest
import torch

import bonsai_tpu  # noqa: F401  (enables jax x64)
from bonsai_tpu.core import alphabet as jalpha
from bonsai_tpu.core.encoder import BatchEncoder as JEncoder
from bonsai_tpu.core.spacer import Spacer as JSpacer

from bonsai_tpu_torch.core import alphabet
from bonsai_tpu_torch.core.alphabet import InputType
from bonsai_tpu_torch.core.encoder import BatchEncoder
from bonsai_tpu_torch.core.spacer import Spacer

DNA_CHARS = b"ACGTNacgtRY"
PROTEIN_CHARS = b"ACDEFGHIKLMNPQRSTVWYacdeXBZJOU*"
TYPES = list(InputType)


def u64(t):
    return t.numpy().view(np.uint64)


def _row(rng, it, L):
    """One (1, L) row of the type's codes (ambiguous ones among them) and
    its length; PROTEIN (bytes) also takes bytes past 127 (ambiguous)."""
    if it in (InputType.DNA, InputType.DNA2, InputType.DNAC):
        seq = rng.choice(np.frombuffer(DNA_CHARS, np.uint8), L)
    elif it == InputType.PROTEIN:
        seq = np.where(rng.random(L) < 0.8,
                       rng.choice(np.frombuffer(PROTEIN_CHARS, np.uint8), L),
                       rng.integers(0, 256, L)).astype(np.uint8)
    else:
        seq = rng.choice(np.frombuffer(PROTEIN_CHARS, np.uint8), L)
    codes = jalpha.alphabet_of(it).lut[seq][None, :]
    return codes, np.array([L], np.int32)


def _same(k, w, spacing, it, scheme, codes, lengths):
    jem = JEncoder(JSpacer(k, w, spacing), True, scheme, it).emissions(
        codes, lengths)
    em = BatchEncoder(Spacer(k, w, spacing), True, scheme, it).emissions(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    mask = np.asarray(jem.mask)
    np.testing.assert_array_equal(em.mask.numpy(), mask)
    np.testing.assert_array_equal(u64(em.values)[mask],
                                  np.asarray(jem.values)[mask])
    return u64(em.values)[mask]


def test_alphabet_traits_match_jax():
    for it in TYPES:
        assert alphabet.radix_of(it) == jalpha.radix_of(it)
        assert alphabet.bits_of(it) == jalpha.bits_of(it)
        assert alphabet.nper64(it) == jalpha.nper64(it)
        np.testing.assert_array_equal(alphabet.alphabet_of(it).lut,
                                      jalpha.alphabet_of(it).lut)
        for k in range(1, 33):
            assert alphabet.kmer_mask(it, k) == jalpha.kmer_mask(it, k)


@pytest.mark.parametrize("it", TYPES, ids=lambda t: t.name)
@pytest.mark.parametrize("disc", ["unwindowed", "windowed", "spaced"])
def test_input_type_matches_jax(it, disc):
    n = alphabet.nper64(it)
    rng = np.random.default_rng(int(it) * 10 + len(disc))
    for k in (1, (n + 1) // 2, n):
        if disc == "spaced" and k == 1:
            continue
        spacing = f"1x{k - 1}" if disc == "spaced" else ""
        c = k + (k - 1 if disc == "spaced" else 0)
        w = k if disc == "unwindowed" else c + 9
        codes, lengths = _row(rng, it, 150)
        for scheme in (("lex",) if disc == "unwindowed" else
                       ("lex", "entropy", "entropy-file")):
            _same(k, w, spacing, it, scheme, codes, lengths)


def test_protein_3bit_k22_folds_66_bits():
    """22 residues of code 7 fold to U64_MAX: kept unwindowed (a valid
    seed), dropped as a spaced emission (the N seed's sentinel)."""
    it = InputType.PROTEIN_3BIT
    codes = jalpha.alphabet_of(it).lut[np.frombuffer(b"P" * 60 + b"ACD" * 10,
                                                     np.uint8)][None, :]
    lengths = np.array([codes.shape[1]], np.int32)
    got = _same(22, 22, "", it, "lex", codes, lengths)
    assert (got == np.uint64(2**64 - 1)).sum() == 60 - 21
    got = _same(22, 30, "0x21", it, "lex", codes, lengths)
    _same(22, 30, "", it, "entropy", codes, lengths)


@pytest.mark.parametrize("it,k", [(InputType.PROTEIN, 12),
                                  (InputType.PROTEIN_3BIT, 25),
                                  (InputType.DNA2, 32)])
def test_power_of_two_radix_past_nper64_wraps_as_jax(it, k):
    """Past its characters per u64 a shift-or fold wraps modulo 2^64 in
    both packages (the JAX package takes these pairs)."""
    rng = np.random.default_rng(k)
    codes, lengths = _row(rng, it, 120)
    for w, spacing in ((k, ""), (k + 9, ""), (2 * k + 8, "1x%d" % (k - 1))):
        _same(k, w, spacing, it, "lex", codes, lengths)


@pytest.mark.parametrize("it,k", [(InputType.PROTEIN20, 15),
                                  (InputType.PROTEIN_14, 17),
                                  (InputType.PROTEIN_6, 25)])
def test_refused_pairs(it, k):
    """A modulus radix**k past 2^64: numpy's uint64 refuses it in the
    JAX package, and the port refuses the pair before any launch."""
    rng = np.random.default_rng(k)
    codes, lengths = _row(rng, it, 80)
    with pytest.raises(OverflowError):
        JEncoder(JSpacer(k, k), True, "lex", it).emissions(codes, lengths)
    with pytest.raises(ValueError, match="exceeds 64 bits"):
        BatchEncoder(Spacer(k, k), True, "lex", it)
    BatchEncoder(Spacer(k - 1, k - 1), True, "lex", it)  # nper64 is taken


@pytest.mark.parametrize("it", [t for t in TYPES if t != InputType.DNA],
                         ids=lambda t: t.name)
def test_hash_scheme_of_other_types_is_refused(it):
    """The scheme hash of another input type than DNA is refused only
    without a phase-1 map (the ValueError of a windowed seed, before any
    launch): with one, carried across from the JAX ``KmerTable``, the
    spaced (KB1) and windowed (KB4) seeds emit the JAX encoder's
    minimizers; unwindowed seeds take no score and run as under lex."""
    from bonsai_tpu.db.table import KmerTable as JTable
    from bonsai_tpu.db.table import ScoreMap as JScoreMap

    from bonsai_tpu_torch.core import encoder as enc
    from bonsai_tpu_torch.db.table import KmerTable, ScoreMap

    rng = np.random.default_rng(int(it))
    codes, lengths = _row(rng, it, 60)
    c, ln = torch.from_numpy(codes), torch.from_numpy(lengths)
    with pytest.raises(ValueError, match="score_map"):
        BatchEncoder(Spacer(5, 9), False, "hash", it).emissions(c, ln)
    with pytest.raises(ValueError, match="score_map"):
        BatchEncoder(Spacer(5, 13, "1x4"), False, "hash", it).emissions(c, ln)
    with pytest.raises(ValueError, match="score_map"):
        enc.compacted_minimizers_plain(c, ln, 5, 5, "hash", it=it)
    with pytest.raises(ValueError, match="score_map"):
        enc.minimizers_plain(c, ln, 5, 5, False, "hash", (0, 2, 4, 6, 8),
                             it=it)
    for w, spacing in ((9, None), (13, "1x4")):
        seeds = BatchEncoder(Spacer(5, 5 if spacing is None else 9, spacing),
                             False, "lex", it).emissions(c, ln)
        keys = np.unique(seeds.values[seeds.mask].numpy().view(np.uint64))
        jt = JTable(keys[::2], np.arange(keys[::2].size, dtype=np.uint64))
        smap = ScoreMap(KmerTable(jt.keys_sorted, jt.vals_sorted,
                                  min_nb=jt.nb))
        jem = JEncoder(JSpacer(5, w, spacing), False, "hash", it,
                       JScoreMap(jt)).emissions(codes, lengths)
        em = BatchEncoder(Spacer(5, w, spacing), False, "hash", it,
                          smap).emissions(c, ln)
        mask = np.asarray(jem.mask)
        np.testing.assert_array_equal(em.mask.numpy(), mask)
        np.testing.assert_array_equal(u64(em.values)[mask],
                                      np.asarray(jem.values)[mask])
    got = BatchEncoder(Spacer(5, 5), False, "hash", it).emissions(c, ln)
    want = BatchEncoder(Spacer(5, 5), False, "lex", it).emissions(c, ln)
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.mask, want.mask)
