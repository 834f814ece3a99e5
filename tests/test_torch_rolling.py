"""Port parity: cyclic rolling hashes (``core/rolling.py``, queue A item
8.7).

The same numpy-seeded codes go through the JAX package's numpy path
(``buzhash``, ``buzhash_rc``, ``RollingEncoder``, ``MultiKRollingEncoder``)
and through ``bonsai_tpu_torch.core.rolling`` (int64 tensors holding u64
bits; on the CPU ``cyclic_hashes`` takes KR1's plain torch version), at
k = 1, 7, 63, 64, 65 and 200 (the rotations wrap at 64).  Tolerance:
exact equality (xor and rotations of 64-bit words).
"""

import numpy as np
import pytest
import torch

from bonsai_tpu.core import rolling as jroll

from bonsai_tpu_torch.core import rolling
from bonsai_tpu_torch.core.alphabet import DNA4

KS = (1, 7, 63, 64, 65, 200)


def u64(t):
    return t.numpy().view(np.uint64)


def _codes(rng, B, L, n_chars=4, n_prob=0.03):
    codes = rng.integers(0, n_chars, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < n_prob] = -1
    codes[1, 40:300] = -1  # an N run longer than most k
    return codes


def test_host_tables_match_jax():
    for n in (4, 20):
        np.testing.assert_array_equal(rolling.character_table(1337, 137, n),
                                      jroll.character_table(1337, 137, n))
    np.testing.assert_array_equal(rolling.NTHASH_SEEDS, jroll.NTHASH_SEEDS)
    a, b = rolling._MT19937_64(1337), jroll._MT19937_64(1337)
    assert [a.next() for _ in range(700)] == [b.next() for _ in range(700)]


@pytest.mark.parametrize("k", KS)
def test_buzhash_and_rc_match_jax(k):
    rng = np.random.default_rng(k)
    codes = _codes(rng, 3, 700)
    tf = jroll.character_table(1337, 137)
    tr = jroll.character_table(1337 * 137, 1337 ^ 137)
    ct = torch.from_numpy(codes)
    h, inv = rolling.cyclic_hashes_plain(ct, k, rolling._table(tf, "cpu"))
    jh, jinv = jroll.buzhash(codes, k, tf)
    np.testing.assert_array_equal(u64(h), jh)
    np.testing.assert_array_equal(inv.numpy(), jinv)
    h, _ = rolling.cyclic_hashes_plain(ct, k, rolling._table(tf, "cpu"),
                                       rolling._table(tr, "cpu"))
    np.testing.assert_array_equal(
        u64(h), np.minimum(jh, jroll.buzhash_rc(codes, k, tr)[0]))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("canon,nthash", [(False, False), (True, False),
                                          (True, True)])
def test_rolling_encoder_matches_jax(k, canon, nthash):
    rng = np.random.default_rng(k + 1000)
    codes = _codes(rng, 2, 500)
    jv, jinv = jroll.RollingEncoder(k, canon, nthash=nthash).hashes(codes)
    v, inv = rolling.RollingEncoder(k, canon, nthash=nthash).hashes(
        torch.from_numpy(codes))
    np.testing.assert_array_equal(u64(v), jv)
    np.testing.assert_array_equal(inv.numpy(), jinv)


@pytest.mark.parametrize("k", (1, 7, 65))
def test_twenty_characters_match_jax(k):
    """n_chars = 20 (protein codes), forward only."""
    rng = np.random.default_rng(k + 20)
    codes = _codes(rng, 2, 300, n_chars=20)
    jv, jinv = jroll.RollingEncoder(k, n_chars=20).hashes(codes)
    v, inv = rolling.RollingEncoder(k, n_chars=20).hashes(
        torch.from_numpy(codes))
    np.testing.assert_array_equal(u64(v), jv)
    np.testing.assert_array_equal(inv.numpy(), jinv)


def test_canon_needs_four_characters():
    """The reverse complement reads code 3 - c, which the JAX package
    indexes at a negative position for protein codes: the port refuses
    canon with n_chars != 4, and nthash with them as the JAX package."""
    with pytest.raises(ValueError, match="n_chars=20"):
        rolling.RollingEncoder(7, canon=True, n_chars=20)
    with pytest.raises(ValueError, match="DNA-only"):
        rolling.RollingEncoder(7, nthash=True, n_chars=20)


@pytest.mark.parametrize("canon,nthash", [(False, False), (True, False),
                                          (True, True)])
def test_multi_k_encoder_matches_jax(canon, nthash):
    rng = np.random.default_rng(5)
    codes = _codes(rng, 3, 400)
    lengths = np.array([400, 250, 63], np.int32)
    ks = KS
    want = jroll.MultiKRollingEncoder(ks, canon, nthash=nthash).hashes(
        codes, lengths)
    got = rolling.MultiKRollingEncoder(ks, canon, nthash=nthash).hashes(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    for (v, ok), (jv, jok) in zip(got, want):
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(u64(v), np.asarray(jv))


@pytest.mark.parametrize("k", (1, 7, 65))
def test_codes_past_the_table_read_zero(k):
    """A code at or past the table's length reads 0 on both strands, as
    in KR1: the JAX package's numpy hash over a table padded with zeros
    to 128 entries (its negative reverse-complement index then wraps to a
    zero entry)."""
    rng = np.random.default_rng(k + 128)
    codes = _codes(rng, 2, 300)
    renc = rolling.RollingEncoder(k, n_chars=2)  # DNA codes 2 and 3 past it
    v, inv = renc.hashes(torch.from_numpy(codes))
    jv, jinv = jroll.buzhash(codes, k, _zero_padded(renc.table_f))
    np.testing.assert_array_equal(u64(v), jv)
    np.testing.assert_array_equal(inv.numpy(), jinv)
    wide = codes.copy()
    wide[rng.random(wide.shape) < 0.1] = 127
    wide[0, :20] = 4
    tf = jroll.character_table(1337, 137)
    tr = jroll.character_table(1337 * 137, 1337 ^ 137)
    v, inv = rolling.cyclic_hashes_plain(torch.from_numpy(wide), k,
                                         rolling._table(tf, "cpu"),
                                         rolling._table(tr, "cpu"))
    jh, jinv = jroll.buzhash(wide, k, _zero_padded(tf))
    jr = jroll.buzhash_rc(wide, k, _zero_padded(tr))[0]
    np.testing.assert_array_equal(u64(v), np.minimum(jh, jr))
    np.testing.assert_array_equal(inv.numpy(), jinv)


def _zero_padded(table):
    return np.concatenate([table, np.zeros(128 - table.size, np.uint64)])


def test_dna_lut_codes_hash_as_jax():
    """Codes from the DNA4 alphabet, as the API makes them."""
    seq = np.frombuffer(b"ACGTNNacgtRYACGT" * 20, np.uint8)
    codes = DNA4.lut[seq][None, :]
    jv, jinv = jroll.RollingEncoder(13, True).hashes(codes)
    v, inv = rolling.RollingEncoder(13, True).hashes(torch.from_numpy(codes))
    np.testing.assert_array_equal(u64(v), jv)
    np.testing.assert_array_equal(inv.numpy(), jinv)


# -- RollingEncoder.emissions: KR1, then KB4's stream source --------------------

def _emissions_equal(got, want):
    """The masks equal, and the values where they are emitted (column 0
    holds U64_MAX in the port where its tail is not emitted; the JAX
    package leaves the minimum of every pushed hash there)."""
    v, m = got
    jv, jm = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_array_equal(u64(v)[jm], jv[jm])
    assert (u64(v[:, :1])[~jm[:, :1]] == np.uint64(2**64 - 1)).all()


@pytest.mark.parametrize("k,w", [(7, -1), (21, 40), (31, 40), (40, 60),
                                 (64, 100), (65, 66)])
@pytest.mark.parametrize("canon", [False, True])
def test_emissions_match_jax(k, w, canon):
    """Unwindowed and windowed (W = w - k + 1, up to 37), canonical and
    not, k past 32; rows shorter than the window, rows cut short by
    their lengths, N runs, an all-N row."""
    rng = np.random.default_rng(k * 7 + w + canon)
    codes = _codes(rng, 5, 400)
    codes[2, :] = -1
    lengths = np.array([400, 90, 400, k + 3, 250], np.int32)
    want = jroll.RollingEncoder(k, canon, w).emissions(codes, lengths)
    got = rolling.RollingEncoder(k, canon, w).emissions(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    if w <= k:
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g.numpy().view(
                np.uint64 if g.dtype == torch.int64 else bool), j)
    else:
        _emissions_equal(got, want)


@pytest.mark.parametrize("k,w", [(5, 12), (9, 9), (12, 300)])
def test_emissions_twenty_characters_match_jax(k, w):
    """A protein alphabet (n_chars = 20, never canonical), windowed and
    not; at w = 300 every row is shorter than its window."""
    rng = np.random.default_rng(k + w)
    codes = _codes(rng, 3, 260, n_chars=20)
    lengths = np.array([260, 200, 30], np.int32)
    want = jroll.RollingEncoder(k, window=w, n_chars=20).emissions(
        codes, lengths)
    got = rolling.RollingEncoder(k, window=w, n_chars=20).emissions(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    if w <= k:
        np.testing.assert_array_equal(u64(got[0]), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
    else:
        _emissions_equal(got, want)


def test_emissions_wide_window_on_the_cpu():
    """A window past the kernel's 8192 values runs in the plain version
    (the card's kernel refuses it)."""
    rng = np.random.default_rng(3)
    codes = _codes(rng, 2, 9000, n_prob=0.0)
    lengths = np.array([9000, 8500], np.int32)
    want = jroll.RollingEncoder(21, True, 8300).emissions(codes, lengths)
    got = rolling.RollingEncoder(21, True, 8300).emissions(
        torch.from_numpy(codes), torch.from_numpy(lengths))
    _emissions_equal(got, want)
