"""KR1's prefix-XOR formulation against the JAX package's cyclic hashes.

KR1 (``bonsai_tpu_torch/csrc/rolling.cu``) takes each window's hash as
the XOR of two exclusive prefixes, EQ(i + k) ^ EQ(i), of the rotated
table entries Q(m) = rotr_{m mod 64}(Tf[c_m]) (and R(m) = rotl_{m mod
64}(Tr[3 - c_m]) for the reverse complement), tile by tile: a block of
KR1_TILE windows stages the codes of its windows and those at their ends,
scans both ranges' runs of KR1_RUN, and adds the span [j0, j0 + k) to the
second, from its first scan where k < KR1_TILE, else the first range's
total and the codes between the ranges; each thread takes its run's first
window from those prefixes and rolls the rest.  The kernel cannot run on the
CPU, so ``scan_hashes`` transcribes that arithmetic in numpy, tile by tile
and run by run, and the tests hold it to ``buzhash`` / ``buzhash_rc`` of
``bonsai_tpu/core/rolling.py`` (forward, canonical, ntHash's seeds, a
20-character table) and to the port's ``cyclic_hashes_plain``, at k
within, at and past a tile, with Ns at run, tile and halo edges.  Codes
past the table read 0 in the port, where the JAX package's numpy path
raises (forward) or wraps (reverse complement): those rows are held to
``cyclic_hashes_plain`` alone.  Tolerance: exact equality (xor and
rotations of 64-bit words).
"""

import numpy as np
import pytest
import torch

from bonsai_tpu.core import rolling as jroll

from bonsai_tpu_torch.core import rolling

torch.set_num_threads(1)
T, RUN = rolling.KR1_TILE, rolling.KR1_RUN
KS = (1, 7, 63, 64, 65, 128, 200, 1000, T + 1, 3 * T + 5)
U = np.uint64


def _rotl(x, r):
    r = np.asarray(r, dtype=np.uint64) & U(63)
    return (x << r) | (x >> ((U(64) - r) & U(63)))


def _rotr(x, r):
    r = np.asarray(r, dtype=np.uint64) & U(63)
    return (x >> r) | (x << ((U(64) - r) & U(63)))


def _fi(c):
    """The forward entry of codes ``c``: entry 0 for an ambiguous code."""
    return np.where(c < 0, 0, c)


def _ri(c):
    """The reverse complement's entry: 3 - c, 0 for an ambiguous code, 4
    (which is 0) past 3."""
    return np.where(c < 0, 0, np.where(c > 3, 4, 3 - c))


def _at(c, m, tf, tr):
    """Q, R and the ambiguity of codes ``c`` at row positions ``m``, as the
    kernel's ``Tables::at`` reads its tables (Tf's 128 entries, Tr's 5)."""
    c = c.astype(np.int64)
    return _rotr(tf[_fi(c)], m), _rotl(tr[_ri(c)], m), (c < 0).astype(np.int64)


def _runs(c, base, tf, tr, lim=None):
    """``Tables::run`` of each thread's run of RUN codes ``c`` (threads,
    RUN) at positions base + r: each code rotated by its r, XORed, the
    total rotated by base; the ambiguous codes counted; with ``lim`` (one
    a thread), the same of each run's first lim codes alone."""
    q, r, n = _at(c, np.arange(RUN), tf, tr)
    if lim is not None:
        keep = np.arange(RUN) < lim[:, None]
        q, r, n = q * keep, r * keep, n * keep
    b = base[:, 0].astype(np.uint64)
    return (_rotr(np.bitwise_xor.reduce(q, 1), b),
            _rotl(np.bitwise_xor.reduce(r, 1), b), n.sum(1))


def _exclusive(x, xor=True):
    """Exclusive prefix (XOR or sum) along the last axis."""
    acc = (np.bitwise_xor if xor else np.add).accumulate(x, axis=-1)
    out = np.zeros_like(x)
    out[..., 1:] = acc[..., :-1]
    return out


def scan_hashes(codes, k, table_f, table_r=None):
    """numpy transcription of KR1: (B, L) int8 codes -> (values (B, P) u64,
    invalid (B, P) bool), tile by tile and run by run as its blocks and
    threads compute them."""
    B, L = codes.shape
    P = L - k + 1
    tf = np.zeros(128, np.uint64)
    tf[: min(len(table_f), 128)] = table_f[:128]
    tr = np.zeros(5, np.uint64)
    if table_r is not None:
        tr[:4] = table_r
    tfk, trk = _rotl(tf, k), _rotl(tr, k)  # the roll's tables
    values = np.zeros((B, P), np.uint64)
    invalid = np.zeros((B, P), bool)
    threads = T // RUN
    for b in range(B):
        row = codes[b]
        for j0 in range(0, P, T):
            # the staged ranges: the tile's codes and those at its windows'
            # ends (codes past the row reach only windows past P: 0 here)
            ma = j0 + np.arange(T, dtype=np.int64)
            mb = ma + k
            ca = np.where(ma < L, row[np.minimum(ma, L - 1)], 0)
            cb = np.where(mb < L, row[np.minimum(mb, L - 1)], 0)
            ca, cb = ca.reshape(threads, RUN), cb.reshape(threads, RUN)
            a = ma.reshape(threads, RUN)[:, :1]
            ra, rb = _runs(ca, a, tf, tr), _runs(cb, a + k, tf, tr)
            # the runs' totals scanned over the block's threads; the span
            # [j0, j0 + k): each run's codes below j0 + k, summed, and past
            # the tile the codes between the staged ranges
            ea = [_exclusive(ra[0]), _exclusive(ra[1]),
                  _exclusive(ra[2], xor=False)]
            eb = [_exclusive(rb[0]), _exclusive(rb[1]),
                  _exclusive(rb[2], xor=False)]
            lim = np.clip(k - RUN * np.arange(threads), 0, RUN)
            part = _runs(ca, a, tf, tr, lim)
            span = [np.bitwise_xor.reduce(part[0]),
                    np.bitwise_xor.reduce(part[1]), int(part[2].sum())]
            if k > T:
                mm = np.arange(j0 + T, j0 + k, dtype=np.int64)
                q, rr, nn = _at(row[mm], mm, tf, tr)
                span = [span[0] ^ np.bitwise_xor.reduce(q),
                        span[1] ^ np.bitwise_xor.reduce(rr),
                        span[2] + int(nn.sum())]
            eb = [eb[0] ^ span[0], eb[1] ^ span[1], eb[2] + span[2]]
            # each run's first window from the prefixes, then the roll
            au = a[:, 0].astype(np.uint64)
            h = _rotl(ea[0] ^ eb[0], au + U(k - 1))
            hr = _rotr(ea[1] ^ eb[1], au)
            amb = eb[2] - ea[2]
            v = np.zeros((threads, RUN), np.uint64)
            bad = np.zeros((threads, RUN), bool)
            for r in range(RUN):
                v[:, r] = np.minimum(h, hr) if table_r is not None else h
                bad[:, r] = amb > 0
                co, ci = ca[:, r].astype(np.int64), cb[:, r].astype(np.int64)
                h = _rotl(h, 1) ^ tfk[_fi(co)] ^ tf[_fi(ci)]
                hr = _rotr(hr ^ tr[_ri(co)] ^ trk[_ri(ci)], 1)
                amb = amb + (ci < 0) - (co < 0)
            m = min(T, P - j0)
            values[b, j0: j0 + m] = v.ravel()[:m]
            invalid[b, j0: j0 + m] = bad.ravel()[:m]
    return values, invalid


def _rows(rng, k, n_chars=4, B=3):
    """Rows of P = 2 T + 37 windows with 2% Ns, Ns at the ends of runs,
    tiles and their halos, an N run and a row of one code."""
    L = 2 * T + 37 + k - 1
    codes = rng.integers(0, n_chars, (B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.02] = -1
    for p in (0, RUN - 1, RUN, T - 1, T, T + RUN, k - 1, k, T + k - 1,
              T + k, 2 * T + k - 2):
        if p < L:
            codes[1, p] = -1
    codes[0, T - 10: T + 30] = -1
    codes[-1] = n_chars - 1
    return codes


def _tables(mode, n_chars=4):
    if mode == "nthash":
        return jroll.NTHASH_SEEDS, jroll.NTHASH_SEEDS
    return (jroll.character_table(1337, 137, n_chars),
            jroll.character_table(1337 * 137, 1337 ^ 137, n_chars))


def _plain(codes, k, tf, tr=None):
    v, inv = rolling.cyclic_hashes_plain(
        torch.from_numpy(codes), k, rolling._table(tf, "cpu"),
        None if tr is None else rolling._table(tr, "cpu"))
    return v.numpy().view(np.uint64), inv.numpy()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", ["forward", "canon", "nthash"])
def test_scan_matches_jax(k, mode):
    rng = np.random.default_rng(k * 7 + len(mode))
    codes = _rows(rng, k, B=3 if k < T else 2)
    tf, tr = _tables(mode)
    jh, jinv = jroll.buzhash(codes, k, tf)
    if mode != "forward":
        jh = np.minimum(jh, jroll.buzhash_rc(codes, k, tr)[0])
    else:
        tr = None
    got, inv = scan_hashes(codes, k, tf, tr)
    np.testing.assert_array_equal(got, jh)
    np.testing.assert_array_equal(inv, jinv)
    assert inv[0].any() and not inv[-1].any()
    pv, pinv = _plain(codes, k, tf, tr)
    np.testing.assert_array_equal(got, pv)
    np.testing.assert_array_equal(inv, pinv)


@pytest.mark.parametrize("k", [1, 21, 65, T + 1])
def test_scan_twenty_characters_matches_jax(k):
    rng = np.random.default_rng(k + 20)
    codes = _rows(rng, k, n_chars=20, B=2)
    tf, _ = _tables("forward", 20)
    got, inv = scan_hashes(codes, k, tf)
    jh, jinv = jroll.buzhash(codes, k, tf)
    np.testing.assert_array_equal(got, jh)
    np.testing.assert_array_equal(inv, jinv)


@pytest.mark.parametrize("k", [7, 65, T + 1])
def test_scan_codes_past_the_table(k):
    """Codes past a 2-entry table and past 3 (a reverse complement of 0)
    read 0, as in the plain version."""
    rng = np.random.default_rng(k + 128)
    codes = _rows(rng, k)
    tf, tr = _tables("canon")
    _, tf2 = _tables("canon", 2)
    got = scan_hashes(codes, k, tf2)
    for g, w in zip(got, _plain(codes, k, tf2)):
        np.testing.assert_array_equal(g, w)
    codes[rng.random(codes.shape) < 0.1] = 127
    codes[0, :20] = 4
    got = scan_hashes(codes, k, tf, tr)
    for g, w in zip(got, _plain(codes, k, tf, tr)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("P", [1, T - 1, T, T + 1])
@pytest.mark.parametrize("k", [31, T])
def test_scan_rows_at_tile_edges(P, k):
    """Rows whose windows end inside, at and past a tile's end; k = T takes
    the span as the first range's total."""
    rng = np.random.default_rng(P + k)
    codes = rng.integers(0, 4, (2, P + k - 1)).astype(np.int8)
    codes[rng.random(codes.shape) < 0.01] = -1
    tf, tr = _tables("canon")
    got, inv = scan_hashes(codes, k, tf, tr)
    jh = np.minimum(jroll.buzhash(codes, k, tf)[0],
                    jroll.buzhash_rc(codes, k, tr)[0])
    np.testing.assert_array_equal(got, jh)
    np.testing.assert_array_equal(inv, jroll.buzhash(codes, k, tf)[1])
