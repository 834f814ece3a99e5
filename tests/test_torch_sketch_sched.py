"""The schedules of the sketch kernels KS2 and KS3, modelled in numpy and
held to the JAX package on the CPU.

KS2 (``csrc/setsketch.cu``) leaves the JAX package's schedule in two
places, and its note argues why the results stay the same: in the default
mode, once the registers' max is finite, every element runs to its first
arrival at or past a threshold that is refreshed only now and then (fact
(a): the registers are the minimum over all arrivals; fact (b): an
element's times only rise); in -S / -s mode an element stops at its first
arrival at or past the round's threshold, and of tied arrivals at a
register the smallest element wins.  The models below follow the kernel's
schedule and must give ``bonsai_tpu.sketch.setsketch.CSetSketch``'s
registers, ids and idcounts bit for bit, on new and on full sketches, over
several chunks, with copies of one value, at m = 1, 64 and 4096.

KS2's bound counts the arrivals any exact schedule must evaluate
(``csetsketch_update_plain.required``); it is held to a count made one
arrival at a time.

KS3 (``csrc/sort_unique.cu`` ``bk_sort_count``) partitions the keys by
their top bits (``shs.sort_count_plan``), finishes a bucket in shared
memory when it and its split fit, and any other bucket by a radix sort of
its own.  Its model must give ``bonsai_tpu.sketch.shs.count_hashes``'s
keys and counts on skewed keys, and take the path the plan says.
"""

import math

import numpy as np
import pytest
import torch

from bonsai_tpu.sketch import setsketch as jss
from bonsai_tpu.sketch import shs as jshs
from bonsai_tpu_torch.sketch import setsketch as ss
from bonsai_tpu_torch.sketch import shs

STEPS = 16


def _values(rng, n):
    return rng.integers(0, 2**64, n, dtype=np.uint64)


def _round(h, t, ctr, m):
    """One round of each element: its (times, registers), as the JAX
    package computes them."""
    gaps, reg = jss._arrivals(h, ctr, STEPS, m)
    return t[:, None] + np.cumsum(gaps, axis=1), reg


# -- KS2, default mode ----------------------------------------------------------

def ks2_default(regs, values, chunk, tile, refresh_every):
    """KS2's default schedule: the JAX package's rounds while a register
    is +inf, then every element in tiles of ``tile``, each to its first
    arrival at or past a threshold read from the registers only every
    ``refresh_every`` tiles."""
    v = np.asarray(values, np.uint64)
    n, m = v.size, regs.size
    h = jss._mix(v) if n else v
    lo, fresh = 0, True
    t = ctr = live = None
    while lo < n and not np.isfinite(regs.max()):
        cn = min(chunk, n - lo)
        if fresh:
            t, ctr = np.zeros(cn), np.zeros(cn, np.uint64)
            live = np.ones(cn, bool)
        idx = np.nonzero(live)[0]
        thresh = regs.max()
        times, reg = _round(h[lo + idx], t[idx], ctr[idx], m)
        below = times < thresh
        np.minimum.at(regs, reg[below], times[below])
        t[idx], ctr[idx] = times[:, -1], ctr[idx] + np.uint64(STEPS)
        live[idx] = below[:, -1]
        fresh = not live.any()
        if fresh:
            lo += chunk
    if lo >= n:
        return regs
    thr, refreshed = regs.max(), math.inf
    carry_end = lo if fresh else lo + chunk
    for k, base in enumerate(range(lo, n, tile)):
        if k and k % refresh_every == 0:
            refreshed = min(refreshed, regs.max())
        thresh = min(thr, refreshed)
        i = np.arange(base, min(base + tile, n))
        tt, c = np.zeros(i.size), np.zeros(i.size, np.uint64)
        carried = i < carry_end
        if carried.any():
            loc = i[carried] - lo
            tt[carried], c[carried] = t[loc], ctr[loc]
            keep = ~carried
            keep[carried] = live[loc]
            i, tt, c = i[keep], tt[keep], c[keep]
        while i.size:
            times, reg = _round(h[i], tt, c, m)
            below = times < thresh  # a prefix of each row: times rise
            np.minimum.at(regs, reg[below], times[below])
            on = below[:, -1]
            i, tt, c = i[on], times[on, -1], c[on] + np.uint64(STEPS)
    return regs


# -- KS2, -S / -s ----------------------------------------------------------------

def ks2_ids(regs, ids, idc, values, chunk):
    """KS2's -S / -s schedule: each round, every live element up to its
    first arrival at or past the threshold (A); of the arrivals at a
    register's round minimum, the smallest element's (B); the round
    applied by each register (C)."""
    v = np.asarray(values, np.uint64)
    m = regs.size
    for lo in range(0, v.size, chunk):
        x = v[lo: lo + chunk]
        h = jss._mix(x)
        t, ctr = np.zeros(x.size), np.zeros(x.size, np.uint64)
        live = np.arange(x.size)
        while live.size:
            thresh = regs.max()
            times, reg = _round(h[live], t[live], ctr[live], m)
            below = times < thresh
            el = np.broadcast_to(live[:, None], reg.shape)[below]
            r, tm = reg[below], times[below]
            rmin = np.full(m, np.inf)
            np.minimum.at(rmin, r, tm)
            at = tm == rmin[r]
            rarg = np.full(m, x.size)
            np.minimum.at(rarg, r[at], el[at])
            for q in np.nonzero(np.isfinite(rmin))[0]:
                val = x[rarg[q]]
                if rmin[q] < regs[q]:
                    regs[q], ids[q] = rmin[q], val
                    if idc is not None:
                        idc[q] = 1
                elif idc is not None and rmin[q] == regs[q] and val == ids[q]:
                    idc[q] += 1
            on = below[:, -1]
            t[live[on]] = times[on, -1]
            ctr[live[on]] += np.uint64(STEPS)
            live = live[on]


def _updates(rng):
    """Three updates: a new sketch over 3+ chunks of 4096 with copies of
    one value in and across chunks, then two more into the full sketch."""
    v = _values(rng, 9000)
    return [np.concatenate([v, np.full(3000, v[7]), v[:500]]),
            _values(rng, 2 * 4096 + 11), np.full(5000, v[3])]


@pytest.mark.parametrize("m", [1, 64, 4096])
@pytest.mark.parametrize("refresh_every", [1, 3])
def test_ks2_default_schedule_matches_jax(m, refresh_every):
    rng = np.random.default_rng(m + refresh_every)
    want = jss.CSetSketch(m)
    regs = np.full(m, np.inf)
    for v in _updates(rng):
        want.update(v, chunk=4096)
        ks2_default(regs, v, 4096, 700, refresh_every)
        np.testing.assert_array_equal(regs.view(np.uint64),
                                      want.registers.view(np.uint64))


@pytest.mark.parametrize("m", [1, 64, 4096])
@pytest.mark.parametrize("counts", [False, True])
def test_ks2_ids_schedule_matches_jax(m, counts):
    rng = np.random.default_rng(2 * m + counts)
    want = jss.CSetSketch(m, True, counts)
    regs = np.full(m, np.inf)
    ids = np.zeros(m, np.uint64)
    idc = np.zeros(m, np.uint32) if counts else None
    for v in _updates(rng):
        want.update(v, chunk=4096)
        ks2_ids(regs, ids, idc, v, 4096)
        np.testing.assert_array_equal(regs.view(np.uint64),
                                      want.registers.view(np.uint64))
        np.testing.assert_array_equal(ids, want.ids())
        if counts:
            np.testing.assert_array_equal(idc, want.idcounts())


def _required_one_by_one(values, m, chunk):
    """The arrivals an exact schedule evaluates, one at a time: under the
    JAX package's rounds, those below their round's threshold, and each
    element's first at or past it."""
    regs = np.full(m, np.inf)
    need = 0
    for lo in range(0, len(values), chunk):
        x = values[lo: lo + chunk]
        h = jss._mix(x)
        t = [0.0] * x.size
        c = [0] * x.size
        live = list(range(x.size))
        while live:
            thresh = regs.max()
            upd, nxt = [], []
            for e in live:
                gaps, reg = jss._arrivals(h[e: e + 1],
                                          np.array([c[e]], np.uint64),
                                          STEPS, m)
                s = np.cumsum(gaps[0])
                for j in range(STEPS):
                    need += 1
                    tm = t[e] + s[j]
                    if not tm < thresh:
                        break
                    upd.append((reg[0, j], tm))
                else:
                    t[e], c[e] = t[e] + s[-1], c[e] + STEPS
                    nxt.append(e)
            for r, tm in upd:
                regs[r] = min(regs[r], tm)
            live = nxt
    return need


@pytest.mark.parametrize("m", [1, 64])
def test_ks2_required_arrivals(m):
    rng = np.random.default_rng(11 + m)
    v = np.concatenate([_values(rng, 40), np.full(9, 5, np.uint64)])
    ss.csetsketch_update_plain.arrivals = 0
    ss.csetsketch_update_plain.required = 0
    regs = torch.full((m,), math.inf, dtype=torch.float64)
    ss.csetsketch_update_plain(torch.from_numpy(v.view(np.int64)), regs,
                               None, None, chunk=16)
    req = ss.csetsketch_update_plain.required
    assert req == _required_one_by_one(v, m, 16)
    assert 0 < req <= ss.csetsketch_update_plain.arrivals


def test_ks2_plain_tie_rule_is_the_first_element():
    """Two values whose arrivals tie exactly at a register: the JAX
    package's lexsort keeps the first element's id, and so does the port's
    plain version (the round's candidates are equal: copies of a value)."""
    v = np.array([9, 9, 4, 9], np.uint64)
    want = jss.CSetSketch(8, True, True)
    want.update(v)
    got = ss.CSetSketch(8, True, True, device="cpu")
    got.update(v)
    np.testing.assert_array_equal(got.ids(), want.ids())
    np.testing.assert_array_equal(got.idcounts(), want.idcounts())


# -- KS3 --------------------------------------------------------------------------

def ks3(keys):
    """KS3's plan on numpy: (sorted distinct keys, u16 counts, the path of
    each non-empty bucket: "shared" or "radix")."""
    keys = np.asarray(keys, np.uint64)
    bits = shs.sort_count_plan(keys.size)
    shift = np.uint64(64 - bits)
    sub_shift = np.uint64(64 - bits - shs.SC_SUB_BITS)
    bucket = keys >> shift
    outk, outc, paths = [], [], []
    for j in np.unique(bucket):
        b = keys[bucket == j]
        sub = (b >> sub_shift) & np.uint64((1 << shs.SC_SUB_BITS) - 1)
        if (b.size <= shs.SC_CAP and np.bincount(
                sub.astype(np.int64)).max() <= shs.SC_SMALL):
            paths.append("shared")  # by the split, each run then sorted
            b = b[np.lexsort((b, sub))]
        else:
            paths.append("radix")  # stable LSD, shared digits skipped
            for d in range((64 - bits + 7) // 8):
                dig = (b >> np.uint64(8 * d)) & np.uint64(0xFF)
                if (dig == dig[0]).all():
                    continue
                b = b[np.argsort(dig, kind="stable")]
        first = np.ones(b.size, bool)
        first[1:] = b[1:] != b[:-1]
        starts = np.nonzero(first)[0]
        outk.append(b[first])
        outc.append(np.minimum(np.diff(np.append(starts, b.size)), 0xFFFF))
    if not outk:
        return np.empty(0, np.uint64), np.empty(0, np.uint16), paths
    return (np.concatenate(outk), np.concatenate(outc).astype(np.uint16),
            paths)


@pytest.mark.parametrize("E,bits", [
    (0, 1), (1, 1), (10240, 1), (10241, 1), (10242, 2), (4641622, 10),
    (5120 << 13, 13), ((1 << 30) - 1, 13)])
def test_ks3_plan(E, bits):
    assert shs.sort_count_plan(E) == bits
    assert E >> bits <= shs.SC_BUCKET_MEAN or bits == shs.SC_MAX_BITS
    assert bits == 1 or E >> (bits - 1) > shs.SC_BUCKET_MEAN


def _ks3_case(rng, case):
    u = lambda n: _values(rng, n)
    if case == "hashes":
        return np.concatenate([u(200000), u(1000).repeat(3)]), {"shared"}
    if case == "one_key":  # one key x 70,000, a bucket past capacity
        return np.concatenate([np.full(70000, 123456789, np.uint64),
                               u(30000)]), {"shared", "radix"}
    if case == "below_2_20":  # every key in bucket 0
        return rng.integers(0, 1 << 20, 150000).astype(np.uint64), {"radix"}
    if case == "past_cap":  # one bucket of distinct keys past capacity
        x = u(shs.SC_CAP + 3000) & np.uint64((1 << 50) - 1)
        return np.concatenate([x, u(60000)]), {"shared", "radix"}
    if case == "bit63":
        return u(50000) | np.uint64(1 << 63), {"shared"}
    raise ValueError(case)


@pytest.mark.parametrize("case", ["hashes", "one_key", "below_2_20",
                                  "past_cap", "bit63"])
def test_ks3_model_matches_jax(case):
    keys, paths = _ks3_case(np.random.default_rng(3), case)
    keys = keys[np.random.default_rng(4).permutation(keys.size)]
    got_k, got_c, took = ks3(keys)
    want_k, want_c = jshs.count_hashes(keys)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)
    assert set(took) == paths
    # and the port's plain version on the CPU
    k, c = shs.sort_count_plain(torch.from_numpy(keys.view(np.int64)),
                                torch.ones(keys.size, dtype=torch.bool))
    np.testing.assert_array_equal(k.numpy().view(np.uint64), want_k)
    np.testing.assert_array_equal(c.numpy().view(np.uint16), want_c)
