"""Unbounded-k cyclic rolling hashes (buzhash), batched, on torch tensors.

Counterpart of ``bonsai_tpu/core/rolling.py`` (RollingHasher /
RollingHasherSet, reference encoder.h:644-1003 over rollinghash's
cyclichash.h).  The hash of the k-window at i is

    h_i = XOR_{j<k} rotl_{(k-1-j) mod 64}(T[c_{i+j}])

and that of its reverse complement, with its own table,

    r_i = XOR_{j<k} rotl_{j mod 64}(T'[3 - c_{i+j}]);

an ambiguous code (-1) hashes as code 0 on both strands and makes the
window invalid; a code at or past the table's length reads 0 on both
strands (the JAX package's numpy path raises there, its jnp path clamps;
no entry point reaches it).  ``cyclic_hashes`` is the wrapper of the CUDA kernel KR1
(``csrc/rolling.cu``), which takes each thread's first window from prefix
XORs (with Q(m) = rotr_{m mod 64}(T[c_m]) and EQ its exclusive prefix XOR,
h_i = rotl_{(i+k-1) mod 64}(EQ(i+k) ^ EQ(i)), and likewise r_i), so that a
window costs the same at any k, then rolls the run's others:
h' = rotl1(h) ^ rotl_{k mod 64}(T[out]) ^ T[in]; ``cyclic_hashes_plain``
is its plain torch version (the XOR-fold of k static slices, as the JAX
package computes it), which serves CPU tensors.

The character tables (``character_table``: the wyrand stream of
rollinghash's CharacterHash), ntHash's seeds and std::mt19937_64 (the
seeds of RollingHasherSet) are host Python, copied from that module.
``RollingEncoder.emissions`` windows the hashes as the compacted
discipline does: KR1's values, scored by frev64 of the value, through
KB4's stream source (``core/encoder.py`` ``compacted_stream``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from .bitops import SIGN, shr
from .encode import position_validity
from .encoder import Emissions, compacted_stream

U64_MAX = (1 << 64) - 1
KR1_RUN, KR1_TILE = 16, 4096  # csrc/rolling.cu: windows a thread, a block


# -- wyrand (public wyhash v4 recipe; vendored aesctr/wy.h is an empty
# submodule in the reference checkout, so parity is best-effort) ------------
def _wyrand_stream(seed: int, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.uint64)
    state = seed & U64_MAX
    for i in range(n):
        state = (state + 0xA0761D6478BD642F) & U64_MAX
        t = (state ^ 0xE7037ED1A0B428DB) * state
        out[i] = ((t >> 64) ^ t) & U64_MAX
    return out


def character_table(seed1: int, seed2: int, n_chars: int = 4) -> np.ndarray:
    """CharacterHash over the code alphabet: T[c] = wyrand value
    (characterhash.h:85-103 with maxval = 2^64-1)."""
    return _wyrand_stream((seed1 ^ seed2) & U64_MAX, n_chars)


# ntHash v1 per-base seed values (Mohamadi et al. 2016, published in the
# ntHash repository); ntHash's rc stream hashes the complement bases with
# the SAME table, unlike the two-table RollingHasher.
NTHASH_SEEDS = np.array(
    [
        0x3C8BFBB395C60474,  # A
        0x3193C18562A02B4C,  # C
        0x20323ED082572324,  # G
        0x295549F54BE24456,  # T
    ],
    dtype=np.uint64,
)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    r %= 64
    return x if r == 0 else (x << r) | shr(x, 64 - r)


def _table(table, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(table, dtype=np.uint64).view(
        np.int64)).to(dev)


def _padded(table: torch.Tensor) -> torch.Tensor:
    """``table`` with zeros up to 128 entries: an int8 code at or past its
    length reads 0, as in the kernel."""
    n = table.numel()
    return table if n >= 128 else torch.cat([table, table.new_zeros(128 - n)])


def cyclic_hashes_plain(codes: torch.Tensor, k: int, table_f: torch.Tensor,
                        table_r: Optional[torch.Tensor] = None):
    """Plain torch KR1: (B, L) int8 codes, k <= L, int64-held u64 tables
    -> (values (B, P) int64, invalid (B, P) bool), P = L - k + 1: the
    forward hash, or with ``table_r`` (4 entries) the unsigned minimum of
    it and the reverse-complement hash (``buzhash`` :91, ``buzhash_rc``
    :116).  A code at or past the table's length reads 0."""
    P = codes.shape[-1] - k + 1
    if P <= 0:
        raise ValueError(f"k={k} > length {codes.shape[-1]}")
    if table_r is not None and table_r.numel() != 4:
        raise ValueError(f"{table_r.numel()} characters: the reverse "
                         "complement takes 4")
    tf = _padded(table_f)
    tr = None if table_r is None else _padded(table_r)
    h = hr = invalid = None
    for j in range(k):
        sl = codes[..., j:j + P]
        bad = sl < 0
        c = torch.where(bad, 0, sl).to(torch.int64)
        v = _rotl(tf, k - 1 - j)[c]
        h = v if h is None else h ^ v
        invalid = bad if invalid is None else invalid | bad
        if tr is not None:  # a code past 3 complements to a zero entry
            v = _rotl(tr, j)[torch.where(bad, 0, torch.where(c > 3, 127,
                                                             3 - c))]
            hr = v if hr is None else hr ^ v
    if tr is not None:
        h = torch.where((hr ^ SIGN) < (h ^ SIGN), hr, h)
    return h, invalid


def cyclic_hashes(codes: torch.Tensor, k: int, table_f: torch.Tensor,
                  table_r: Optional[torch.Tensor] = None):
    """KR1 (``csrc/rolling.cu``): see ``cyclic_hashes_plain``, which
    serves CPU tensors."""
    if codes.device.type == "cpu":
        return cyclic_hashes_plain(codes, k, table_f, table_r)
    if codes.device.type != "cuda":
        raise ValueError(f"cyclic_hashes: no kernel for device {codes.device}")
    dev = codes.device
    if codes.dim() != 2:
        raise ValueError(f"codes: shape {tuple(codes.shape)}, expected (B, L)")
    kernels.check(codes, "codes", torch.int8, dev)
    n = table_f.numel()
    kernels.check(table_f, "table_f", torch.int64, dev, (n,))
    if table_r is not None:
        kernels.check(table_r, "table_r", torch.int64, dev, (n,))
        if n != 4:
            raise ValueError(f"{n} characters: the reverse complement takes 4")
    if not 1 <= n <= 256:
        raise ValueError(f"{n} characters: the kernel takes 1..256")
    B, L = codes.shape
    P = L - k + 1
    if k < 1 or P <= 0:
        raise ValueError(f"k={k} > length {L}")
    if B > 65535:
        raise ValueError(f"{B} rows: the kernel's grid takes at most 65535")
    values = torch.empty((B, P), dtype=torch.int64, device=dev)
    invalid = torch.empty((B, P), dtype=torch.bool, device=dev)
    if B:
        kernels.launch("bk_cyclic_hashes", dev, codes.data_ptr(), B, L, k,
                       table_f.data_ptr(), kernels.ptr(table_r), n,
                       values.data_ptr(), invalid.data_ptr())
        cyclic_hashes.launches += 1
    return values, invalid


cyclic_hashes.launches = 0


class RollingEncoder:
    """Batched RollingHasher: cyclic hashes of every k-window, canonical
    min(fwd, rc) with ``canon``.

    seeds default to the reference's (1337, 137) forward and
    (1337*137, 1337^137) reverse (encoder.h:672-684)."""

    def __init__(self, k: int, canon: bool = False, window: int = -1,
                 seed1: int = 1337, seed2: int = 137, n_chars: int = 4,
                 nthash: bool = False):
        self.k = k
        self.canon = canon
        self.w = window if window and window > k else -1
        if canon and n_chars != 4:
            # the JAX package indexes its table at 3 - c < 0 there
            raise ValueError(f"canon with n_chars={n_chars}: the reverse "
                             "complement is DNA's (4 characters)")
        if nthash:
            # ntHash NTC64 (encoder.h for_each_hash backend): fixed published
            # seeds; the rc stream uses the same table over complement bases
            if n_chars != 4:
                raise ValueError("nthash mode is DNA-only")
            self.table_f = NTHASH_SEEDS
            self.table_r = NTHASH_SEEDS
        else:
            self.table_f = character_table(seed1, seed2, n_chars)
            self.table_r = character_table(
                (seed1 * seed2) & U64_MAX, seed1 ^ seed2, n_chars
            )
        self._dev = {}

    def tables(self, dev):
        """(table_f, table_r or None) on ``dev``, made once."""
        key = torch.device(dev)
        if key not in self._dev:
            self._dev[key] = (_table(self.table_f, key),
                              _table(self.table_r, key) if self.canon
                              else None)
        return self._dev[key]

    def hashes(self, codes: torch.Tensor):
        """(values (B, P), invalid) — canonical if self.canon."""
        return cyclic_hashes(codes, self.k, *self.tables(codes.device))

    def emissions(self, codes: torch.Tensor,
                  lengths: torch.Tensor) -> Emissions:
        """(values, mask) of each row (``RollingEncoder.emissions`` of the
        JAX package): unwindowed, every window's hash, valid where it lies
        inside the row's length and holds no ambiguous code; with a
        window of w > k bases, W = w - k + 1 hashes, the compacted
        discipline over the valid hashes scored by frev64 (the trailing
        partial window in column 0, U64_MAX there when not emitted).
        W <= 8192 on the card."""
        vals, invalid = self.hashes(codes)
        valid = position_validity(lengths, vals.shape[-1], self.k) & ~invalid
        if self.w <= 0:
            return Emissions(vals, valid)
        return compacted_stream(vals, valid, self.w - self.k + 1)


class MultiKRollingEncoder:
    """RollingHasherSet: a ladder of k values hashed in one pass
    (encoder.h:867-1003).  Seeds are drawn from std::mt19937_64(seedseed)
    pairs, reproduced exactly."""

    def __init__(self, ks: Sequence[int], canon: bool = False,
                 seedseed: int = 1337, n_chars: int = 4, nthash: bool = False):
        self.ks = list(ks)
        mt = _MT19937_64(seedseed)
        self.encoders: List[RollingEncoder] = []
        for k in self.ks:
            s1 = mt.next()
            s2 = mt.next()
            self.encoders.append(
                RollingEncoder(k, canon, -1, s1, s2, n_chars, nthash=nthash)
            )

    def hashes(self, codes: torch.Tensor, lengths: torch.Tensor):
        """[(values, valid)] per k."""
        out = []
        for enc in self.encoders:
            vals, invalid = enc.hashes(codes)
            inb = position_validity(lengths, vals.shape[-1], enc.k)
            out.append((vals, inb & ~invalid))
        return out


class _MT19937_64:
    """std::mt19937_64, for RollingHasherSet seed parity
    (encoder.h:871-874)."""

    def __init__(self, seed: int):
        self.mt = [0] * 312
        self.idx = 312
        self.mt[0] = seed & U64_MAX
        for i in range(1, 312):
            self.mt[i] = (
                6364136223846793005 * (self.mt[i - 1] ^ (self.mt[i - 1] >> 62))
                + i
            ) & U64_MAX

    def _generate(self):
        mt = self.mt
        LM = (1 << 31) - 1
        UM = U64_MAX ^ LM
        for i in range(312):
            x = (mt[i] & UM) | (mt[(i + 1) % 312] & LM)
            xa = x >> 1
            if x & 1:
                xa ^= 0xB5026F5AA96619E9
            mt[i] = mt[(i + 156) % 312] ^ xa
        self.idx = 0

    def next(self) -> int:
        if self.idx >= 312:
            self._generate()
        x = self.mt[self.idx]
        self.idx += 1
        x ^= (x >> 29) & 0x5555555555555555
        x ^= (x << 17) & 0x71D67FFFEDA60000
        x ^= (x << 37) & 0xFFF7EEE000000000
        x ^= x >> 43
        return x
