"""64-bit mixers on torch ``int64`` tensors: splitmix64 (the table's
bucket hash), frev64 (the Lex minimizer score), wang_hash (the
HyperLogLog's hash), khash_int64_hash (klib's), the inverses of frev64
and wang_hash, and 64-bit rotates; and two host string hashes.

Counterpart of ``bonsai_tpu/core/hashes.py`` (``rotl64`` :34, ``frev64``
:39, ``frev64_inv`` :48, ``wang_hash`` :58, ``khash_int64_hash`` :75,
``splitmix64`` :84, ``wang_hash_inv`` :96, ``lrot`` :123, ``rrot`` :128,
``dbm_hash`` :133, ``x31_hash`` :141); u64 bits are carried in int64 (see
``core/bitops.py``): multiplications wrap mod 2^64 on both, right shifts
are made logical.  ``wang_hash``, ``khash_int64_hash``, ``frev64_inv``,
``wang_hash_inv`` and ``rotl`` (which ``lrot`` and ``rrot`` call) are
wrappers of the CUDA kernel KS4 (``csrc/bitmix.cu``); their plain torch
versions serve CPU tensors.  No path of either package calls the
inverses or the rotates: they are library functions.
"""

from __future__ import annotations

import operator

import torch

from .bitops import bitmix, i64, shr

_SM_ADD = i64(0x9E3779B97F4A7C15)
_SM_M1 = i64(0xBF58476D1CE4E5B9)
_SM_M2 = i64(0x94D049BB133111EB)
_FREV_X1 = i64(0x533F8C2151B20F97)
_FREV_MUL = i64(0x9A98567ED20C127D)
_FREV_X2 = i64(0x691A9D706391077A)
_FREV_INV = i64(pow(0x9A98567ED20C127D, -1, 1 << 64))
_WANG_INV1 = i64(14933078535860113213)
_WANG_INV2 = i64(15244667743933553977)


def rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int64-held u64 bits left by ``r`` (0 < r < 64)."""
    return (x << r) | shr(x, 64 - r)


def frev64(x: torch.Tensor) -> torch.Tensor:
    """Lex minimizer score (bijective), encoder.h:47,59-60: xor, multiply
    mod 2^64, rotate left 31, xor."""
    x = (x ^ _FREV_X1) * _FREV_MUL
    return rotl64(x, 31) ^ _FREV_X2


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """Bijective 64-bit mix of int64-held u64 values (wrapping arithmetic)."""
    x = x + _SM_ADD
    x = (x ^ shr(x, 30)) * _SM_M1
    x = (x ^ shr(x, 27)) * _SM_M2
    return x ^ shr(x, 31)


def wang_hash_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch KS4 ``wang_hash``: Thomas Wang's 64-bit mix
    (hash.h:32-41) of int64-held u64 values."""
    x = ~x + (x << 21)
    x = x ^ shr(x, 24)
    x = x * 265
    x = x ^ shr(x, 14)
    x = x * 21
    x = x ^ shr(x, 28)
    return x + (x << 31)


def khash_int64_hash_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch KS4 ``khash_int64_hash``: klib's int64 hash truncated
    to u32 (khash64.h:425), in the low half of an int64."""
    return (shr(x, 33) ^ x ^ (x << 11)) & 0xFFFFFFFF


def wang_hash(x: torch.Tensor) -> torch.Tensor:
    """KS4 (``csrc/bitmix.cu``): see ``wang_hash_plain``, which serves CPU
    tensors."""
    return bitmix(x, "wang_hash", wang_hash_plain)


def khash_int64_hash(x: torch.Tensor) -> torch.Tensor:
    """KS4 (``csrc/bitmix.cu``): see ``khash_int64_hash_plain``, which
    serves CPU tensors."""
    return bitmix(x, "khash_int64_hash", khash_int64_hash_plain)


def frev64_inv_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch KS4 ``frev64_inv``: the inverse of ``frev64`` (xor,
    rotate right by 31, multiply by the inverse of the odd constant mod
    2^64, xor)."""
    x = rotl64(x ^ _FREV_X2, 33) * _FREV_INV
    return x ^ _FREV_X1


def wang_hash_inv_plain(key: torch.Tensor) -> torch.Tensor:
    """Plain torch KS4 ``wang_hash_inv``: the inverse of ``wang_hash``
    (irving_inv_hash, hash.h:94-120)."""
    tmp = key - (key << 31)
    key = key - (tmp << 31)
    tmp = key ^ shr(key, 28)
    key = key ^ shr(tmp, 28)
    key = key * _WANG_INV1
    tmp = key ^ shr(key, 14)
    tmp = key ^ shr(tmp, 14)
    tmp = key ^ shr(tmp, 14)
    key = key ^ shr(tmp, 14)
    key = key * _WANG_INV2
    tmp = key ^ shr(key, 24)
    key = key ^ shr(tmp, 24)
    tmp = ~key
    tmp = ~(key - (tmp << 21))
    tmp = ~(key - (tmp << 21))
    return ~(key - (tmp << 21))


def rotl_plain(x: torch.Tensor, r: int) -> torch.Tensor:
    """Plain torch KS4 ``rotl``: int64-held u64 bits rotated left by ``r``
    (0 <= r < 64; 0 returns ``x``)."""
    return x if r == 0 else rotl64(x, r)


def frev64_inv(x: torch.Tensor) -> torch.Tensor:
    """KS4 (``csrc/bitmix.cu``): see ``frev64_inv_plain``, which serves
    CPU tensors."""
    return bitmix(x, "frev64_inv", frev64_inv_plain)


def wang_hash_inv(x: torch.Tensor) -> torch.Tensor:
    """KS4 (``csrc/bitmix.cu``): see ``wang_hash_inv_plain``, which serves
    CPU tensors."""
    return bitmix(x, "wang_hash_inv", wang_hash_inv_plain)


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """KS4's rotate (``csrc/bitmix.cu``): see ``rotl_plain``, which serves
    CPU tensors; 0 <= r < 64."""
    r = operator.index(r)
    if not 0 <= r < 64:
        raise ValueError(f"rotl: r={r}, 0 <= r < 64 expected")
    return bitmix(x, "rotl", lambda t: rotl_plain(t, r), r)


def lrot(x: torch.Tensor, r: int) -> torch.Tensor:
    """Left bit rotate (hash.h lrot) by 0 <= r <= 64; 0 and 64 return
    ``x``.  Another r raises ValueError (the JAX package's numpy shift
    raises OverflowError there)."""
    r = operator.index(r)
    if not 0 <= r <= 64:
        raise ValueError(f"lrot: r={r}, 0 <= r <= 64 expected")
    return rotl(x, r % 64)


def rrot(x: torch.Tensor, r: int) -> torch.Tensor:
    """Right bit rotate (hash.h rrot) by any integer r: the left rotate
    by (64 - r) mod 64, so rrot(x, 65) == rrot(x, 1)."""
    return rotl(x, (64 - operator.index(r)) % 64)


def dbm_hash(s: bytes) -> int:
    """sdbm string hash (hash.h dbm_hash), on the host: a u64 as an int."""
    h = 0
    for ch in s:
        h = (ch + (h << 6) + (h << 16) - h) & ((1 << 64) - 1)
    return h


def x31_hash(s: bytes) -> int:
    """khash X31 string hash (hash.h:123-128), on the host: a u32 as an
    int."""
    h = 0
    for ch in s:
        h = ((h << 5) - h + ch) & 0xFFFFFFFF
    return h
