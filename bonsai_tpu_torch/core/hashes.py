"""64-bit mixers on torch ``int64`` tensors: splitmix64 (the table's
bucket hash), frev64 (the Lex minimizer score), wang_hash (the
HyperLogLog's hash) and khash_int64_hash (klib's).

Counterpart of ``bonsai_tpu/core/hashes.py`` (``rotl64`` :34, ``frev64``
:39, ``wang_hash`` :58, ``khash_int64_hash`` :75, ``splitmix64`` :84);
u64 bits are carried in int64 (see ``core/bitops.py``): multiplications
wrap mod 2^64 on both, right shifts are made logical.  ``wang_hash`` and
``khash_int64_hash`` are wrappers of the CUDA kernel KS4
(``csrc/bitmix.cu``); their plain torch versions serve CPU tensors.
"""

from __future__ import annotations

import torch

from .bitops import bitmix, i64, shr

_SM_ADD = i64(0x9E3779B97F4A7C15)
_SM_M1 = i64(0xBF58476D1CE4E5B9)
_SM_M2 = i64(0x94D049BB133111EB)
_FREV_X1 = i64(0x533F8C2151B20F97)
_FREV_MUL = i64(0x9A98567ED20C127D)
_FREV_X2 = i64(0x691A9D706391077A)


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
