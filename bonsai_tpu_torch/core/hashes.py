"""64-bit mixers on torch ``int64`` tensors: splitmix64 (the table's
bucket hash) and frev64 (the Lex minimizer score).

Counterpart of ``bonsai_tpu/core/hashes.py`` (``rotl64`` :34, ``frev64``
:39, ``splitmix64`` :84); u64 bits are carried in int64 (see
``core/bitops.py``): multiplications wrap mod 2^64 on both, right shifts
are made logical.  The other mixers of that module (wang_hash, khash)
serve sketches and formats that are not ported yet.
"""

from __future__ import annotations

import torch

from .bitops import i64, shr

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
