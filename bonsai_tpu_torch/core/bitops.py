"""64-bit k-mer bit operations on torch ``int64`` tensors.

Counterpart of ``bonsai_tpu/core/bitops.py`` (reference kmerutil.h:83-146).
``torch.uint64`` has almost no operators, so an unsigned 64-bit value is
carried in an ``int64`` tensor with the same bits:

* addition, multiplication, left shifts, ``&``, ``|``, ``^`` and ``~`` are
  the same on both;
* a right shift must be made logical (``shr``): the arithmetic shift
  copies bit 63 into the vacated high bits;
* an unsigned order flips bit 63 before the signed compare (``umin``).

``popcount64`` and ``nuccount`` (bitops.py:60,69 there) are wrappers of
the CUDA kernel KS4 (``csrc/bitmix.cu``, one elementwise pass, which
``core/hashes.py``'s mixes, inverse mixes and rotates share through
``bitmix``); their plain torch versions serve CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

U64_MAX = (1 << 64) - 1
SIGN = -(1 << 63)  # bit 63 as an int64 constant

_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF


def i64(c: int) -> int:
    """The int64 constant with the bits of the u64 constant ``c``."""
    c &= U64_MAX
    return c - (1 << 64) if c >> 63 else c


def as_keys(values, device) -> torch.Tensor:
    """u64 values (numpy, a sequence or an int64 tensor) as a contiguous
    int64 tensor on ``device``.  A writable contiguous array is shared, not
    copied; a read-only one (``np.frombuffer``) is copied, since
    ``torch.from_numpy`` warns on it."""
    if isinstance(values, torch.Tensor):
        if values.dtype != torch.int64:
            raise TypeError(f"values: dtype {values.dtype}, expected int64")
        return values.reshape(-1).contiguous().to(device)
    a = np.ascontiguousarray(np.asarray(values, dtype=np.uint64).ravel())
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int64)).to(device)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64, 0 <= s < 64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit minimum of int64-held values."""
    return torch.where((a ^ SIGN) < (b ^ SIGN), a, b)


def reverse_complement(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of a 2-bit packed DNA k-mer (kmerutil.h:83-90),
    bit for bit, including ENCODE_OVERFLOW (all ones) -> 0."""
    x = kmer
    x = shr(x, 2) & _M2 | ((x & _M2) << 2)
    x = shr(x, 4) & _M4 | ((x & _M4) << 4)
    x = shr(x, 8) & _M8 | ((x & _M8) << 8)
    x = shr(x, 16) & _M16 | ((x & _M16) << 16)
    x = shr(x, 32) | (x << 32)
    # U64_MAX - x == ~x
    return shr(~x, 64 - (k << 1))


def canonical(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """Unsigned min(kmer, revcomp(kmer)) (kmerutil.h:137-140)."""
    return umin(kmer, reverse_complement(kmer, k))


def kmer_mask_bits(k: int) -> int:
    """(1 << 2k) - 1 as a python int (full mask for k == 32)."""
    return U64_MAX if k >= 32 else (1 << (2 * k)) - 1


# KS4's modes (csrc/bitmix.cu)
BITMIX_MODES = {"wang_hash": 0, "khash_int64_hash": 1, "popcount64": 2,
                "frev64_inv": 4, "wang_hash_inv": 5, "rotl": 6}


def bitmix(x: torch.Tensor, mode: str, plain, param: int = 0) -> torch.Tensor:
    """KS4 in ``mode`` on an int64 tensor of any shape, or ``plain(x)`` for
    a CPU tensor; ``param`` is the rotate's r (0 <= r < 64)."""
    if x.device.type == "cpu":
        return plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"{mode}: no kernel for device {x.device}")
    kernels.check(x, "x", torch.int64, x.device)
    out = torch.empty_like(x)
    if x.numel():
        if mode == "rotl":  # the one mode with a parameter: its own entry
            kernels.launch("bk_rotl", x.device, x.data_ptr(), x.numel(),
                           param, out.data_ptr())
        else:
            kernels.launch("bk_bitmix", x.device, x.data_ptr(), x.numel(),
                           BITMIX_MODES[mode], out.data_ptr())
        bitmix.launches += 1
        bitmix.variants[mode] = bitmix.variants.get(mode, 0) + 1
    return out


bitmix.launches = 0
bitmix.variants = {}


def popcount64_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch KS4 ``popcount64``: the branch-free popcount of
    popcnt.h on int64-held u64 lanes."""
    x = x - (shr(x, 1) & 0x5555555555555555)
    x = (x & _M2) + (shr(x, 2) & _M2)
    x = (x + shr(x, 4)) & _M4
    return shr(x * 0x0101010101010101, 56)


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """KS4 (``csrc/bitmix.cu``): see ``popcount64_plain``, which serves CPU
    tensors."""
    return bitmix(x, "popcount64", popcount64_plain)


# the reference's c_table: code c matches where both bits of kmer ^ c0
# are set (A: all ones, C: 0xaa.., G: 0x55.., T: 0)
_NUC_CMP = (-1, i64(0xAAAAAAAAAAAAAAAA), 0x5555555555555555, 0)


def nuccount_plain(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """Plain torch KS4 ``nuccount``: (...,) packed 2-bit k-mers ->
    (..., 4) int64 counts of codes A, C, G, T (kmerutil.h:93-135)."""
    mask = i64(kmer_mask_bits(k))
    out = []
    for c0 in _NUC_CMP:
        x0 = kmer ^ c0
        out.append(popcount64_plain(x0 & (shr(x0, 1) & 0x5555555555555555)
                                    & mask))
    return torch.stack(out, dim=-1)


def nuccount(kmer: torch.Tensor, k: int) -> torch.Tensor:
    """KS4's nuccount entry (``csrc/bitmix.cu``): see ``nuccount_plain``,
    which serves CPU tensors."""
    if not 1 <= k <= 32:
        raise ValueError(f"k={k}: a packed 2-bit k-mer has 1 <= k <= 32")
    if kmer.device.type == "cpu":
        return nuccount_plain(kmer, k)
    if kmer.device.type != "cuda":
        raise ValueError(f"nuccount: no kernel for device {kmer.device}")
    kernels.check(kmer, "kmer", torch.int64, kmer.device)
    out = torch.empty(kmer.shape + (4,), dtype=torch.int64,
                      device=kmer.device)
    if kmer.numel():
        kernels.launch("bk_nuccount", kmer.device, kmer.data_ptr(),
                       kmer.numel(), kmer_mask_bits(k), out.data_ptr())
        nuccount.launches += 1
    return out


nuccount.launches = 0
