"""128-bit k-mers for 32 < k <= 64, as (hi, lo) pairs of int64-held u64
lanes: hi holds the k - 32 leftmost bases, lo the 32 others.

Counterpart of ``bonsai_tpu/core/encode128.py`` (``pack_kmers128`` :25,
``_rc64`` :56, ``reverse_complement128`` :72, ``canonical128`` :92,
``to_python_int`` :101; the reference's u128 Encoder, encoder.h:113).
``pack_kmers128`` is the wrapper of the CUDA kernel K128's pack entry
(``csrc/encode128.cu``), which rolls each 128-bit k-mer across a
thread's run and may take its canonical form in the same pass;
``reverse_complement128`` and ``canonical128`` are wrappers of its
elementwise entry on given pairs.  The ``*_plain`` versions compute what
the JAX package computes and serve CPU tensors:

* a code below 0 packs as 0 and makes its windows invalid; the codes are
  or-ed into place, lo's bits past 63 dropped (as numpy's u64 shifts
  drop them), hi unmasked;
* the reverse complement takes every bit of lo and the low 2(k - 32) of
  hi; at k = 64 the shift by 64 of the JAX formula gives 0 (numpy's,
  jnp's and torch's CPU shifts all do);
* the canonical pair is the unsigned 128-bit minimum of the pair and its
  reverse complement (bit 63 of each lane flipped before a signed
  compare).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from .bitops import SIGN, U64_MAX, shr

_M = (0x3333333333333333, 0x0F0F0F0F0F0F0F0F, 0x00FF00FF00FF00FF,
      0x0000FFFF0000FFFF)
RC_MODES = {"rc": 0, "canonical": 1}


def _check_k(k: int) -> int:
    if not 32 < k <= 64:
        raise ValueError("pack_kmers128 requires 32 < k <= 64")
    return k - 32


def _lane_mask(k_hi: int) -> int:
    return -1 if k_hi == 32 else (1 << (2 * k_hi)) - 1


def pack_kmers128_plain(codes: torch.Tensor, k: int,
                        canon: bool = False) -> Tuple[torch.Tensor, ...]:
    """Plain torch K128 pack: (..., L) int8 codes -> (hi (..., P), lo,
    invalid), P = L - k + 1, int64 lanes; with ``canon`` the canonical
    pair (``canonical128_plain``) in place of the packed one."""
    k_hi = _check_k(k)
    L = codes.shape[-1]
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"k={k} > length {L}")
    bad = codes < 0
    c = torch.where(bad, 0, codes).to(torch.int64)
    hi = torch.zeros(codes.shape[:-1] + (P,), dtype=torch.int64,
                     device=codes.device)
    lo = torch.zeros_like(hi)
    invalid = torch.zeros(hi.shape, dtype=torch.bool, device=codes.device)
    for j in range(k):
        sl = c[..., j:j + P]
        if j < k_hi:
            hi = hi | (sl << (2 * (k_hi - 1 - j)))
        else:
            lo = lo | (sl << (2 * (k - 1 - j)))
        invalid = invalid | bad[..., j:j + P]
    if canon:
        hi, lo = canonical128_plain(hi, lo, k)
    return hi, lo, invalid


def _rc64(x: torch.Tensor, nbases: int) -> torch.Tensor:
    """Bit-parallel reverse complement of ``nbases`` 2-bit codes at the
    low end of a u64 lane (kmerutil.h:83-90)."""
    x = ~x
    for s, m in zip((2, 4, 8, 16), _M):
        x = (shr(x, s) & m) | ((x & m) << s)
    x = shr(x, 32) | (x << 32)
    return shr(x, 64 - 2 * nbases)


def reverse_complement128_plain(hi: torch.Tensor, lo: torch.Tensor, k: int):
    """Plain torch K128 rc: (hi, lo) -> the reverse complement pair."""
    k_hi = _check_k(k)
    rlo = _rc64(lo, 32)
    rhi = _rc64(hi, k_hi)
    new_hi = shr(rlo, 64 - 2 * k_hi)
    new_lo = rhi if k_hi == 32 else (rlo << (2 * k_hi)) | rhi
    return new_hi & _lane_mask(k_hi), new_lo


def canonical128_plain(hi: torch.Tensor, lo: torch.Tensor, k: int):
    """Plain torch K128 canonical: the unsigned (hi, lo)-ordered minimum
    of each pair and its reverse complement."""
    rhi, rlo = reverse_complement128_plain(hi, lo, k)
    take_rc = ((rhi ^ SIGN) < (hi ^ SIGN)) | (
        (rhi == hi) & ((rlo ^ SIGN) < (lo ^ SIGN)))
    return torch.where(take_rc, rhi, hi), torch.where(take_rc, rlo, lo)


def pack_kmers128(codes: torch.Tensor, k: int,
                  canon: bool = False) -> Tuple[torch.Tensor, ...]:
    """K128 pack (``csrc/encode128.cu``): see ``pack_kmers128_plain``,
    which serves CPU tensors.  codes (..., L) int8, contiguous."""
    if codes.device.type == "cpu":
        return pack_kmers128_plain(codes, k, canon)
    if codes.device.type != "cuda":
        raise ValueError(f"pack_kmers128: no kernel for device {codes.device}")
    _check_k(k)
    dev = codes.device
    kernels.check(codes, "codes", torch.int8, dev)
    if codes.dim() < 1:
        raise ValueError("codes: expected (..., L)")
    L = codes.shape[-1]
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"k={k} > length {L}")
    lead = codes.shape[:-1]
    B = codes.numel() // L
    if B > 65535:
        raise ValueError(f"{B} rows: the kernel's grid takes at most 65535")
    hi = torch.empty(lead + (P,), dtype=torch.int64, device=dev)
    lo = torch.empty_like(hi)
    invalid = torch.empty(hi.shape, dtype=torch.bool, device=dev)
    if B:
        kernels.launch("bk_pack_kmers128", dev, codes.data_ptr(), B, L, k,
                       int(canon), hi.data_ptr(), lo.data_ptr(),
                       invalid.data_ptr())
        pack_kmers128.launches += 1
    return hi, lo, invalid


pack_kmers128.launches = 0


def rc128(hi: torch.Tensor, lo: torch.Tensor, k: int, mode: str):
    """K128's elementwise entry (``bk_rc128``) in ``mode`` ("rc" or
    "canonical") on int64 pairs of one shape on the card; counted by mode
    in ``rc128.variants``."""
    _check_k(k)
    dev = hi.device
    kernels.check(hi, "hi", torch.int64, dev)
    kernels.check(lo, "lo", torch.int64, dev, hi.shape)
    out_hi, out_lo = torch.empty_like(hi), torch.empty_like(lo)
    if hi.numel():
        kernels.launch("bk_rc128", dev, hi.data_ptr(), lo.data_ptr(),
                       hi.numel(), k, RC_MODES[mode], out_hi.data_ptr(),
                       out_lo.data_ptr())
        rc128.launches += 1
        rc128.variants[mode] = rc128.variants.get(mode, 0) + 1
    return out_hi, out_lo


rc128.launches = 0
rc128.variants = {}


def _pairwise(hi, lo, k, mode, plain):
    if hi.device.type == "cpu":
        return plain(hi, lo, k)
    if hi.device.type != "cuda":
        raise ValueError(f"{mode}: no kernel for device {hi.device}")
    return rc128(hi, lo, k, mode)


def reverse_complement128(hi: torch.Tensor, lo: torch.Tensor, k: int):
    """K128 rc (``bk_rc128``): see ``reverse_complement128_plain``, which
    serves CPU tensors."""
    return _pairwise(hi, lo, k, "rc", reverse_complement128_plain)


def canonical128(hi: torch.Tensor, lo: torch.Tensor, k: int):
    """K128 canonical (``bk_rc128``): see ``canonical128_plain``, which
    serves CPU tensors."""
    return _pairwise(hi, lo, k, "canonical", canonical128_plain)


def to_python_int(hi, lo) -> int:
    """The k-mer of one (hi, lo) pair as a Python int."""
    return ((int(hi) & U64_MAX) << 64) | (int(lo) & U64_MAX)
