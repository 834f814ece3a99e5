"""Batched encoder facade: the contiguous lex disciplines.

Counterpart of ``bonsai_tpu/core/encoder.py`` ``BatchEncoder.emissions``
on two branches:

* unwindowed (encoder.py:141-153), the one ``classify`` runs (w = k,
  bin/bonsai.cpp:152): encode every window, drop windows that hold an N
  or run past the read, canonicalize or not;
* canonical windowed with scheme ``lex`` (:174-184): every in-length
  position is pushed, an N window pushes canonical(OVERFLOW) == 0 (a real
  key, not a pad), the score is ``frev64`` of the canonical k-mer, and
  slot j emits the (score, kmer) minimum of positions [j, j + W - 1]
  iff j + W <= max(len - (k - 1), 0).

``minimizers`` is the wrapper of the CUDA kernel KB1
(``csrc/minimizers.cu``) that computes both; ``minimizers_plain`` is its
plain torch version, which serves CPU tensors.  The uncanonical windowed,
spaced, entropy and hash disciplines and non-DNA input raise
``NotImplementedError`` (ROADMAP queue A, item 8).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from . import encode
from .alphabet import InputType
from .bitops import canonical
from .hashes import frev64
from .minimize import positional_minimizers
from .spacer import Spacer

MAX_W = 8192  # KB1 stages a tile's W - 1 halo of scores in shared memory


class Emissions(NamedTuple):
    values: torch.Tensor  # (B, E) int64-held u64
    mask: torch.Tensor  # (B, E) bool


def _empty(codes: torch.Tensor) -> Emissions:
    B = codes.shape[0]
    return Emissions(
        torch.zeros((B, 0), dtype=torch.int64, device=codes.device),
        torch.zeros((B, 0), dtype=torch.bool, device=codes.device),
    )


def minimizers_plain(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                     W: int, canon: bool) -> Emissions:
    """Plain torch KB1: (B, L) int8 codes (-1 = N or pad), (B,) lengths ->
    (B, E) emissions, E = L - k - W + 2.  W = 1 is the unwindowed
    discipline; W > 1 needs ``canon``."""
    if codes.shape[-1] < k:
        return _empty(codes)
    kmers, invalid = encode.pack_kmers(codes, k)
    kmers = encode.apply_mask(kmers, k, InputType.DNA)
    P = kmers.shape[-1]
    if W == 1:
        valid = encode.position_validity(lengths, P, k) & ~invalid
        return Emissions(canonical(kmers, k) if canon else kmers, valid)
    if not canon:
        raise NotImplementedError(
            "uncanonical windowed minimizers are not ported "
            "(ROADMAP queue A, item 8)")
    ck = torch.where(invalid, 0, canonical(kmers, k))
    if P < W:
        return _empty(codes)
    n_push = torch.clamp(lengths.to(torch.int64) - (k - 1), min=0)
    return Emissions(*positional_minimizers(frev64(ck), ck, W, n_push))


def minimizers(codes: torch.Tensor, lengths: torch.Tensor, k: int, W: int,
               canon: bool) -> Emissions:
    """KB1 (``csrc/minimizers.cu``): see ``minimizers_plain``, which serves
    CPU tensors.  codes (B, L) int8, lengths (B,) int32 -> values (B, E)
    int64 and an ``emitted`` mask (B, E) bool; a value is never a
    sentinel (at k = 32 a real k-mer can be U64_MAX)."""
    if codes.device.type == "cpu":
        return minimizers_plain(codes, lengths, k, W, canon)
    if codes.device.type != "cuda":
        raise ValueError(f"minimizers: no kernel for device {codes.device}")
    dev = codes.device
    if codes.dim() != 2:
        raise ValueError(f"codes: shape {tuple(codes.shape)}, expected (B, L)")
    B, L = codes.shape
    kernels.check(codes, "codes", torch.int8, dev)
    kernels.check(lengths, "lengths", torch.int32, dev, (B,))
    if not 1 <= k <= 32:
        raise ValueError(f"k={k}: the kernel takes 1 <= k <= 32")
    if not 1 <= W <= MAX_W:
        raise ValueError(f"window of {W} k-mers: the kernel takes 1..{MAX_W}")
    if B > 65535:
        raise ValueError(f"{B} rows: the kernel's grid takes at most 65535")
    if W > 1 and not canon:
        raise NotImplementedError(
            "uncanonical windowed minimizers are not ported "
            "(ROADMAP queue A, item 8)")
    E = L - k - W + 2
    if E <= 0 or B == 0:
        return _empty(codes)
    keys = torch.empty((B, E), dtype=torch.int64, device=dev)
    emitted = torch.empty((B, E), dtype=torch.bool, device=dev)
    kernels.launch("bk_minimizers", dev, codes.data_ptr(), lengths.data_ptr(),
                   B, L, k, W, int(canon), keys.data_ptr(), emitted.data_ptr())
    minimizers.launches += 1
    return Emissions(keys, emitted)


minimizers.launches = 0


class BatchEncoder:
    def __init__(self, spacer: Spacer, canonicalize: bool = True,
                 scheme: str = "lex",
                 input_type: InputType = InputType.DNA):
        if scheme != "lex":
            raise NotImplementedError(
                f"scheme {scheme!r}: only the lex disciplines are ported "
                "(ROADMAP queue A, item 8)"
            )
        if not spacer.unspaced():
            raise NotImplementedError(
                f"{spacer!r}: spaced seeds are not ported "
                "(ROADMAP queue A, item 8)"
            )
        if InputType(input_type) != InputType.DNA:
            raise NotImplementedError(
                f"input type {InputType(input_type).name}: only DNA is ported "
                "(ROADMAP queue A, item 8)"
            )
        if not canonicalize and not spacer.unwindowed():
            raise NotImplementedError(
                f"{spacer!r} without canonicalization: the uncanonical "
                "windowed discipline is not ported (ROADMAP queue A, item 8)"
            )
        self.sp = spacer
        self.it = InputType(input_type)
        self.canon = bool(canonicalize)

    def emissions(self, codes: torch.Tensor, lengths: torch.Tensor) -> Emissions:
        """codes: (B, L) int8 (pad with -1); lengths: (B,) int32."""
        return minimizers(codes, lengths, self.sp.k, self.sp.window_kmers,
                          self.canon)
