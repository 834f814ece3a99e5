"""DNA k-mer packing: int8 codes -> int64-held u64 k-mers.

Counterpart of ``bonsai_tpu/core/encode.py`` for 2-bit DNA
(``pack_kmers``, ``pack_spaced_kmers`` and ``_pack`` :50-137,
``position_validity``, ``apply_mask``): the codes at a seed's k included
positions fold high-first, so the first base lands in the highest used
bits (encoder.h:547), and a seed holding an ambiguous code (-1) is
invalid.  Protein radixes are not ported (ROADMAP queue A, item 8.5).
"""

from __future__ import annotations

import torch

from .alphabet import InputType, kmer_mask
from .bitops import i64


def _dna_only(it: InputType) -> None:
    if InputType(it) != InputType.DNA:
        raise NotImplementedError(
            f"input type {InputType(it).name}: only DNA is ported "
            "(ROADMAP queue A, item 8.5)"
        )


def pack_kmers(codes: torch.Tensor, k: int, it: InputType = InputType.DNA):
    """(..., L) int8 codes -> (kmers (..., L-k+1) int64, invalid bool)."""
    return _pack(codes, [1] * (k - 1), it)


def pack_spaced_kmers(codes: torch.Tensor, offsets, it: InputType = InputType.DNA):
    """Spaced-seed k-mers; ``offsets`` are the k-1 per-step advances
    (``Spacer.offsets``).  Output width L - c + 1, c = 1 + sum(offsets)."""
    return _pack(codes, list(offsets), it)


def _pack(codes: torch.Tensor, offsets, it: InputType):
    """Fold the codes at positions 0, o1, o1 + o2, ... of each seed."""
    _dna_only(it)
    L = codes.shape[-1]
    c = 1 + sum(offsets)
    if L < c:
        raise ValueError(f"sequence length {L} < seed span {c}")
    P = L - c + 1
    bad = codes < 0
    v = torch.where(bad, 0, codes).to(torch.int64)
    kmer = v[..., 0:P]
    invalid = bad[..., 0:P]
    pos = 0
    for off in offsets:
        pos += off
        kmer = (kmer << 2) | v[..., pos : pos + P]
        invalid = invalid | bad[..., pos : pos + P]
    return kmer, invalid


def position_validity(lengths: torch.Tensor, P: int, span: int) -> torch.Tensor:
    """(B,) lengths -> (B, P) bool: the position starts a whole seed
    window inside the unpadded read."""
    idx = torch.arange(P, device=lengths.device)
    return idx[None, :] < (lengths[:, None].to(torch.int64) - (span - 1))


def apply_mask(kmers: torch.Tensor, k: int, it: InputType) -> torch.Tensor:
    """Final per-type bit mask (rhtraits.h:51-68)."""
    _dna_only(it)
    return kmers & i64(kmer_mask(it, k))
