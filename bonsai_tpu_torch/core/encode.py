"""k-mer packing: int8 codes -> int64-held u64 k-mers.

Counterpart of ``bonsai_tpu/core/encode.py`` (``pack_kmers``,
``pack_spaced_kmers`` and ``_pack`` :50-137, ``position_validity``,
``apply_mask`` :163-170, ``codes_from_bytes`` :38, ``canonicalize`` :149,
``overflow_to_canonical_zero`` :154): the codes at a seed's k included
positions fold high-first, so the first character lands in the highest
used bits (encoder.h:547), and a seed holding an ambiguous code (-1,
folded as 0) is invalid.  A power-of-two radix folds with shift-or (DNA
2 bits, PROTEIN 8, PROTEIN_3BIT 3, DNA2 and DNAC 1) and is masked to its
bits; any other radix (PROTEIN20, PROTEIN_14, PROTEIN_6) folds with
multiply-add and takes the modulus radix**k.  Both folds wrap modulo
2^64 as the JAX package's uint64 arithmetic does: PROTEIN_3BIT at k = 22
folds 66 bits, and the top bits of the first residue fall off.
"""

from __future__ import annotations

import torch

from .alphabet import InputType, bits_of, kmer_mask, radix_of
from .bitops import SIGN, canonical, i64

U64 = 1 << 64


def codes_from_bytes(seq_u8: torch.Tensor, lut) -> torch.Tensor:
    """(..., L) uint8 bytes -> int8 codes (-1 ambiguous) by the alphabet
    table ``lut``, on the bytes' device (encode.py:38)."""
    lut = torch.as_tensor(lut, dtype=torch.int8, device=seq_u8.device)
    return lut[seq_u8.to(torch.int64)]


# min(kmer, its reverse complement) of DNA k-mers, under the JAX
# package's name (encode.py:149, kmerutil.h:137-140)
canonicalize = canonical


def overflow_to_canonical_zero(kmers: torch.Tensor, invalid: torch.Tensor,
                               k: int) -> torch.Tensor:
    """The canonical k-mer, or 0 where ``invalid``: a seed holding an N
    becomes ENCODE_OVERFLOW, whose canonical form is 0 (encode.py:154;
    encoder.h:622-628, kmerutil.h:83-90)."""
    return torch.where(invalid, 0, canonical(kmers, k))


def pack_kmers(codes: torch.Tensor, k: int, it: InputType = InputType.DNA):
    """(..., L) int8 codes -> (kmers (..., L-k+1) int64, invalid bool)."""
    return _pack(codes, [1] * (k - 1), it)


def pack_spaced_kmers(codes: torch.Tensor, offsets, it: InputType = InputType.DNA):
    """Spaced-seed k-mers; ``offsets`` are the k-1 per-step advances
    (``Spacer.offsets``).  Output width L - c + 1, c = 1 + sum(offsets)."""
    return _pack(codes, list(offsets), it)


def _pack(codes: torch.Tensor, offsets, it: InputType):
    """Fold the codes at positions 0, o1, o1 + o2, ... of each seed."""
    L = codes.shape[-1]
    c = 1 + sum(offsets)
    if L < c:
        raise ValueError(f"sequence length {L} < seed span {c}")
    P = L - c + 1
    bits, radix = bits_of(it), radix_of(it)
    bad = codes < 0
    v = torch.where(bad, 0, codes).to(torch.int64)
    kmer = v[..., 0:P]
    invalid = bad[..., 0:P]
    pos = 0
    for off in offsets:
        pos += off
        nxt = v[..., pos : pos + P]
        kmer = (kmer << bits) | nxt if bits else kmer * radix + nxt
        invalid = invalid | bad[..., pos : pos + P]
    return kmer, invalid


def position_validity(lengths: torch.Tensor, P: int, span: int) -> torch.Tensor:
    """(B,) lengths -> (B, P) bool: the position starts a whole seed
    window inside the unpadded read."""
    idx = torch.arange(P, device=lengths.device)
    return idx[None, :] < (lengths[:, None].to(torch.int64) - (span - 1))


def check_k(it: InputType, k: int) -> None:
    """Raise where the JAX package refuses (it, k): a modulus radix**k
    that numpy's uint64 cannot hold (k past chars-per-u64 for PROTEIN20,
    PROTEIN_14 and PROTEIN_6)."""
    if bits_of(it) is None and kmer_mask(it, k) >= U64:
        raise ValueError(
            f"input type {InputType(it).name}: k={k} needs the modulus "
            f"{radix_of(it)}**{k}, which exceeds 64 bits")


def umod(x: torch.Tensor, m: int) -> torch.Tensor:
    """Unsigned ``x % m`` of int64-held u64 bits, 0 < m < 2^63: a value
    with bit 63 set is 2^63 + (x & (2^63 - 1)), and the two residues are
    added modulo m without leaving int64."""
    if m >= 1 << 63:  # no radix**k of a modulus type lies there
        raise ValueError(f"modulus {m} is not below 2^63")
    lo = (x & ~SIGN) % m
    hi = (1 << 63) % m
    s = torch.where(lo >= m - hi, lo - (m - hi), lo + hi)
    return torch.where(x < 0, s, lo)


def apply_mask(kmers: torch.Tensor, k: int, it: InputType) -> torch.Tensor:
    """Final per-type bit mask or modulus (rhtraits.h:51-68)."""
    check_k(it, k)
    m = kmer_mask(it, k)
    if bits_of(it) is not None:
        return kmers & i64(m)
    return umod(kmers, m)
