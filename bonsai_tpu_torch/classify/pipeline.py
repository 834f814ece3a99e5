"""The classifier: 2-bit reads -> encode + probe -> resolve -> run output.

Counterpart of ``bonsai_tpu/classify/pipeline.py``.  One batch of reads
runs three hand-written CUDA kernels, each beside its plain torch version:

  K1 ``encode_probe``  (B, lproc/16) 2-bit words -> per (read, position)
                       hit, valid, compact taxon index, output value
                       (``encode_probe_radix``: (B, lproc) int8 codes of
                       another input type, its alphabet's fold)
  K2 ``resolve``       (classify/resolve.py) per read -> original taxid
  K3 ``step_outputs``  per read -> compact run-length matrix + full
                       positional matrix

The host parses, 2-bit packs and uploads a batch, fetches the compact
matrix (the full one only when a read has more hit runs than the compact
capacity) and writes Kraken text.  In-read Ns reach K1 through one of
three channels, chosen a batch as the JAX package chooses
(``n_channel``): none, a sorted list of their flat positions (sparse), or
a bit mask of the batch (mask).  In ``process_dataset`` a producer
thread parses and packs, the main thread uploads and launches, and a
writer thread fetches and formats, so host and device work overlap.

Classification runs with w = k (bin/bonsai.cpp:152): contiguous seeds
unwindowed and canonical by default; against a database built with a
spaced seed (``-S``), that seed at W = 1, never canonical (the encoder's
spaced branch).  The seed's span c sets the positions a read has,
P = lproc - c + 1, and the output's ``A:`` counts.  u32 values (taxids,
output words) travel in int32 tensors with the same bits.  A batch whose
longest read fits in 16 bits ships its lengths as ``torch.uint16``, 2 B a
read, as the JAX package ships them (pipeline.py:667-668); K1 reads
either width.

Reads of an input type other than DNA (``input_type``: the protein
alphabets, DNA2, DNAC) upload as int8 codes, one byte a code (the channel
"codes"), and K1's radix instantiations fold them as the JAX step on int8
codes does (``_make_step``, pipeline.py:404-463).  The JAX single-chip
path packs every alphabet into 2 bits (``pack_codes``), which loses the
bits of any code past 3: its taxa are wrong for every alphabet of more
than four codes (ROADMAP, "Faults of the JAX package that the port does
not copy"); the port computes what the JAX step on codes computes.
"""

from __future__ import annotations

import ctypes
import queue
import sys
import threading
import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..core import encode
from ..core.alphabet import InputType, alphabet_of
from ..core.bitops import shr
from ..core.encoder import fold_args, minimizers_plain
from ..core.spacer import Spacer
from ..db import formats
from ..db.table import ProbeArrays, probe_slots, unique_u64
from ..io import fastx
from ..native import get_lib
from ..util import CLASSIFY_SPANS, STAGES, span
from . import output as out_mod
from .resolve import resolve

M32 = 0xFFFFFFFF
PIPELINE_DEPTH = 4  # batches queued between the pipeline's threads
# the sparse-N list's sentinel: past every flat position it may list
N_SENTINEL = 0x7FFFFFFF


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 values as int32 (u32 bits kept)."""
    x = x & M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32-held u32 bits -> their int64 values."""
    return x.to(torch.int64) & M32


@dataclass
class BatchResult:
    """One row per classification unit: a read, or a mate pair (the
    reference classifies pairs as one unit, classifier.h:236-240).  Hits
    come either as full positional ``taxa`` + ``hit_mask`` matrices, or as
    compact ``run_vals``/``run_lens``/``n_runs``."""

    names: Sequence[bytes]  # a list, or the batch's ``fastx.Strings``
    seqs: Sequence[bytes]
    quals: Sequence[Optional[bytes]]
    lengths: np.ndarray  # (R,) mate-1 lengths
    taxon: np.ndarray  # (R,) original taxids, 0 = unclassified
    taxa: Optional[np.ndarray]  # (R, W) hit taxids, or None (compact)
    hit_mask: Optional[np.ndarray]  # (R, W), or None (compact)
    n_missing: np.ndarray  # (R,) total missing (both mates)
    n_kmers: np.ndarray  # (R,) total valid kmers (both mates)
    n_kmers1: Optional[np.ndarray] = None  # (R,) mate-1 valid kmers
    run_vals: Optional[np.ndarray] = None  # (R, MAXR) run taxids
    run_lens: Optional[np.ndarray] = None  # (R, MAXR) run lengths
    n_runs: Optional[np.ndarray] = None  # (R,) run counts (<= MAXR here)
    lengths2: Optional[np.ndarray] = None
    seqs2: Optional[Sequence[bytes]] = None
    quals2: Optional[Sequence[Optional[bytes]]] = None

    @property
    def paired(self) -> bool:
        return self.lengths2 is not None

    @property
    def compact(self) -> bool:
        return self.run_vals is not None

    def hit_taxa(self, i: int) -> np.ndarray:
        """Hit-taxa stream of row i (taxids of DB hits in k-mer order)."""
        if self.run_vals is not None:
            r = int(self.n_runs[i])
            return np.repeat(self.run_vals[i, :r], self.run_lens[i, :r])
        return self.taxa[i][self.hit_mask[i]]


# -- K1: unpack + encode + probe ------------------------------------------------

def unpack_2bit(pcodes: torch.Tensor, nmask: Optional[torch.Tensor] = None):
    """(B, L/16) int32 words of 2-bit codes (code c at bits 2*(c % 16)) [+
    (B, ceil(L/32)) int32 N-bitmask] -> (B, L) int8 codes, -1 where the
    mask is set."""
    B, L16 = pcodes.shape
    shifts = torch.arange(16, device=pcodes.device, dtype=torch.int32) * 2
    c = ((pcodes[:, :, None] >> shifts) & 3).to(torch.int8).reshape(B, L16 * 16)
    if nmask is None:
        return c
    mshift = torch.arange(32, device=nmask.device, dtype=torch.int32)
    nm = ((nmask[:, :, None] >> mshift) & 1).bool()
    nm = nm.reshape(B, nmask.shape[1] * 32)[:, : L16 * 16]
    return torch.where(nm, -1, c).to(torch.int8)


def unpack_n(pcodes, nmask, lproc: int, nidx=None):
    """(B, lproc) int8 codes of packed reads with their in-read Ns at -1:
    from the N bit mask ``nmask``, or from ``nidx``, int32-held u32 flat
    positions row * lproc + col (the JAX sparse channel's scatter of -1,
    ``mode="drop"``: an entry past the batch, the sentinel among them, is
    dropped), or none."""
    codes = unpack_2bit(pcodes, nmask)[:, :lproc]
    if nidx is None:
        return codes
    # one slot past the codes takes the dropped entries: no host sync
    n = codes.numel()
    flat = torch.cat([codes.reshape(-1), codes.new_zeros(1)])
    flat.index_fill_(0, as_u32(nidx).clamp(max=n), -1)
    return flat[:n].view(codes.shape)


def widen_lengths(lengths: torch.Tensor) -> torch.Tensor:
    """K1's lengths, int32 or u16 (``torch.uint16``), as int32 (the JAX
    ``slice_cast``, pipeline.py:496-501): the one place the plain versions
    widen them, unsigned."""
    return lengths if lengths.dtype == torch.int32 else lengths.to(torch.int32)


def encode_probe_plain(pcodes, nmask, lengths, lproc: int, k: int,
                       canon: bool, arr: ProbeArrays, want_idx: bool,
                       positions=None, nidx=None):
    """Plain torch K1: unpack_2bit -> lproc slice (-> the sparse list's Ns,
    ``nidx``, in place of ``nmask``'s: ``unpack_n``) -> emissions at W = 1
    (unwindowed, or spaced at the k offsets ``positions``) -> probe_slots
    -> (hit, valid, cidx int32, oidx int32).  cidx is the compact taxonomy
    index (low half of the packed value); oidx the dictionary index
    (``want_idx``) or the original taxid (high half); both are 0 where
    there is no hit."""
    codes = unpack_n(pcodes, nmask, lproc, nidx)
    em = minimizers_plain(codes, widen_lengths(lengths), k, 1, canon,
                          positions=positions)
    return _probe_outputs(em.values, em.mask, arr, want_idx)


def _probe_outputs(kmers, valid, arr: ProbeArrays, want_idx: bool):
    """K1's four outputs of the k-mers ``kmers`` valid at ``valid``: (hit,
    valid, cidx, oidx)."""
    packed, found, sel = probe_slots(kmers, arr, want_idx=True)
    hit = valid & found
    cidx = as_i32(torch.where(hit, packed, 0))
    oidx = as_i32(torch.where(hit, sel if want_idx else shr(packed, 32), 0))
    return hit, valid, cidx, oidx


def _seed_args(lengths, B: int, k: int, positions):
    """Check K1's lengths (int32 or u16, (B,)) and a spaced seed's offsets
    -> (the seed's span c, the host offsets or None, 1 where the lengths
    are u16)."""
    if lengths.dtype not in (torch.int32, torch.uint16):
        raise TypeError(f"lengths: dtype {lengths.dtype}, expected int32 or "
                        "uint16")
    kernels.check(lengths, "lengths", lengths.dtype, lengths.device, (B,))
    if positions is not None and (
            len(positions) != k or int(positions[0]) != 0
            or any(y <= x for x, y in zip(positions, positions[1:]))):
        raise ValueError(f"positions {list(positions)}: k={k} increasing "
                         "offsets from 0 expected")
    c = k if positions is None else int(positions[-1]) + 1
    pos = None if positions is None else (ctypes.c_int32 * 32)(
        *(int(x) for x in positions))
    return c, pos, int(lengths.dtype == torch.uint16)


def _k1_args(pcodes, nmask, lengths, lproc: int, k: int, positions):
    """Check K1's inputs on the card; (nmw, P, the host offsets or None,
    1 where the lengths are u16)."""
    dev = pcodes.device
    B, w16 = pcodes.shape
    kernels.check(pcodes, "pcodes", torch.int32, dev)
    if lengths.device != dev:
        raise ValueError(f"lengths: on {lengths.device}, expected {dev}")
    if not 1 <= k <= 32:
        raise ValueError(f"k={k}: the kernel takes 1 <= k <= 32")
    c, pos, len16 = _seed_args(lengths, B, k, positions)
    if lproc > w16 * 16:
        raise ValueError(f"lproc={lproc} exceeds the {w16 * 16} packed codes")
    nmw = 0
    if nmask is not None:
        kernels.check(nmask, "nmask", torch.int32, dev)
        nmw = nmask.shape[1]
        if nmask.shape[0] != B or nmw * 32 < lproc:
            raise ValueError(f"nmask shape {tuple(nmask.shape)} does not "
                             f"cover ({B}, {lproc})")
    return nmw, max(lproc - c + 1, 0), pos, len16


def encode_probe(pcodes, nmask, lengths, lproc: int, k: int, canon: bool,
                 arr: ProbeArrays, want_idx: bool, positions=None,
                 nidx=None):
    """K1 (``csrc/encode_probe.cu``): see ``encode_probe_plain``, which
    serves CPU tensors.  pcodes (B, w16) int32, nmask (B, nmw) int32 or
    None, lengths (B,) int32 or uint16; outputs (B, P) with P = lproc - c
    + 1, c the seed's span (k when ``positions`` is None).  A spaced seed
    runs the kernel's second entry point, and an image of a row range (a
    psum-route rank's, ``ProbeArrays.rows``) its bucket-range
    instantiation, contiguous or spaced.  ``nidx`` (cap,) int32, the
    sparse channel's flat N positions sorted ascending and padded with
    ``N_SENTINEL``, replaces ``nmask`` in the sparse instantiation,
    contiguous or spaced, of a whole table; it takes B * lproc <=
    ``N_SENTINEL``.  Each launch is counted in ``encode_probe.variants``."""
    if positions is not None and canon:
        raise ValueError("a spaced seed is never canonicalized")
    if nidx is not None and nmask is not None:
        raise ValueError("encode_probe: an N mask or a sparse list, not both")
    if pcodes.device.type == "cpu":
        return encode_probe_plain(pcodes, nmask, lengths, lproc, k, canon,
                                  arr, want_idx, positions, nidx)
    if pcodes.device.type != "cuda":
        raise ValueError(f"encode_probe: no kernel for device {pcodes.device}")
    dev = pcodes.device
    B, w16 = pcodes.shape
    nmw, P, pos, len16 = _k1_args(pcodes, nmask, lengths, lproc, k,
                                  positions)
    arr.check(dev, ranged=True)
    if nidx is not None:
        kernels.check(nidx, "nidx", torch.int32, dev)
        if nidx.dim() != 1:
            raise ValueError(f"nidx: shape {tuple(nidx.shape)}, a list "
                             "expected")
        if B * lproc > N_SENTINEL:
            raise ValueError(f"nidx: B * lproc = {B * lproc} flat positions "
                             "reach the sentinel; ship the N mask")
        if arr.rows:
            raise ValueError("nidx: the bucket-range instantiation takes the "
                             "N mask")
    hit = torch.empty((B, P), dtype=torch.bool, device=dev)
    valid = torch.empty((B, P), dtype=torch.bool, device=dev)
    cidx = torch.empty((B, P), dtype=torch.int32, device=dev)
    oidx = torch.empty((B, P), dtype=torch.int32, device=dev)
    if B * P:
        if nidx is not None:
            kernels.launch(
                "bk_encode_probe_sparse", dev, pcodes.data_ptr(), w16,
                nidx.data_ptr(), nidx.numel(), lengths.data_ptr(), len16, B,
                P, k, int(canon), int(pos is not None), pos,
                arr.slots.data_ptr(), arr.lgnb, arr.vbits,
                arr.vals.data_ptr(), arr.vals.numel(), int(arr.inline),
                int(want_idx), hit.data_ptr(), valid.data_ptr(),
                cidx.data_ptr(), oidx.data_ptr(),
            )
        elif arr.rows:
            kernels.launch(
                "bk_encode_probe_range", dev, pcodes.data_ptr(), w16,
                kernels.ptr(nmask), nmw, lengths.data_ptr(), len16, B, P, k,
                int(canon), int(pos is not None), pos, arr.slots.data_ptr(),
                arr.lgnb, arr.vbits, arr.vals.data_ptr(), arr.vals.numel(),
                int(arr.inline), int(want_idx), arr.row0, arr.rows,
                hit.data_ptr(), valid.data_ptr(), cidx.data_ptr(),
                oidx.data_ptr(),
            )
        elif positions is None:
            kernels.launch(
                "bk_encode_probe", dev, pcodes.data_ptr(), w16,
                kernels.ptr(nmask), nmw, lengths.data_ptr(), len16, B, P, k,
                int(canon), arr.slots.data_ptr(), arr.lgnb, arr.vbits,
                arr.vals.data_ptr(), arr.vals.numel(), int(arr.inline),
                int(want_idx), hit.data_ptr(), valid.data_ptr(),
                cidx.data_ptr(), oidx.data_ptr(),
            )
        else:
            kernels.launch(
                "bk_encode_probe_spaced", dev, pcodes.data_ptr(), w16,
                kernels.ptr(nmask), nmw, lengths.data_ptr(), len16, B, P, k,
                pos,
                arr.slots.data_ptr(), arr.lgnb, arr.vbits,
                arr.vals.data_ptr(), arr.vals.numel(), int(arr.inline),
                int(want_idx), hit.data_ptr(), valid.data_ptr(),
                cidx.data_ptr(), oidx.data_ptr(),
            )
        variant = "contiguous" if positions is None else "spaced"
        if arr.rows:
            variant = "range" if positions is None else "spaced range"
        elif nidx is not None:
            variant = "sparse" if positions is None else "spaced sparse"
        _count(variant)
    return hit, valid, cidx, oidx


def _count(variant: str) -> None:
    encode_probe.launches += 1
    encode_probe.variants[variant] = encode_probe.variants.get(variant, 0) + 1


encode_probe.launches = 0
encode_probe.variants = {}


def encode_only_plain(pcodes, nmask, lengths, lproc: int, k: int,
                      canon: bool, positions=None):
    """Plain torch of K1's encode-only instantiation: unpack_2bit -> lproc
    slice -> emissions at W = 1 -> (kmers int64, 0 where not valid;
    valid)."""
    codes = unpack_2bit(pcodes, nmask)[:, :lproc]
    em = minimizers_plain(codes, widen_lengths(lengths), k, 1, canon,
                          positions=positions)
    return torch.where(em.mask, em.values, 0), em.mask


def encode_only(pcodes, nmask, lengths, lproc: int, k: int, canon: bool,
                positions=None):
    """K1's encode-only instantiation (``csrc/encode_probe.cu``
    ``bk_encode_only``, the a2a route's encode, no table): see
    ``encode_only_plain``, which serves CPU tensors; inputs as
    ``encode_probe``'s, outputs (B, P) kmers int64 and valid bool.
    Counted in ``encode_probe``'s launches as "encode" or "spaced
    encode"."""
    if positions is not None and canon:
        raise ValueError("a spaced seed is never canonicalized")
    if pcodes.device.type == "cpu":
        return encode_only_plain(pcodes, nmask, lengths, lproc, k, canon,
                                 positions)
    if pcodes.device.type != "cuda":
        raise ValueError(f"encode_only: no kernel for device {pcodes.device}")
    dev = pcodes.device
    B, w16 = pcodes.shape
    nmw, P, pos, len16 = _k1_args(pcodes, nmask, lengths, lproc, k,
                                  positions)
    kmers = torch.empty((B, P), dtype=torch.int64, device=dev)
    valid = torch.empty((B, P), dtype=torch.bool, device=dev)
    if B * P:
        kernels.launch("bk_encode_only", dev, pcodes.data_ptr(), w16,
                       kernels.ptr(nmask), nmw, lengths.data_ptr(), len16, B,
                       P, k, int(canon), int(pos is not None), pos,
                       kmers.data_ptr(), valid.data_ptr())
        _count("encode" if positions is None else "spaced encode")
    return kmers, valid


# -- K1's radix instantiations: another input type's int8 codes -------------------

def encode_probe_radix_plain(codes, lengths, k: int, it: InputType,
                             arr: ProbeArrays, want_idx: bool,
                             positions=None):
    """Plain torch of K1's radix instantiations: (B, L) int8 codes of the
    input type ``it`` (-1 ambiguous or padding) -> emissions at W = 1
    (the JAX step's encode, ``BatchEncoder.emissions``: the alphabet's
    fold of the seed's k codes, contiguous or at the offsets
    ``positions``; a seed past the read or holding an ambiguous code is
    invalid, and so is a spaced seed's U64_MAX) -> probe_slots -> (hit,
    valid, cidx int32, oidx int32), as ``encode_probe_plain``; P = L - c +
    1."""
    em = minimizers_plain(codes, widen_lengths(lengths), k, 1, False,
                          positions=positions, it=it)
    return _probe_outputs(em.values, em.mask, arr, want_idx)


def encode_only_radix_plain(codes, lengths, k: int, it: InputType,
                            positions=None):
    """Plain torch of K1's radix encode-only instantiation: (kmers int64,
    0 where not valid; valid)."""
    em = minimizers_plain(codes, widen_lengths(lengths), k, 1, False,
                          positions=positions, it=it)
    return torch.where(em.mask, em.values, 0), em.mask


def _radix_args(codes, lengths, k: int, canon: bool, it: InputType,
                positions):
    """Check the radix wrappers' inputs (on any device); (P, the host
    offsets or None, 1 where the lengths are u16)."""
    it = InputType(it)
    if it == InputType.DNA:
        raise ValueError("DNA reads take the 2-bit words: encode_probe")
    if canon:
        raise ValueError(f"input type {it.name} is never canonicalized")
    if codes.dim() != 2:
        raise ValueError(f"codes: shape {tuple(codes.shape)}, expected (B, L)")
    B, L = codes.shape
    kernels.check(codes, "codes", torch.int8, codes.device)
    if lengths.device != codes.device:
        raise ValueError(f"lengths: on {lengths.device}, expected "
                         f"{codes.device}")
    encode.check_k(it, k)
    c, pos, len16 = _seed_args(lengths, B, k, positions)
    return max(L - c + 1, 0), pos, len16


def encode_probe_radix(codes, lengths, k: int, canon: bool, it: InputType,
                       arr: ProbeArrays, want_idx: bool, positions=None):
    """K1's radix instantiations (``csrc/encode_probe_radix.cu``
    ``bk_encode_probe_radix``, and ``bk_encode_probe_radix_range`` for an
    image of a row range): see ``encode_probe_radix_plain``, which serves
    CPU tensors.  codes (B, L) int8 of the input type ``it`` (not DNA),
    lengths (B,) int32 or uint16; outputs (B, P), P = L - c + 1.  ``canon``
    must be False: only DNA is canonicalized.  Counted in
    ``encode_probe``'s launches as "radix", "spaced radix", "radix range"
    or "spaced radix range"."""
    P, pos, len16 = _radix_args(codes, lengths, k, canon, it, positions)
    if codes.device.type == "cpu":
        return encode_probe_radix_plain(codes, lengths, k, it, arr, want_idx,
                                        positions)
    if codes.device.type != "cuda":
        raise ValueError(f"encode_probe_radix: no kernel for device "
                         f"{codes.device}")
    dev = codes.device
    B, L = codes.shape
    arr.check(dev, ranged=True)
    hit = torch.empty((B, P), dtype=torch.bool, device=dev)
    valid = torch.empty((B, P), dtype=torch.bool, device=dev)
    cidx = torch.empty((B, P), dtype=torch.int32, device=dev)
    oidx = torch.empty((B, P), dtype=torch.int32, device=dev)
    if B * P:
        head = (codes.data_ptr(), L, lengths.data_ptr(), len16, B, P, k,
                int(pos is not None), pos, *fold_args(it, k),
                arr.slots.data_ptr(), arr.lgnb, arr.vbits,
                arr.vals.data_ptr(), arr.vals.numel(), int(arr.inline),
                int(want_idx))
        tail = (hit.data_ptr(), valid.data_ptr(), cidx.data_ptr(),
                oidx.data_ptr())
        if arr.rows:
            kernels.launch("bk_encode_probe_radix_range", dev, *head,
                           arr.row0, arr.rows, *tail)
        else:
            kernels.launch("bk_encode_probe_radix", dev, *head, *tail)
        variant = "radix range" if arr.rows else "radix"
        _count(variant if pos is None else "spaced " + variant)
    return hit, valid, cidx, oidx


def encode_only_radix(codes, lengths, k: int, canon: bool, it: InputType,
                      positions=None):
    """K1's radix encode-only instantiation (``bk_encode_only_radix``, the
    a2a route's encode of another input type): see
    ``encode_only_radix_plain``, which serves CPU tensors; inputs as
    ``encode_probe_radix``'s, outputs (B, P) kmers int64 and valid bool.
    Counted in ``encode_probe``'s launches as "radix encode" or "spaced
    radix encode"."""
    P, pos, len16 = _radix_args(codes, lengths, k, canon, it, positions)
    if codes.device.type == "cpu":
        return encode_only_radix_plain(codes, lengths, k, it, positions)
    if codes.device.type != "cuda":
        raise ValueError(f"encode_only_radix: no kernel for device "
                         f"{codes.device}")
    dev = codes.device
    B, L = codes.shape
    kmers = torch.empty((B, P), dtype=torch.int64, device=dev)
    valid = torch.empty((B, P), dtype=torch.bool, device=dev)
    if B * P:
        kernels.launch("bk_encode_only_radix", dev, codes.data_ptr(), L,
                       lengths.data_ptr(), len16, B, P, k,
                       int(pos is not None), pos, *fold_args(it, k),
                       kmers.data_ptr(), valid.data_ptr())
        _count("radix encode" if pos is None else "spaced radix encode")
    return kmers, valid


# -- K3: step outputs ------------------------------------------------------------

WIDE, PLAIN, DICT = 0, 1, 2  # compact layout kinds (csrc/step_outputs.cu)


def dict_layout(dict_size: int, W: int):
    """(vb, lb, head_words) of the dictionary compact layout: run values at
    vb bits, run lengths at lb bits, 2 head words when every counter fits
    a byte."""
    vb = 4 if dict_size <= 16 else (8 if dict_size <= 256 else 16)
    lb = 8 if W <= 255 else 16
    head_words = 2 if W <= 255 else 3
    return vb, lb, head_words


def compact_layout(dict_size: Optional[int], W: int, maxr: int):
    """(kind, vb, lb, head_words, cols) of the compact matrix: the one
    definition read by the packers (K3 and its plain version) and by the
    host decoder (``Classifier._finish_arrays``)."""
    if W >= 1 << 15:
        return WIDE, 32, 32, 5, 5 + 2 * maxr
    if dict_size is None:
        return PLAIN, 32, 16, 3, 3 + maxr + (maxr + 1) // 2
    vb, lb, hw = dict_layout(dict_size, W)
    return DICT, vb, lb, hw, hw + -(-maxr // (32 // vb)) + -(-maxr // (32 // lb))


def _packbits(a: torch.Tensor, bits: int) -> torch.Tensor:
    """(R, n) int64 values < 2^bits -> (R, ceil(n*bits/32)) words, 32//bits
    values per word, little-endian within the word (u32 sums)."""
    R, n = a.shape
    per = 32 // bits
    pad = (-n) % per
    if pad:
        a = torch.cat([a, a.new_zeros((R, pad))], dim=1)
    sh = torch.arange(per, device=a.device, dtype=torch.int64) * bits
    return (((a.reshape(R, -1, per) << sh) & M32).sum(-1)) & M32


def build_step_outputs(taxon, taxa, hit, valid, valid1, maxr: int,
                       dict_size: Optional[int] = None):
    """Plain torch K3: (compact, full) int32 matrices (u32 bits) from
    taxon (R,), taxa (R, W) (0 where no hit), hit/valid (R, W) bool and
    valid1 (R,) mate-1 valid counts, in the layouts of ``compact_layout``
    (``build_step_outputs`` of the JAX package)."""
    R, W = taxa.shape
    dev = taxa.device
    t = as_u32(taxa)
    tx = as_u32(taxon)
    v1 = as_u32(valid1)
    miss = (valid & ~hit).sum(-1)
    kmers = valid.sum(-1)
    hb = (W + 31) // 32
    bits = torch.zeros((R, hb * 32), dtype=torch.int64, device=dev)
    bits[:, :W] = hit.to(torch.int64)
    weights = torch.arange(32, device=dev, dtype=torch.int64)
    hit_words = (bits.reshape(R, hb, 32) << weights).sum(-1)
    full = torch.cat([tx[:, None], miss[:, None], kmers[:, None], v1[:, None],
                      hit_words, t], dim=1)

    run_lens = torch.zeros((R, maxr + 1), dtype=torch.int64, device=dev)
    run_vals = torch.zeros((R, maxr + 1), dtype=torch.int64, device=dev)
    n_runs = torch.zeros(R, dtype=torch.int64, device=dev)
    if W:
        # a run starts at a hit whose value differs from the previous hit's
        pos = torch.arange(W, device=dev).expand(R, W)
        last = torch.where(hit, pos, -1).cummax(dim=1).values
        prev = torch.cat([last.new_full((R, 1), -1), last[:, :-1]], dim=1)
        prev_v = t.gather(1, prev.clamp(min=0))
        is_new = hit & ((prev < 0) | (t != prev_v))
        run_id = is_new.to(torch.int64).cumsum(dim=1) - 1
        n_runs = is_new.sum(-1)
        rid = torch.where(hit, run_id, maxr).clamp(max=maxr)
        run_lens.scatter_add_(1, rid, torch.ones_like(rid))
        nid = torch.where(is_new, run_id, maxr).clamp(max=maxr)
        run_vals.scatter_add_(1, nid, torch.where(is_new, t, 0))
    run_lens = run_lens[:, :maxr]
    run_vals = run_vals[:, :maxr]

    kind, vb, lb, hw, cols = compact_layout(dict_size, W, maxr)
    head = [tx[:, None]]
    if kind == WIDE:
        head += [miss[:, None], kmers[:, None], v1[:, None], n_runs[:, None]]
        body = [run_vals, run_lens]
    else:
        if hw == 2:
            head.append((miss | (kmers << 8) | (v1 << 16) | (n_runs << 24))[:, None])
        else:
            head.append(((miss & 0xFFFF) | (kmers << 16))[:, None])
            head.append(((v1 & 0xFFFF) | (n_runs << 16))[:, None])
        vals = _packbits(run_vals, vb) if kind == DICT else run_vals
        body = [vals, _packbits(run_lens, lb)]
    compact = torch.cat(head + body, dim=1)
    assert compact.shape[1] == cols
    return as_i32(compact), as_i32(full)


def step_outputs(taxon, taxa, hit, valid, valid1, maxr: int,
                 dict_size: Optional[int] = None):
    """K3 (``csrc/step_outputs.cu``): see ``build_step_outputs``, which
    serves CPU tensors.  int32 taxon/taxa/valid1 (u32 bits), bool
    hit/valid."""
    if taxa.device.type == "cpu":
        return build_step_outputs(taxon, taxa, hit, valid, valid1, maxr,
                                  dict_size)
    if taxa.device.type != "cuda":
        raise ValueError(f"step_outputs: no kernel for device {taxa.device}")
    dev = taxa.device
    R, W = taxa.shape
    kernels.check(taxon, "taxon", torch.int32, dev, (R,))
    kernels.check(taxa, "taxa", torch.int32, dev)
    kernels.check(hit, "hit", torch.bool, dev, (R, W))
    kernels.check(valid, "valid", torch.bool, dev, (R, W))
    kernels.check(valid1, "valid1", torch.int32, dev, (R,))
    if not 1 <= maxr <= 4096:
        raise ValueError(f"maxr={maxr}: the kernel takes 1..4096 runs")
    kind, vb, lb, hw, cols = compact_layout(dict_size, W, maxr)
    hb = (W + 31) // 32
    compact = torch.empty((R, cols), dtype=torch.int32, device=dev)
    full = torch.empty((R, 4 + hb + W), dtype=torch.int32, device=dev)
    if R:
        kernels.launch(
            "bk_step_outputs", dev, taxon.data_ptr(), taxa.data_ptr(),
            hit.data_ptr(), valid.data_ptr(), valid1.data_ptr(), R, W, maxr,
            kind, vb, lb, hw, compact.data_ptr(), cols, full.data_ptr(),
        )
        step_outputs.launches += 1
    return compact, full


step_outputs.launches = 0


# -- the classifier -----------------------------------------------------------------

def bucket_rows(n: int, mult: int = 1) -> int:
    """The JAX package's padded batch: n rounded up to a power of two of
    at least 256 (``_bucket_batch``), then to a multiple of ``mult`` (the
    paired or mesh multiple)."""
    b = 256
    while b < n:
        b <<= 1
    return -(-b // mult) * mult


def sparse_cap(rows: int) -> int:
    """The longest sparse-N list a batch of ``rows`` padded rows ships."""
    return max(64, rows // 32)


def n_channel(n_inread: int, cap: int, rows: int, lproc: int,
              sparse_ok: bool = True, limit: int = N_SENTINEL) -> str:
    """The channel of a batch's in-read Ns, as the JAX ``_prepare_batch``
    picks it: "none" without one, "sparse" for at most ``cap`` of them
    where the classifier takes the list (``sparse_ok``), else "mask".  A
    batch of ``rows`` x ``lproc`` flat positions past ``limit`` takes the
    mask: there a position could equal the sentinel, which the JAX
    package does not guard against."""
    if n_inread == 0:
        return "none"
    if sparse_ok and n_inread <= cap and rows * lproc <= limit:
        return "sparse"
    return "mask"


class Prep(NamedTuple):
    """A batch packed on the host (pinned on CUDA): the 2-bit words, the
    N channel's array (the mask, the sparse list or None) and its name,
    the lengths (uint16, or int32 past 0xFFFF), and the processing
    width.  In the channel "codes" (an input type other than DNA)
    ``pcodes`` holds the (n, lproc) int8 codes, one byte a code, -1 for
    an ambiguous code or padding, and there is no N array."""

    pcodes: torch.Tensor
    naux: Optional[torch.Tensor]
    lengths: torch.Tensor
    lproc: int
    channel: str

    @property
    def nmask(self) -> Optional[torch.Tensor]:
        return self.naux if self.channel == "mask" else None

    @property
    def nidx(self) -> Optional[torch.Tensor]:
        return self.naux if self.channel == "sparse" else None


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but CUDA is not available")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Classifier:
    """Classify reads against a database on one device (``device``:
    "cuda" runs the kernels, "cpu" their plain torch versions).  Reads of
    ``input_type`` are coded by its alphabet; a type other than DNA is
    never canonical and ships its reads as int8 codes (the "codes"
    channel, K1's radix instantiations).  ``trim_table`` frees the
    database's host layout once its image is on the device
    (``KmerTable.trim``; it is rebuilt on its next use)."""

    it = InputType.DNA  # the reads' input type (``_set_seed``)
    # {span: [wall_s, cpu_s, count]} of the last ``process_dataset`` call
    # (None before the first), and its four stages' wall seconds
    span_seconds: Optional[dict] = None
    stage_seconds: Optional[dict] = None

    def __init__(self, db: formats.Database, tree, canonicalize: bool = True,
                 emit_all: bool = False, emit_kraken: bool = True,
                 emit_fastq: bool = False,
                 input_type: InputType = InputType.DNA,
                 trim_table: bool = True, device="cuda", max_runs: int = 8):
        table = db.table
        slots, vals, inline = table.arrays_np(formats.packed_values(table, tree))
        n_distinct = int(unique_u64(
            tree.compact(table.vals_sorted, missing_ok=True)).size)
        self._setup(slots, vals, inline, table.lgnb, table.vbits, n_distinct,
                    db.k, canonicalize, tree, emit_all, emit_kraken,
                    emit_fastq, device, max_runs, db.gaps, input_type)
        if trim_table:
            table.trim()

    @classmethod
    def from_arrays(cls, slots, vals, inline: bool, lgnb: int, vbits: int,
                    n_distinct: int, k: int, tree, canonicalize: bool = True,
                    emit_all: bool = False, emit_kraken: bool = True,
                    emit_fastq: bool = False,
                    input_type: InputType = InputType.DNA, device="cuda",
                    max_runs: int = 8, gaps=None):
        """A classifier over a slot image held as numpy arrays: the
        ``_arrays``, ``_n_distinct`` and tree of a JAX ``Classifier``, or a
        probe image; ``gaps`` are a spaced seed's k - 1 gaps."""
        self = cls.__new__(cls)
        self._setup(slots, vals, inline, lgnb, vbits, n_distinct, k,
                    canonicalize, tree, emit_all, emit_kraken, emit_fastq,
                    device, max_runs, gaps, input_type)
        return self

    @classmethod
    def from_probe_image(cls, image_path: str, tree, emit_all: bool = False,
                         emit_kraken: bool = True, emit_fastq: bool = False,
                         input_type: InputType = InputType.DNA,
                         device="cuda", max_runs: int = 8):
        """From a saved probe image (``db/formats.py``): the slot words
        upload straight from the memory map, with no placement."""
        img = formats.load_probe_image(image_path)
        if img.tree_digest != formats.tree_digest(tree):
            raise ValueError(
                "probe image was built against a different taxonomy "
                f"(digest {img.tree_digest})"
            )
        return cls.from_arrays(
            img.slots, img.vals, img.inline, img.lgnb, img.vbits,
            img.n_distinct, img.k, tree, img.canonicalize, emit_all,
            emit_kraken, emit_fastq, input_type, device, max_runs, img.gaps,
        )

    def _setup(self, slots, vals, inline, lgnb, vbits, n_distinct, k,
               canonicalize, tree, emit_all, emit_kraken, emit_fastq,
               device, max_runs, gaps=None, input_type=InputType.DNA):
        self.device = _device(device)
        self._set_seed(k, gaps, canonicalize, input_type)
        self.tree = tree
        self.emit_all = emit_all
        self.emit_kraken = emit_kraken
        self.emit_fastq = emit_fastq
        self.arr = ProbeArrays.from_numpy(slots, vals, inline, lgnb, vbits,
                                          self.device)
        # dictionary mode: with an inline table of <= 2^16 distinct values
        # the probe's value index replaces the 32-bit taxid in the compact
        # output; the host maps indices back through this table
        self._uniq_host = None
        if inline and np.asarray(vals).size <= 0xFFFF:
            self._uniq_host = (np.asarray(vals) >> np.uint64(32)).astype(np.uint32)
        self._n_distinct = int(n_distinct)
        self.tax = tree.device_arrays(self.device)
        self.max_runs = int(max_runs)
        # after this many full-matrix fallbacks, double max_runs
        self._overflow_batches = 0
        self._overflow_bump_after = 3
        self.n_classified = 0
        self.n_unclassified = 0

    def _set_seed(self, k, gaps, canonicalize, input_type) -> None:
        """The seed and the reads' alphabet: classify always uses w = k
        (bin/bonsai.cpp:152); a spaced seed cannot canonicalize
        (encoder.h:148-150), and only DNA ever does (encoder.h:419), so
        ``canonicalize`` is dropped for another input type, as the JAX
        encoder drops it (core/encoder.py:99)."""
        if int(k) > 32:
            raise NotImplementedError(
                f"k={k} (128-bit k-mers) is not ported (ROADMAP queue A, "
                "item 8.6)")
        self.it = InputType(input_type)
        self.sp = Spacer(int(k), int(k), list(gaps) if gaps else None)
        self.k = self.sp.k
        if self.it != InputType.DNA:
            encode.check_k(self.it, self.k)
        self.canon = (bool(canonicalize) and self.sp.unspaced()
                      and self.it == InputType.DNA)
        self.positions = (None if self.sp.unspaced() else
                          tuple(int(p) for p in self.sp.positions))
        self.lut = alphabet_of(self.it).lut

    @staticmethod
    def pack_codes(codes: np.ndarray, with_nmask: bool = True):
        """(B, L) int8 codes (L % 32 == 0) -> (packed (B, L/16) u32 of
        2-bit codes, nmask (B, L/32) u32 of ambiguity bits, or None
        without ``with_nmask``), in numpy (pipeline.py:570); the upload
        packs through the host C++ packer."""
        B, L = codes.shape
        v = np.where(codes < 0, 0, codes).astype(np.uint32).reshape(
            B, L // 16, 16)
        packed = np.bitwise_or.reduce(
            v << (np.arange(16, dtype=np.uint32) * 2), axis=-1)
        if not with_nmask:
            return packed, None
        nb = (codes < 0).astype(np.uint32).reshape(B, L // 32, 32)
        return packed, np.bitwise_or.reduce(
            nb << np.arange(32, dtype=np.uint32), axis=-1)

    # -- one batch -----------------------------------------------------------
    def _sparse_n_ok(self) -> bool:
        """Whether a batch may ship its in-read Ns as the sparse list of
        batch-global flat positions (the sharded classifier, whose ranks
        take blocks of rows, overrides this)."""
        return True

    def _prepare_batch(self, batch: fastx.ReadBatch, paired: bool = False,
                       lproc: Optional[int] = None) -> Prep:
        """Host half: 2-bit pack the batch through the host C++ packer
        into (pinned, on CUDA) host tensors, with the N channel of
        ``n_channel``: the sparse list holds at most ``sparse_cap`` of the
        JAX package's padded rows (``bucket_rows``).  The processing width
        lproc is the batch's true max read length rounded to Lp/16
        granularity (>= 8), so the probe runs at P = lproc - k + 1
        positions (or the ``lproc`` given, the sharded classifier's raw
        step: the codes' width).  The lengths ship as u16 where the longest
        read is at most 0xFFFF bases (the JAX rule), else as int32.  An
        input type other than DNA ships its (n, lproc) int8 codes instead,
        -1 past each read, in the channel "codes" (no N channel: the -1
        byte carries the ambiguity)."""
        n = len(batch.codes)
        if paired and n % 2:
            raise ValueError("a paired batch holds whole mate pairs")
        L = batch.codes.shape[1]
        Lp = (L + 31) & ~31
        maxlen = int(batch.lengths.max()) if n else 0
        g = max(8, Lp >> 4)
        if lproc is None:
            lproc = min(Lp, max(-(-maxlen // g) * g, 8))
        pin = self.device.type == "cuda"

        def host(a):
            t = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
            return t.pin_memory() if pin else t

        lengths = np.ascontiguousarray(batch.lengths, dtype=np.int32)
        if maxlen <= 0xFFFF:  # 2 B a read (pipeline.py:667-668)
            lengths = lengths.astype(np.uint16)
        if self.it != InputType.DNA:
            # one byte a code; the -1 byte carries the ambiguity
            codes = np.full((n, lproc), -1, dtype=np.int8)
            w = min(L, lproc)
            codes[:, :w] = batch.codes[:, :w]
            return Prep(host(codes), None, host(lengths), lproc, "codes")
        w16 = (lproc + 15) // 16
        nmw = (w16 + 1) // 2
        rows = bucket_rows(n, self._batch_multiple(paired))
        cap = sparse_cap(rows)
        codes = np.ascontiguousarray(batch.codes, dtype=np.int8)
        len32 = np.ascontiguousarray(batch.lengths, dtype=np.int32)
        pcodes = np.empty((n, w16), dtype=np.uint32)
        nmask = np.empty((n, nmw), dtype=np.uint32)
        nidx = np.empty(cap, dtype=np.uint32)
        n_inread = get_lib().btpu_pack_batch(
            codes.ctypes.data, n, L, len32.ctypes.data, n, w16, lproc,
            pcodes.ctypes.data, nmask.ctypes.data, nmw, nidx.ctypes.data, cap,
        )
        channel = n_channel(n_inread, cap, rows, lproc, self._sparse_n_ok())
        naux = {"none": None, "sparse": nidx, "mask": nmask}[channel]
        return Prep(host(pcodes), None if naux is None else host(naux),
                    host(lengths), lproc, channel)

    def _batch_multiple(self, paired: bool) -> int:
        """The row multiple of the JAX package's padded batch (the sharded
        classifier's: its ranks')."""
        return 2 if paired else 1

    def _dispatch_prepared(self, prep: Prep, paired: bool = False):
        """Device half: upload, run K1 -> K2 -> K3 on the current stream,
        and start the copy of the compact matrix to pinned host memory."""
        lproc = prep.lproc
        dev = self.device
        maxr = self.max_runs
        dict_size = None if self._uniq_host is None else len(self._uniq_host)

        def up(t):
            return None if t is None else t.to(dev, non_blocking=True)

        if prep.channel == "codes":
            hit, valid, cidx, oidx = encode_probe_radix(
                up(prep.pcodes), up(prep.lengths), self.k, False, self.it,
                self.arr, want_idx=dict_size is not None,
                positions=self.positions)
        else:
            hit, valid, cidx, oidx = encode_probe(
                up(prep.pcodes), up(prep.nmask), up(prep.lengths), lproc,
                self.k, self.canon, self.arr, want_idx=dict_size is not None,
                positions=self.positions, nidx=up(prep.nidx),
            )
        valid1 = valid.sum(dim=-1, dtype=torch.int32)
        if paired:
            # mates (2i, 2i+1) merge into one row of width 2P
            B, P = hit.shape
            hit = hit.view(B // 2, 2 * P)
            valid = valid.view(B // 2, 2 * P)
            cidx = cidx.view(B // 2, 2 * P)
            oidx = oidx.view(B // 2, 2 * P)
            valid1 = valid1[0::2].contiguous()
        if hit.shape[1]:
            taxon = resolve(cidx, hit, self.tax, self._n_distinct)
        else:  # no position (every read shorter than the seed's span)
            taxon = torch.zeros(hit.shape[0], dtype=torch.int32, device=dev)
        compact, full = step_outputs(taxon, oidx, hit, valid, valid1, maxr,
                                     dict_size)
        done = None
        if dev.type == "cuda":
            host = torch.empty(compact.shape, dtype=compact.dtype,
                               pin_memory=True)
            host.copy_(compact, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            compact = host
        return compact, done, full, lproc, maxr

    def _finish_batch(self, batch: fastx.ReadBatch, out, paired: bool = False,
                      force_full: bool = False) -> BatchResult:
        compact, done, full, lproc, maxr = out
        with span("device_wait", self.span_seconds):
            if done is not None:
                done.synchronize()
        R = len(batch.names) // 2 if paired else len(batch.names)
        cm = compact.numpy().view(np.uint32)[:R]
        return self._finish_arrays(
            batch, cm, lambda: full[:R].cpu().numpy().view(np.uint32), lproc,
            maxr, paired, force_full,
        )

    def _finish_arrays(self, batch: fastx.ReadBatch, cm: np.ndarray,
                       fetch_full, lproc: int, maxr: int, paired: bool = False,
                       force_full: bool = False,
                       allow_bump: bool = True) -> BatchResult:
        """Decode a compact matrix (+ the full one, fetched lazily on run
        overflow) into a BatchResult.  ``allow_bump=False`` keeps
        max_runs (the sharded classifier's per-rank output, where every
        process must run the same steps)."""
        n = len(batch.names)
        R = n // 2 if paired else n
        P = max(lproc - self.sp.c + 1, 0)
        W = 2 * P if paired else P
        uniq = self._uniq_host
        kind, vb, lb, hw, _ = compact_layout(
            None if uniq is None else int(uniq.size), W, maxr)

        def unpackbits(words, bits, count):
            per = 32 // bits
            out = np.empty((cm.shape[0], per * words.shape[1]), np.uint32)
            for j in range(per):
                out[:, j::per] = (words >> np.uint32(bits * j)) & np.uint32(
                    (1 << bits) - 1)
            return out[:, :count]

        taxon = cm[:, 0]
        if kind == WIDE:
            n_missing = cm[:, 1].astype(np.int32)
            n_kmers = cm[:, 2].astype(np.int32)
            n_kmers1 = cm[:, 3].astype(np.int32)
            n_runs = cm[:, 4]
            rv = cm[:, 5 : 5 + maxr]
            rl = cm[:, 5 + maxr : 5 + 2 * maxr]
        else:
            if hw == 2:
                h1 = cm[:, 1]
                n_missing = (h1 & 0xFF).astype(np.int32)
                n_kmers = ((h1 >> 8) & 0xFF).astype(np.int32)
                n_kmers1 = ((h1 >> 16) & 0xFF).astype(np.int32)
                n_runs = h1 >> 24
            else:
                n_missing = (cm[:, 1] & 0xFFFF).astype(np.int32)
                n_kmers = (cm[:, 1] >> 16).astype(np.int32)
                n_kmers1 = (cm[:, 2] & 0xFFFF).astype(np.int32)
                n_runs = cm[:, 2] >> 16
            off = hw
            nv = -(-maxr // (32 // vb))
            rv = (unpackbits(cm[:, off : off + nv], vb, maxr) if kind == DICT
                  else cm[:, off : off + maxr])
            nl = -(-maxr // (32 // lb))
            rl = unpackbits(cm[:, off + nv : off + nv + nl], lb, maxr)
        if uniq is not None:
            # dictionary indices back to taxids (slots past n_runs decode
            # to uniq[0] and are never read)
            rv = uniq[np.minimum(rv, np.uint32(uniq.size - 1))]
        taxa = hit = run_vals = run_lens = None
        overflowed = bool(n_runs.size and int(n_runs.max()) > maxr)
        if overflowed and not force_full and allow_bump:
            # run-rich data: after a few full-matrix fallbacks, double the
            # compact run capacity
            self._overflow_batches += 1
            if (self._overflow_batches >= self._overflow_bump_after
                    and self.max_runs < 64):
                self.max_runs *= 2
                self._overflow_batches = 0
        if force_full or overflowed:
            with span("full_fetch", self.span_seconds):
                taxa, hit = self._full_matrix(batch, fetch_full(), W, P,
                                              paired)
        else:
            run_vals, run_lens = rv, rl
            n_runs = n_runs.astype(np.int32)
        self.n_classified += int((taxon != 0).sum())
        self.n_unclassified += int((taxon == 0).sum())
        common = dict(
            taxon=taxon, taxa=taxa, hit_mask=hit, n_missing=n_missing,
            n_kmers=n_kmers, n_kmers1=n_kmers1, run_vals=run_vals,
            run_lens=run_lens, n_runs=None if run_vals is None else n_runs,
        )
        if paired:
            return BatchResult(
                names=batch.names[0::2], seqs=batch.seqs[0::2],
                quals=batch.quals[0::2] if batch.quals else None,
                lengths=batch.lengths[0::2], lengths2=batch.lengths[1::2],
                seqs2=batch.seqs[1::2],
                quals2=batch.quals[1::2] if batch.quals else None, **common,
            )
        return BatchResult(names=batch.names, seqs=batch.seqs,
                           quals=batch.quals, lengths=batch.lengths, **common)

    def _full_matrix(self, batch: fastx.ReadBatch, fm: np.ndarray, W: int,
                     P: int, paired: bool):
        """(taxa, hit) of the positional matrix ``fm`` (R, 4 + hb + W)."""
        hb = (W + 31) // 32
        taxa = fm[:, 4 + hb :]
        shifts = np.arange(32, dtype=np.uint32)
        hit = (((fm[:, 4 : 4 + hb, None] >> shifts) & np.uint32(1))
               .astype(bool).reshape(fm.shape[0], hb * 32)[:, :W])
        # trim the length-padding columns (always misses) to the batch's
        # read width
        Pt = max(batch.codes.shape[1] - self.sp.c + 1, 0)
        if Pt < P:
            if paired:
                taxa = np.concatenate([taxa[:, :Pt], taxa[:, P : P + Pt]], 1)
                hit = np.concatenate([hit[:, :Pt], hit[:, P : P + Pt]], 1)
            else:
                taxa, hit = taxa[:, :Pt], hit[:, :Pt]
        uniq = self._uniq_host
        if uniq is not None:
            taxa = np.where(
                hit, uniq[np.minimum(taxa, np.uint32(uniq.size - 1))], 0
            ).astype(np.uint32)
        return taxa, hit

    def classify_batch(self, batch: fastx.ReadBatch, paired: bool = False,
                       full: bool = False) -> BatchResult:
        """full=True forces the positional taxa/hit_mask fetch."""
        out = self._dispatch_prepared(self._prepare_batch(batch, paired), paired)
        return self._finish_batch(batch, out, paired, force_full=full)

    def classify_reads(self, seqs: List[bytes]) -> np.ndarray:
        """Classify raw sequences -> original taxids."""
        L = fastx.bucket_len(max(len(s) for s in seqs))
        codes = np.full((len(seqs), L), -1, dtype=np.int8)
        lengths = np.empty(len(seqs), dtype=np.int32)
        for i, s in enumerate(seqs):
            codes[i, : len(s)] = self.lut[np.frombuffer(s, dtype=np.uint8)]
            lengths[i] = len(s)
        batch = fastx.ReadBatch(names=[b""] * len(seqs), seqs=seqs,
                                codes=codes, lengths=lengths,
                                quals=[None] * len(seqs))
        return self.classify_batch(batch).taxon

    # -- a whole dataset ---------------------------------------------------------
    def process_dataset(self, path: str, out_fh, mate_path: Optional[str] = None,
                        batch_size: int = 4096, profile: bool = False):
        """Classify a FASTA/FASTQ file (optionally paired) and write text
        output (process_dataset, classifier.h:296-337).  A producer thread
        reads and packs, the main thread uploads and launches (up to
        ``PIPELINE_DEPTH`` batches in flight), a writer thread fetches and
        formats; output keeps input order.  Every phase of a batch is a
        ``util.span`` in the thread that runs it, accumulated into
        ``self.span_seconds`` ({span: [wall_s, cpu_s, count]}, reset a
        call): the producer's ``read`` (the file's next batch) and
        ``parse`` (``_prepare_batch``), the main thread's ``dispatch``,
        the writer's ``materialize`` (with ``device_wait`` and
        ``full_fetch`` inside it) and ``format`` (with ``name_join``
        inside it where the batch's names are a list: paired input),
        each blocking queue call
        (``producer_blocked``, ``dispatch_starved``, ``dispatch_blocked``,
        ``writer_starved``) and the whole call (``pass``).  Each batch has
        one ``parse`` and one ``format``, in input order.  A
        ``torch.profiler`` trace of every thread (``cli.py``
        ``--trace-dir``) sets them beside the card's work.  ``profile``
        prints them to stderr."""
        is_paired = mate_path is not None
        if is_paired and batch_size % 2:
            batch_size += 1  # pairs must not straddle batches
        self.span_seconds = acc = {s: [0.0, 0.0, 0] for s in CLASSIFY_SPANS}
        t = time.perf_counter
        n_reads = 0
        t_all = t()
        q: queue.Queue = queue.Queue(maxsize=PIPELINE_DEPTH)
        pq: queue.Queue = queue.Queue(maxsize=PIPELINE_DEPTH)
        err: list = []
        perr: list = []
        stop = threading.Event()

        def producer():
            try:
                it = iter(fastx.batch_reads(path, self.lut,
                                            batch_size=batch_size,
                                            mate_path=mate_path))
                while not stop.is_set():
                    with span("read", acc):  # the last finds the file's end
                        batch = next(it, None)
                    if batch is None:
                        break
                    with span("parse", acc):
                        prep = self._prepare_batch(batch, is_paired)
                    with span("producer_blocked", acc):
                        pq.put((batch, prep))
            except BaseException as e:  # re-raised by the main thread
                perr.append(e)
            finally:
                with span("producer_blocked", acc):
                    pq.put(None)

        def writer():
            try:
                while True:
                    with span("writer_starved", acc):
                        item = q.get()
                    if item is None:
                        return
                    self._write_result(out_fh, *item, is_paired)
            except BaseException as e:  # re-raised by the main thread
                err.append(e)
                while q.get() is not None:  # drain so the main thread ends
                    pass

        with span("pass", acc):
            pt = threading.Thread(target=producer, daemon=True)
            wt = threading.Thread(target=writer, daemon=True)
            pt.start()
            wt.start()
            producer_done = False
            try:
                while True:
                    with span("dispatch_starved", acc):
                        item = pq.get()
                    if item is None:
                        producer_done = True
                        break
                    if err:
                        raise err[0]
                    batch, prep = item
                    n_reads += len(batch.names)
                    with span("dispatch", acc):
                        out = self._dispatch_prepared(prep, is_paired)
                        # free the batch's host buffers with their upload:
                        # the free can leave the thread off the CPU for up
                        # to a millisecond, which fell between two spans
                        item = prep = None
                    with span("dispatch_blocked", acc):
                        q.put((batch, out))
            finally:
                stop.set()
                while not producer_done:  # unblock and retire the producer
                    producer_done = pq.get() is None
                pt.join()
                with span("dispatch_blocked", acc):  # the writer's last
                    q.put(None)
                    wt.join()
                # {stage: wall seconds}, the view the benchmark reads
                self.stage_seconds = {s: acc[s][0] for s in STAGES}
        if err:
            raise err[0]
        if perr:
            raise perr[0]
        if profile:
            total = t() - t_all
            parts = "  ".join(f"{k}={v:.3f}s"
                              for k, v in self.stage_seconds.items())
            print(f"# profile: {n_reads} reads in {total:.3f}s "
                  f"({n_reads / max(total, 1e-9):,.0f} reads/s)  {parts}",
                  file=sys.stderr)
            for name, (wall, cpu, n) in acc.items():
                print(f"# span {name}: wall {wall:.3f}s cpu {cpu:.3f}s "
                      f"({100 * cpu / max(wall, 1e-9):.0f}%) count {n}",
                      file=sys.stderr)

    def _write_result(self, out_fh, batch, out, is_paired):
        acc = self.span_seconds
        with span("materialize", acc):
            res = self._finish_batch(batch, out, is_paired)
        with span("format", acc):
            out_fh.write(out_mod.format_batch(
                res, self.sp.c, emit_all=self.emit_all,
                emit_kraken=self.emit_kraken, emit_fastq=self.emit_fastq,
                acc=acc,
            ))
