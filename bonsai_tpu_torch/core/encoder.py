"""Batched encoder facade: the seed disciplines of ``build``,
``classify`` and the Python API.

Counterpart of ``bonsai_tpu/core/encoder.py`` ``BatchEncoder.emissions``
(:130-220) for seeds of k <= 32 of every input type, and the schemes
``lex`` (score frev64), ``entropy`` (score u64(kmer / (H + eps)), H the
windowed Shannon entropy of the seed's codes, ``core/entropy.py``; the
Python API), ``entropy-file`` (score u64(kmer / (-1 + 1e-4)); ``build
-e``) and ``hash`` (score: the k-mer's packed value in a phase-1 map,
U64_MAX where the map lacks it, ``db/table.py`` ``ScoreMap``; ``build
-t|-f --phase1-db``):

* unwindowed, contiguous (:141-153; ``classify`` runs it, w = k,
  bin/bonsai.cpp:152): encode every window, drop windows that hold an
  ambiguous code or run past the read, canonicalize or not;
* canonical windowed, contiguous (:174-184): every in-length position is
  pushed, an N window pushes canonical(OVERFLOW) == 0 (a real key, not a
  pad, and under ``hash`` probed like any other), the score is that of
  the canonical k-mer, and slot j emits the (score, kmer) minimum of
  positions [j, j + W - 1] iff j + W <= max(len - (k - 1), 0);
* spaced (:189-204; ``-S``, and ``classify`` against a spaced database at
  W = 1): never canonical, every position pushed, a seed with an
  ambiguous code pushes U64_MAX (scored frev64(U64_MAX),
  0x8000000000000000 under both entropy schemes, or probed under hash:
  at k = 32 a real all-T k-mer is U64_MAX), and an emission equal to
  U64_MAX is dropped;
* uncanonical windowed, contiguous (:161-173, :185-188, :206-220;
  ``-C -w``): only valid seeds are pushed, the window slides over the
  subsequence of valid seeds, and a final partial window (0 < n_valid <
  W) emits its best seed once, in column 0, so E = 1 + (P - W + 1);
* canonical windowed contiguous under ``entropy`` (:156-160): the
  uncanonical discipline selects (eps = 1e-3, against 1e-4 on spaced
  seeds), then the emitted values are canonicalized.

Only DNA is ever canonical (encoder.h:419).  DNA folds 2 bits a base;
the other input types fold their alphabet's codes with shift-or or
multiply-add (``core/encode.py``).  ``minimizers`` is the wrapper of the
CUDA kernel KB1 (``csrc/minimizers.cu``), which computes the first three
disciplines; ``compacted_minimizers`` that of KB4
(``csrc/compacted_minimizers.cu``), which computes the last two; both
probe the phase-1 image from inside the kernel under ``hash``
(``csrc/probe.cuh``) and score ``entropy`` where the seed's codes are
(``csrc/scores.cuh``).  ``minimizers_plain`` and
``compacted_minimizers_plain`` are their plain torch versions, which
serve CPU tensors.  Unwindowed seeds take no score.  Under ``hash`` a
k-mer of another input type is probed as its alphabet folds it (the
shift-or's mask, or the multiply-add's modulus, applied), the value a
phase-1 map of that input type holds (``minimized_map(input_type=)``).
k > 32 (item 8.6) raises ``NotImplementedError`` with its ROADMAP queue A
item.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..db.table import ScoreMap, lookup_scores_plain
from . import encode
from .alphabet import InputType, bits_of, kmer_mask, radix_of
from .bitops import SIGN, canonical
from .entropy import (FILE_DENOM, FILE_EPS, WINDOWED_EPS, file_scores,
                      shannon_scores, terms_on)
from .hashes import frev64
from .minimize import compacted_minimizers as _compacted, positional_minimizers
from .spacer import Spacer

MAX_W = 8192  # KB1 and KB4 stage a tile's W - 1 halo in shared memory
SMEM_BYTES = 232_448  # shared memory a block may take on an H100
SCHEMES = ("lex", "entropy", "entropy-file", "hash")
U64_MAX = -1  # as int64
DNA = InputType.DNA
# the kernels' codes for a fold and a score (csrc/scores.cuh)
FOLD_DNA, FOLD_SHIFT, FOLD_MULADD = 0, 1, 2
SCORE_CODE = {"lex": 0, "entropy-file": 1, "hash": 2, "entropy": 3}
# a variant's name in the wrappers' launch counts
VARIANT = {"lex": "lex", "entropy-file": "entropy-file", "hash": "hash",
           "entropy": "shannon"}


class Emissions(NamedTuple):
    values: torch.Tensor  # (B, E) int64-held u64
    mask: torch.Tensor  # (B, E) bool


def _empty(codes: torch.Tensor) -> Emissions:
    B = codes.shape[0]
    return Emissions(
        torch.zeros((B, 0), dtype=torch.int64, device=codes.device),
        torch.zeros((B, 0), dtype=torch.bool, device=codes.device),
    )


def _scores(kmers: torch.Tensor, scheme: str,
            score_map: Optional[ScoreMap], codes=None, k=0,
            it: InputType = DNA, eps=FILE_EPS, positions=None) -> torch.Tensor:
    """The score of each pushed k-mer; the scheme ``entropy`` reads the
    seeds' ``codes`` (contiguous, or at ``positions``)."""
    if scheme == "lex":
        return frev64(kmers)
    if scheme == "entropy-file":
        return file_scores(kmers)
    if scheme == "entropy":
        return shannon_scores(kmers, codes, k, radix_of(it), eps, positions)
    # ScoreMap.lookup_scores on a CPU tensor; plain torch on any device
    return lookup_scores_plain(kmers, _score_map(score_map).arrays(
        kmers.device))


def _score_map(score_map: Optional[ScoreMap]) -> ScoreMap:
    if score_map is None:
        raise ValueError("the scheme 'hash' needs a score_map")
    return score_map


def _span(k: int, positions: Optional[Sequence[int]]) -> int:
    return k if positions is None else int(positions[-1]) + 1


def _pack(codes, k, positions, it):
    """(kmers, invalid) of a contiguous or spaced seed, masked."""
    if positions is None:
        kmers, invalid = encode.pack_kmers(codes, k, it)
    else:
        offsets = [int(b) - int(a) for a, b in zip(positions, positions[1:])]
        kmers, invalid = encode.pack_spaced_kmers(codes, offsets, it)
    return encode.apply_mask(kmers, k, it), invalid


def minimizers_plain(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                     W: int, canon: bool, scheme: str = "lex",
                     positions: Optional[Sequence[int]] = None,
                     score_map: Optional[ScoreMap] = None,
                     it: InputType = DNA,
                     zero_invalid: bool = False) -> Emissions:
    """Plain torch KB1: (B, L) int8 codes (-1 = ambiguous or pad), (B,)
    lengths -> (B, E) emissions, E = L - c - W + 2 with c the seed's span.
    ``positions`` (the k offsets of a spaced seed, ``Spacer.positions``)
    makes the spaced discipline, which takes no ``canon``; otherwise W = 1
    is the unwindowed discipline and W > 1 needs ``canon`` (DNA only).
    The scheme ``hash`` scores through ``score_map``; ``entropy`` takes a
    spaced seed (contiguous seeds are ``compacted_minimizers``').
    ``zero_invalid`` (a contiguous DNA seed at W = 1: the
    sequence-parallel encode) gives 0 as the value where nothing is
    emitted."""
    c = _span(k, positions)
    if W == 1:  # a window of one seed: no score decides anything
        scheme = "lex"
    if canon and it != DNA:
        raise ValueError(f"input type {InputType(it).name} is never "
                         "canonicalized")
    if codes.shape[-1] < c:
        return _empty(codes)
    kmers, invalid = _pack(codes, k, positions, it)
    P = kmers.shape[-1]
    n_push = torch.clamp(lengths.to(torch.int64) - (c - 1), min=0)
    if positions is None and W == 1:
        valid = encode.position_validity(lengths, P, k) & ~invalid
        values = canonical(kmers, k) if canon else kmers
        if zero_invalid:
            values = torch.where(valid, values, 0)
        return Emissions(values, valid)
    if positions is None:
        if not canon or scheme == "entropy":
            raise ValueError("uncanonical contiguous windows and the scheme "
                             "entropy are compacted_minimizers' discipline")
        ck = torch.where(invalid, 0, canonical(kmers, k))
        if P < W:
            return _empty(codes)
        return Emissions(*positional_minimizers(
            _scores(ck, scheme, score_map), ck, W, n_push))
    if canon:
        raise ValueError("a spaced seed is never canonicalized")
    ov = torch.where(invalid, U64_MAX, kmers)
    scores = _scores(ov, scheme, score_map, codes, k, it, FILE_EPS, positions)
    if scheme in ("entropy", "entropy-file"):  # a partial tracker: NOT_FULL
        scores = torch.where(invalid, SIGN, scores)
    if P < W:
        return _empty(codes)
    out_k, out_v = positional_minimizers(scores, ov, W, n_push)
    return Emissions(out_k, out_v & (out_k != U64_MAX))


def kb1_smem_bytes(span: int, W: int) -> int:
    """KB1's shared memory for a seed of span c and a window of W
    (``layout`` in csrc/minimizers.cu), with 512 B for the staged seed."""
    npos = 4096 + W - 1
    nsx = (npos - 1) + ((npos - 1) >> 4) + 1
    code_off = (nsx * 8 * (2 if W > 1 else 1) + 15) // 16 * 16
    return code_off + (npos + span - 1 + 34) // 16 * 16 + 512


def _check_args(name, codes, lengths, k, W, scheme, it):
    dev = codes.device
    if codes.dim() != 2:
        raise ValueError(f"codes: shape {tuple(codes.shape)}, expected (B, L)")
    B = codes.shape[0]
    kernels.check(codes, "codes", torch.int8, dev)
    kernels.check(lengths, "lengths", torch.int32, dev, (B,))
    if not 1 <= k <= 32:
        raise ValueError(f"k={k}: the kernel takes 1 <= k <= 32")
    if not 1 <= W <= MAX_W:
        raise ValueError(f"window of {W} k-mers: the kernel takes 1..{MAX_W}")
    if scheme not in SCHEMES:
        raise ValueError(f"{name}: scheme {scheme!r}, the kernel takes {SCHEMES}")
    encode.check_k(it, k)


def fold_args(it: InputType, k: int):
    """(kind, bits, radix, lim) of the fold of input type ``it`` at k, as
    the entry points of KB1, KB4 and K1's radix instantiations take it
    (``csrc/scores.cuh`` Fold)."""
    bits = bits_of(it)
    if it == DNA:
        return FOLD_DNA, 2, 4, kmer_mask(it, k)
    if bits:
        return FOLD_SHIFT, bits, 1 << bits, kmer_mask(it, k)
    return FOLD_MULADD, 0, radix_of(it), kmer_mask(it, k)


def _gen_args(k: int, it: InputType, scheme: str, dev, score_map, eps):
    """The fold, score, phase-1 image and Shannon arguments that KB1's
    and KB4's entry points take after the seed's."""
    fold = fold_args(it, k)
    if scheme == "hash":
        arr = _score_map(score_map).arrays(dev)
        arr.check(dev)
        image = arr.args()
    else:
        image = (None, 0, 0, None, 0, 0)
    terms = terms_on(k, dev) if scheme == "entropy" else None
    return (*fold, SCORE_CODE[scheme], FILE_DENOM, *image, kernels.ptr(terms),
            radix_of(it), eps)


def minimizers(codes: torch.Tensor, lengths: torch.Tensor, k: int, W: int,
               canon: bool, scheme: str = "lex",
               positions: Optional[Sequence[int]] = None,
               score_map: Optional[ScoreMap] = None,
               it: InputType = DNA, zero_invalid: bool = False) -> Emissions:
    """KB1 (``csrc/minimizers.cu``): see ``minimizers_plain``, which serves
    CPU tensors.  codes (B, L) int8, lengths (B,) int32 -> values (B, E)
    int64 and an ``emitted`` mask (B, E) bool; a value is never a
    sentinel (at k = 32 a real k-mer can be U64_MAX).  The kernel's one
    entry point picks its instantiation from the seed, the fold and the
    score: the hash score probes the phase-1 image of ``score_map`` on the
    codes' device, and the other input types roll the fold of their
    unwindowed seeds ("radix rolled"; the positions 0..k-1 and the
    unwindowed flag still go to the entry point, which earlier kernels
    read); ``zero_invalid`` (a contiguous DNA seed at W = 1) is the
    sequence-parallel encode's instantiation, which writes 0 as the value
    where nothing is emitted.  Counted by instantiation in
    ``minimizers.variants``."""
    if zero_invalid and (W != 1 or positions is not None or it != DNA):
        raise ValueError("zero_invalid takes a contiguous DNA seed at W = 1")
    if codes.device.type == "cpu":
        return minimizers_plain(codes, lengths, k, W, canon, scheme, positions,
                                score_map, it, zero_invalid)
    if codes.device.type != "cuda":
        raise ValueError(f"minimizers: no kernel for device {codes.device}")
    dev = codes.device
    it = InputType(it)
    _check_args("minimizers", codes, lengths, k, W, scheme, it)
    if W == 1:  # a window of one seed: no score decides anything
        scheme = "lex"
    if canon and it != DNA:
        raise ValueError(f"input type {it.name} is never canonicalized")
    B, L = codes.shape
    if B > 65535:
        raise ValueError(f"{B} rows: the kernel's grid takes at most 65535")
    c = _span(k, positions)
    if positions is not None:
        if len(positions) != k or int(positions[0]) != 0:
            raise ValueError(f"positions {list(positions)}: k={k} offsets "
                             "from 0 expected")
        if canon:
            raise ValueError("a spaced seed is never canonicalized")
        if any(b <= a for a, b in zip(positions, positions[1:])):
            raise ValueError(f"positions {list(positions)}: not increasing")
        if kb1_smem_bytes(c, W) > SMEM_BYTES:
            raise ValueError(f"seed span {c} with a window of {W}: the "
                             "kernel's tile does not fit in shared memory")
    elif W > 1 and (not canon or scheme == "entropy"):
        raise ValueError("uncanonical contiguous windows and the scheme "
                         "entropy are compacted_minimizers' discipline")
    E = L - c - W + 2
    if E <= 0 or B == 0:
        return _empty(codes)
    keys = torch.empty((B, E), dtype=torch.int64, device=dev)
    emitted = torch.empty((B, E), dtype=torch.bool, device=dev)
    spaced = positions is not None
    pos = (ctypes.c_int32 * 32)(*(int(p) for p in (
        positions or (range(k) if it != DNA else ()))))
    kernels.launch("bk_minimizers_gen", dev, codes.data_ptr(),
                   lengths.data_ptr(), B, L, k, W, int(canon), int(spaced),
                   pos, c,
                   int(not spaced) if it != DNA else int(zero_invalid),
                   *_gen_args(k, it, scheme, dev, score_map, FILE_EPS),
                   keys.data_ptr(), emitted.data_ptr())
    suffix = "" if scheme == "lex" else " " + VARIANT[scheme]
    if it != DNA and not spaced:
        variant = "radix rolled"
    elif it != DNA or spaced:
        variant = ("radix" if it != DNA else "spaced") + suffix
    elif zero_invalid:
        variant = "sequence-parallel"
    else:
        variant = "lex" if scheme == "lex" else (
            "hash" if scheme == "hash" else "contiguous" + suffix)
    minimizers.launches += 1
    minimizers.variants[variant] = minimizers.variants.get(variant, 0) + 1
    return Emissions(keys, emitted)


minimizers.launches = 0
minimizers.variants = {}


def compacted_minimizers_plain(codes: torch.Tensor, lengths: torch.Tensor,
                               k: int, W: int, scheme: str = "lex",
                               score_map: Optional[ScoreMap] = None,
                               it: InputType = DNA,
                               canon: bool = False) -> Emissions:
    """Plain torch KB4: (B, L) int8 codes, (B,) lengths -> (B, E)
    emissions of the uncanonical contiguous windowed discipline,
    E = 1 + max(P - W + 1, 0), P = L - k + 1 (none when L < k).  Column 0
    is the trailing partial window: valid iff 0 < n_valid < W, and then
    the minimum of the row's n_valid seeds; U64_MAX otherwise (the JAX
    package leaves the minimum of every pushed seed there, a value no
    mask lets out).  Column 1 + j is the minimum of compacted seeds
    [j, j + W - 1], the sentinel U64_MAX standing in past n_valid; valid
    iff j + W <= n_valid.  The scheme ``hash`` scores through
    ``score_map``; ``entropy`` takes eps = 1e-3, and with ``canon`` (DNA)
    canonicalizes each emitted value after the selection."""
    if canon and (scheme != "entropy" or it != DNA):
        raise ValueError("only the scheme entropy of DNA canonicalizes "
                         "after an uncanonical selection")
    if codes.shape[-1] < k:
        return _empty(codes)
    kmers, invalid = _pack(codes, k, None, it)
    valid = encode.position_validity(lengths, kmers.shape[-1], k) & ~invalid
    out_k, out_v, tail_k, tail_v = _compacted(
        _scores(kmers, scheme, score_map, codes, k, it, WINDOWED_EPS), kmers,
        valid, W)
    tail_k = torch.where(tail_v, tail_k, U64_MAX)
    values = torch.cat([tail_k[:, None], out_k], dim=-1)
    mask = torch.cat([tail_v[:, None], out_v], dim=-1)
    if canon:
        values = torch.where(mask, canonical(values, k), values)
    return Emissions(values, mask)


def compacted_minimizers(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                         W: int, scheme: str = "lex",
                         score_map: Optional[ScoreMap] = None,
                         it: InputType = DNA,
                         canon: bool = False) -> Emissions:
    """KB4 (``csrc/compacted_minimizers.cu``): see
    ``compacted_minimizers_plain``, which serves CPU tensors.  codes
    (B, L) int8, lengths (B,) int32 -> values (B, E) int64, emitted
    (B, E) bool.  The kernel's one entry point picks its instantiation
    from the fold and the score (the hash score with the phase-1 image of
    ``score_map`` on the codes' device); counted by instantiation in
    ``compacted_minimizers.variants``."""
    if codes.device.type == "cpu":
        return compacted_minimizers_plain(codes, lengths, k, W, scheme,
                                          score_map, it, canon)
    if codes.device.type != "cuda":
        raise ValueError(
            f"compacted_minimizers: no kernel for device {codes.device}")
    dev = codes.device
    it = InputType(it)
    _check_args("compacted_minimizers", codes, lengths, k, W, scheme, it)
    if canon and (scheme != "entropy" or it != DNA):
        raise ValueError("only the scheme entropy of DNA canonicalizes "
                         "after an uncanonical selection")
    B, L = codes.shape
    if B > 65535:
        raise ValueError(f"{B} rows: the kernel's grid takes at most 65535")
    if L - k + 1 >= 1 << 30:
        raise ValueError(f"{L - k + 1} seeds a row: the kernel takes < 2^30")
    if L < k or B == 0:
        return _empty(codes)
    P = L - k + 1
    E = 1 + max(P - W + 1, 0)
    keys = torch.empty((B, E), dtype=torch.int64, device=dev)
    emitted = torch.empty((B, E), dtype=torch.bool, device=dev)
    scratch = kernels.scratch("bk_compacted_minimizers_gen", (B, L, 0), dev)
    kernels.launch("bk_compacted_minimizers_gen", dev, codes.data_ptr(),
                   lengths.data_ptr(), B, L, k, W,
                   *_gen_args(k, it, scheme, dev, score_map, WINDOWED_EPS),
                   int(canon), keys.data_ptr(), emitted.data_ptr(),
                   scratch.data_ptr())
    variant = ("radix " if it != DNA else "") + VARIANT[scheme]
    v = compacted_minimizers.variants
    v[variant] = v.get(variant, 0) + 1
    compacted_minimizers.launches += 1
    return Emissions(keys, emitted)


compacted_minimizers.launches = 0
compacted_minimizers.variants = {}


def compacted_stream_plain(values: torch.Tensor, valid: torch.Tensor,
                           W: int) -> Emissions:
    """Plain torch KB4 stream: a given (B, P) stream of int64-held u64
    values with (B, P) validity flags (rolling hashes of any k) -> (B, E)
    emissions of the compacted discipline, scored by frev64 of the value,
    E = 1 + max(P - W + 1, 0), column 0 the trailing partial window, as
    ``compacted_minimizers_plain``."""
    if values.dim() != 2 or values.shape[-1] < 1:
        raise ValueError(f"values: shape {tuple(values.shape)}, expected "
                         "(B, P) with P >= 1")
    out_k, out_v, tail_k, tail_v = _compacted(frev64(values), values, valid,
                                              W)
    tail_k = torch.where(tail_v, tail_k, U64_MAX)
    return Emissions(torch.cat([tail_k[:, None], out_k], dim=-1),
                     torch.cat([tail_v[:, None], out_v], dim=-1))


def compacted_stream(values: torch.Tensor, valid: torch.Tensor,
                     W: int) -> Emissions:
    """KB4's stream source (``csrc/compacted_minimizers.cu``
    ``bk_compacted_stream``): see ``compacted_stream_plain``, which serves
    CPU tensors.  values (B, P) int64, valid (B, P) bool, 1 <= W <= 8192;
    the window launch is KB4's, with the lex score."""
    if values.device.type == "cpu":
        return compacted_stream_plain(values, valid, W)
    if values.device.type != "cuda":
        raise ValueError(
            f"compacted_stream: no kernel for device {values.device}")
    dev = values.device
    if values.dim() != 2 or values.shape[-1] < 1:
        raise ValueError(f"values: shape {tuple(values.shape)}, expected "
                         "(B, P) with P >= 1")
    B, P = values.shape
    kernels.check(values, "values", torch.int64, dev)
    kernels.check(valid, "valid", torch.bool, dev, (B, P))
    if not 1 <= W <= MAX_W:
        raise ValueError(f"window of {W} values: the kernel takes 1..{MAX_W}")
    if B > 65535:
        raise ValueError(f"{B} rows: the kernel's grid takes at most 65535")
    if P >= 1 << 30:
        raise ValueError(f"{P} values a row: the kernel takes < 2^30")
    E = 1 + max(P - W + 1, 0)
    keys = torch.empty((B, E), dtype=torch.int64, device=dev)
    emitted = torch.empty((B, E), dtype=torch.bool, device=dev)
    if B:
        scratch = kernels.scratch("bk_compacted_minimizers_gen", (B, P, 0),
                                  dev)
        kernels.launch("bk_compacted_stream", dev, values.data_ptr(),
                       valid.data_ptr(), B, P, W, keys.data_ptr(),
                       emitted.data_ptr(), scratch.data_ptr())
        compacted_stream.launches += 1
    return Emissions(keys, emitted)


compacted_stream.launches = 0


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported (ROADMAP queue A, "
                               f"item {item})")


class BatchEncoder:
    def __init__(self, spacer: Spacer, canonicalize: bool = True,
                 scheme: str = "lex",
                 input_type: InputType = InputType.DNA,
                 score_map: Optional[ScoreMap] = None):
        if scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {scheme}")
        if spacer.k > 32:
            raise _unported(f"k={spacer.k} (128-bit k-mers)", "8.6")
        self.it = InputType(input_type)
        encode.check_k(self.it, spacer.k)
        self.sp = spacer
        self.scheme = scheme
        self.score_map = score_map  # the phase-1 map of the scheme 'hash'
        # spaced seeds cannot canonicalize (encoder.h:148-150), and only
        # DNA has a reverse complement (encoder.h:419)
        self.canon = (bool(canonicalize) and spacer.unspaced()
                      and self.it == DNA)

    def emissions(self, codes: torch.Tensor, lengths: torch.Tensor) -> Emissions:
        """codes: (B, L) int8 (pad with -1); lengths: (B,) int32."""
        sp, it = self.sp, self.it
        if not sp.unspaced():
            return minimizers(codes, lengths, sp.k, sp.window_kmers, False,
                              self.scheme, tuple(int(p) for p in sp.positions),
                              self.score_map, it)
        if sp.unwindowed():  # no window: no score
            return minimizers(codes, lengths, sp.k, 1, self.canon, it=it)
        if self.canon and self.scheme != "entropy":
            return minimizers(codes, lengths, sp.k, sp.window_kmers, True,
                              self.scheme, score_map=self.score_map)
        return compacted_minimizers(codes, lengths, sp.k, sp.window_kmers,
                                    self.scheme, self.score_map, it,
                                    self.canon)

    def emitted_set(self, codes: torch.Tensor,
                    lengths: torch.Tensor) -> np.ndarray:
        """Distinct emitted values of a batch: host numpy u64, sorted
        (encoder.py:223)."""
        em = self.emissions(codes, lengths)
        return np.unique(em.values[em.mask].cpu().numpy().view(np.uint64))
