"""Positional k-mer inverted index: k-mer -> global positions.

Counterpart of ``bonsai_tpu/db/kmeridx.py`` (the reference's
bns::KmerIdx, kmeridx.h:11-132): a CSR triple (sorted distinct k-mers,
row offsets, positions) queried by searchsorted, with the same numpy
results.

Positions are the global index of a k-mer's LAST base across the
concatenated contigs (kmeridx.h:49-54).  Each contig's 2-bit k-mers come
from KB1 (``BatchEncoder(Spacer(k, k), canonicalize=False).emissions``:
unwindowed, contiguous, uncanonical DNA) on ``device``, in chunks of
``BLOCK`` windows that overlap by a k - 1 base halo; its mask is the JAX
package's ``~invalid`` of ``pack_kmers`` + ``apply_mask``.  ``finalize``
sorts the u64 keys stably on ``device`` (``torch.sort`` with bit 63
flipped, the order of the JAX package's ``np.argsort(kind="stable")``).
The results come back to the host as numpy arrays.

File format of the reference writer (kmeridx.h:113-131), a gzip stream
of
  u32 k | u32 nnames | u64 seqlens[nnames] | names (LF lines) |
  comments (LF lines) | { u64 kmer | u32 nelem | u64 positions } *
``write`` lays the records out in one vectorised pass (every field lies
on a 4-byte boundary) and gzips at zlib's default level, the reference's
``gzopen(path, "wb")``; the decompressed bytes are the JAX writer's.
"""

from __future__ import annotations

import gzip
import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.alphabet import DNA4
from ..core.bitops import SIGN, as_keys
from ..core.encoder import BatchEncoder
from ..core.spacer import Spacer
from ..io import fastx
from .build import BLOCK
from .build_device import as_device


class KmerIdx:
    def __init__(self, k: int, path: Optional[str] = None, lut=None,
                 device="cuda"):
        if k > 32:
            raise ValueError("k must be <= 32")
        self.k = k
        self.device = as_device(device)
        self.refnames: List[bytes] = []
        self.comments: List[bytes] = []
        self.seqlens: List[int] = []
        self.keys = np.empty(0, dtype=np.uint64)
        self.offsets = np.zeros(1, dtype=np.int64)
        self.positions = np.empty(0, dtype=np.uint64)
        # (k-mers, positions) of contigs added since the last finalize, as
        # int64 tensors on the device
        self._pending: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self._cum = 0
        self._lut = DNA4.lut if lut is None else lut
        self._enc = BatchEncoder(Spacer(k, k), canonicalize=False)
        if path:
            self.make_idx(path)

    # -- build -------------------------------------------------------------
    def add_seq(self, name: bytes, seq: bytes, comment: bytes = b""):
        """One contig: its valid k-mers and their positions, KB1 on the
        device over chunks of ``BLOCK`` windows."""
        self.refnames.append(name)
        self.comments.append(comment)
        self.seqlens.append(len(seq))
        k, block = self.k, BLOCK
        start = 0
        while len(seq) >= k:
            end = min(start + block + k - 1, len(seq))
            codes = torch.from_numpy(
                fastx.encode_contig(seq[start:end], self._lut)).to(self.device)
            lengths = torch.tensor([end - start], dtype=torch.int32,
                                   device=self.device)
            em = self._enc.emissions(codes[None, :], lengths)
            at = torch.nonzero(em.mask[0]).squeeze(1)
            self._pending.append(
                (em.values[0, at], at + (start + k - 1 + self._cum)))
            if end >= len(seq):
                break
            start += block
        self._cum += len(seq)

    def make_idx(self, path: str):
        for name, seq, _ in fastx.read_fastx(path):
            self.add_seq(name, seq)
        self.finalize()

    def finalize(self):
        if not self._pending:
            return
        dev = self.device
        kmers = torch.cat([km for km, _ in self._pending])
        pos = torch.cat([p for _, p in self._pending])
        if self.keys.size:
            # fold in existing content
            old = torch.repeat_interleave(
                as_keys(self.keys, dev),
                torch.from_numpy(np.diff(self.offsets)).to(dev))
            kmers = torch.cat([old, kmers])
            pos = torch.cat([as_keys(self.positions, dev), pos])
        # stable sort by the unsigned key: the signed order of key ^ bit 63
        _, order = torch.sort(kmers ^ SIGN, stable=True)
        kmers, pos = kmers[order], pos[order]
        uniq = torch.ones(kmers.shape[0], dtype=torch.bool, device=dev)
        uniq[1:] = kmers[1:] != kmers[:-1]
        starts = torch.nonzero(uniq).squeeze(1)
        self.keys = kmers[starts].cpu().numpy().view(np.uint64)
        self.offsets = np.append(starts.cpu().numpy(),
                                 kmers.shape[0]).astype(np.int64)
        self.positions = pos.cpu().numpy().view(np.uint64)
        self._pending = []

    # -- query -------------------------------------------------------------
    def get(self, kmer: int) -> np.ndarray:
        i = int(np.searchsorted(self.keys, np.uint64(kmer)))
        if i < self.keys.size and self.keys[i] == np.uint64(kmer):
            return self.positions[self.offsets[i] : self.offsets[i + 1]]
        return np.empty(0, dtype=np.uint64)

    def contig_of(self, gpos: int) -> Tuple[bytes, int]:
        """(refname, local position) for a global position."""
        cum = np.cumsum([0] + self.seqlens)
        ci = int(np.searchsorted(cum, gpos, side="right")) - 1
        return self.refnames[ci], int(gpos - cum[ci])

    def __len__(self) -> int:
        return int(self.keys.size)

    # -- serialization (reference byte layout) -----------------------------
    def write(self, path: str):
        self.finalize()
        head = (np.uint32(self.k).tobytes()
                + np.uint32(len(self.refnames)).tobytes()
                + np.asarray(self.seqlens, dtype=np.uint64).tobytes()
                + b"".join(n + b"\n" for n in self.refnames)
                + b"".join(c + b"\n" for c in self.comments))
        with gzip.open(path, "wb", compresslevel=6) as fh:
            fh.write(head)
            fh.write(_records(self.keys, self.offsets, self.positions))

    @classmethod
    def read(cls, path: str, device="cuda") -> "KmerIdx":
        with gzip.open(path, "rb") as fh:
            data = fh.read()
        (k, nnames) = struct.unpack_from("<II", data, 0)
        idx = cls(int(k), device=device)
        at = 8 + 8 * nnames
        idx.seqlens = list(np.frombuffer(data[8:at], dtype=np.uint64))
        for names in (idx.refnames, idx.comments):
            for _ in range(nnames):
                nl = data.find(b"\n", at)
                nl = len(data) if nl < 0 else nl
                names.append(data[at:nl])
                at = nl + 1
        # the records' starts: one pass, since each record's length is in it
        starts, counts = [], []
        rec = at
        while rec + 12 <= len(data):
            (n,) = struct.unpack_from("<I", data, rec + 8)
            starts.append(rec)
            counts.append(n)
            rec += 12 + 8 * n
        # from here every field lies on a 4-byte boundary of the records
        words = np.frombuffer(data[at:at + (len(data) - at) // 4 * 4],
                              dtype=np.uint32)
        w = (np.asarray(starts, dtype=np.int64) - at) // 4
        counts = np.asarray(counts, dtype=np.int64)
        keys = _u64(words, w)
        order = np.argsort(keys, kind="stable")
        idx.keys = keys[order]
        counts = counts[order]
        idx.offsets = np.concatenate([[0], np.cumsum(counts)])
        first = np.repeat(w[order] + 3, counts)
        nth = np.arange(first.size) - np.repeat(idx.offsets[:-1], counts)
        idx.positions = _u64(words, first + 2 * nth)
        idx._cum = int(sum(idx.seqlens))
        return idx


def _u64(words: np.ndarray, at: np.ndarray) -> np.ndarray:
    """The little-endian u64 of each pair of u32 words at ``at``."""
    return (words[at].astype(np.uint64)
            | words[at + 1].astype(np.uint64) << np.uint64(32))


def _records(keys: np.ndarray, offsets: np.ndarray,
             positions: np.ndarray) -> np.ndarray:
    """The { u64 kmer | u32 nelem | u64 positions } records of the CSR
    triple, as one array of u32 words: record i starts at word 3 i + 2
    offsets[i], and position j of record i at word 3 (i + 1) + 2 j."""
    n, m = keys.size, positions.size
    words = np.empty(3 * n + 2 * m, dtype=np.uint32)
    rec = 3 * np.arange(n, dtype=np.int64) + 2 * offsets[:-1]
    k32 = np.ascontiguousarray(keys, dtype=np.uint64).view(np.uint32)
    words[rec] = k32[0::2]
    words[rec + 1] = k32[1::2]
    words[rec + 2] = np.diff(offsets).astype(np.uint32)
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
    at = 3 * (row + 1) + 2 * np.arange(m, dtype=np.int64)
    p32 = np.ascontiguousarray(positions, dtype=np.uint64).view(np.uint32)
    words[at] = p32[0::2]
    words[at + 1] = p32[1::2]
    return words
