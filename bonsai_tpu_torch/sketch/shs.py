"""Multi-k k-mer counting and the .shs / .bin dump formats, on a torch
device.

Counterpart of ``bonsai_tpu/sketch/shs.py`` (kmerc::build_kmer_counts /
build_kmer_sets / dump_maps, kmer_counter.h:16-133): one pass of a
rolling-hash ladder over the input (``MultiKRollingEncoder``, the CUDA
kernel KR1), the hashes of each k kept on the device until ``counts``,
then per-k sorted distinct hashes and u16 saturating counts by
``count_hashes`` (the CUDA kernel KS3 ``sort_count``: unsigned order), or
the sets alone by KB2 ``sort_unique`` (``key_sets``, left on the device),
dumped gzipped as

  .shs:  u64 count | u64 sorted hashes            (kmer_counter.h:94-133)
  .bin:  u64 count | u64 sorted keys | u16 counts

byte for byte as the JAX package writes them.

A contig longer than ``max_chunk`` bases goes in chunks that overlap by
max(ks) - 1 bases.  The JAX package counts every window of the overlap
again for each k below max(ks) (max(ks) - k windows a chunk boundary);
here each chunk after a contig's first masks, for each k, the windows
that start in the first max(ks) - k bases, so every window counts once
for every k.  The sets (and so every .shs) are the same; a .bin of a
smaller k has the reference's counts.
"""

from __future__ import annotations

import gzip
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..core.alphabet import DNA4
from ..core.bitops import SIGN, as_keys
from ..core.encode import position_validity
from ..core.rolling import MultiKRollingEncoder
from ..db.build_device import as_device, sort_unique
from ..io import fastx

MAX_CHUNK = 1 << 20  # bases a chunk of a long contig (the JAX default)


def _contig_code_batches(path: str, lut, max_chunk: int = MAX_CHUNK,
                         overlap: int = 0, heads: bool = False) -> Iterator:
    """Yield each contig's int8 codes in chunks of ``max_chunk`` bases,
    each after a contig's first with the ``overlap`` bases before it; with
    ``heads``, (codes, head) where head is how many leading bases the
    previous chunk also held (0 for a contig's first chunk)."""
    for _, seq, _ in fastx.read_fastx(path):
        codes = fastx.encode_contig(seq, lut)
        L = codes.size
        if L == 0:
            continue
        lo = 0
        while lo < L:
            hi = min(lo + max_chunk, L)
            start = max(lo - overlap, 0)
            yield (codes[start:hi], lo - start) if heads else codes[start:hi]
            lo = hi


# -- KS3: sort + run lengths ---------------------------------------------------

def _u16(counts: torch.Tensor) -> torch.Tensor:
    """u16 values held in int16 (the bits of 0..0xFFFF)."""
    return torch.where(counts >= 1 << 15, counts - (1 << 16),
                       counts).to(torch.int16)


def sort_count_plain(keys: torch.Tensor, emitted: torch.Tensor):
    """Plain torch KS3: the n sorted distinct emitted keys (unsigned order)
    and each one's count of copies saturated at 0xFFFF, as (n,) int64 and
    (n,) int16-held u16."""
    u, c = torch.unique(keys[emitted] ^ SIGN, sorted=True, return_counts=True)
    return u ^ SIGN, _u16(c.clamp(max=0xFFFF))


# KS3's plan (csrc/sort_unique.cu, the constants of the same names): the
# emitted keys go to 2^bits buckets by their top bits, bits the least in
# [1, SC_MAX_BITS] that leaves E / 2^bits <= SC_BUCKET_MEAN; a bucket of at
# most SC_CAP keys whose next SC_SUB_BITS bits split it into runs of at
# most SC_SMALL keys is finished in shared memory, any other by the
# block's radix sort through device memory.
SC_MAX_BITS, SC_BUCKET_MEAN, SC_CAP, SC_SUB_BITS, SC_SMALL = 13, 5120, \
    10240, 11, 32


def sort_count_plan(E: int) -> int:
    """The bucket bits of KS3 on E keys (``bk_sort_count_bits``)."""
    b = 1
    while b < SC_MAX_BITS and E >> b > SC_BUCKET_MEAN:
        b += 1
    return b


def sort_count(keys: torch.Tensor, emitted: torch.Tensor):
    """KS3 (``csrc/sort_unique.cu`` ``bk_sort_count``: a partition by the
    top bits, then each bucket sorted and counted by a block): see
    ``sort_count_plain``, which serves CPU tensors.  keys (E,) int64,
    emitted (E,) bool, E < 2^30.  Reads n on the host to slice the
    outputs."""
    if keys.device.type == "cpu":
        return sort_count_plain(keys, emitted)
    if keys.device.type != "cuda":
        raise ValueError(f"sort_count: no kernel for device {keys.device}")
    E = keys.shape[0]
    if E >= 1 << 30:
        raise ValueError(f"sort_count: {E} keys, the kernel takes < 2^30")
    dev = keys.device
    kernels.check(keys, "keys", torch.int64, dev, (E,))
    kernels.check(emitted, "emitted", torch.bool, dev, (E,))
    out = torch.empty(E, dtype=torch.int64, device=dev)
    counts = torch.empty(E, dtype=torch.int16, device=dev)
    n = torch.zeros((), dtype=torch.int64, device=dev)
    if E:
        scratch = kernels.scratch("bk_sort_count", E, dev)
        kernels.launch("bk_sort_count", dev, keys.data_ptr(),
                       emitted.data_ptr(), E, out.data_ptr(),
                       counts.data_ptr(), n.data_ptr(), scratch.data_ptr())
        sort_count.launches += 1
    m = int(n)
    return out[:m], counts[:m]


sort_count.launches = 0


def count_hashes(hashes, valid=None) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted unique u64 hashes and their u16 saturating counts
    (khash_t(i16) analog), as numpy uint64 and uint16: KS3 on the hashes'
    device, over the ``valid`` ones where a mask is given."""
    h = hashes if isinstance(hashes, torch.Tensor) else as_keys(hashes, "cpu")
    if valid is None:
        valid = torch.ones(h.shape, dtype=torch.bool, device=h.device)
    keys, counts = sort_count(h, valid)
    return (keys.cpu().numpy().view(np.uint64),
            counts.cpu().numpy().view(np.uint16))


class MultiKCounter:
    """One-pass multi-k counter over files (RollingHasherSet analog)."""

    def __init__(self, ks: Sequence[int], canon: bool = False,
                 seedseed: int = 1337, lut=None, nthash: bool = False,
                 device="cuda", max_chunk: int = MAX_CHUNK):
        self.ks = list(ks)
        self.device = as_device(device)
        self.enc = MultiKRollingEncoder(self.ks, canon=canon,
                                        seedseed=seedseed, nthash=nthash)
        self.lut = DNA4.lut if lut is None else lut
        self.max_chunk = max_chunk
        # per k: (hashes, valid) of each chunk, on the device
        self._hash_chunks: List[List[Tuple[torch.Tensor, torch.Tensor]]] = [
            [] for _ in self.ks]

    def add_file(self, path: str):
        maxk = max(self.ks)
        for codes, head in _contig_code_batches(path, self.lut,
                                                self.max_chunk, maxk - 1,
                                                heads=True):
            row = torch.from_numpy(codes[None, :]).to(self.device)
            lengths = torch.tensor([codes.size], dtype=torch.int32,
                                   device=self.device)
            for ki, enc in enumerate(self.enc.encoders):
                k = enc.k
                if k > codes.size:  # a k that does not fit this contig
                    continue
                vals, invalid = enc.hashes(row)
                valid = position_validity(lengths, vals.shape[-1], k) & ~invalid
                # the windows the previous chunk counted for this k
                seen = min(max(head - (k - 1), 0), valid.shape[1])
                if seen:
                    valid[:, :seen] = False
                self._hash_chunks[ki].append((vals[0], valid[0]))

    def _streams(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Each k's (hashes, valid) over every chunk, on the device."""
        for chunks in self._hash_chunks:
            if chunks:
                yield (torch.cat([v for v, _ in chunks]),
                       torch.cat([m for _, m in chunks]))
            else:
                yield (torch.empty(0, dtype=torch.int64, device=self.device),
                       torch.empty(0, dtype=torch.bool, device=self.device))

    def counts(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """[(sorted unique hashes, u16 counts)] per k."""
        return [count_hashes(h, ok) for h, ok in self._streams()]

    def key_sets(self) -> List[torch.Tensor]:
        """[sorted unique hashes] per k as (n,) int64 tensors on the
        device (KB2 ``sort_unique``), nothing fetched."""
        out = []
        for h, ok in self._streams():
            keys, _, n = sort_unique(h, ok)
            out.append(keys[:int(n)])
        return out

    def sets(self) -> List[np.ndarray]:
        """[sorted unique hashes] per k (build_kmer_sets analog)."""
        return [s.cpu().numpy().view(np.uint64) for s in self.key_sets()]


# -- dump formats (byte-compatible with kmer_counter.h) ---------------------
def write_shs(path: str, hashes_sorted: np.ndarray):
    with gzip.open(path, "wb") as fh:
        fh.write(np.uint64(hashes_sorted.size).tobytes())
        fh.write(np.ascontiguousarray(hashes_sorted, dtype=np.uint64).tobytes())


def read_shs(path: str) -> np.ndarray:
    with gzip.open(path, "rb") as fh:
        (n,) = np.frombuffer(fh.read(8), dtype=np.uint64)
        return np.frombuffer(fh.read(int(n) * 8), dtype=np.uint64).copy()


def write_bin(path: str, keys: np.ndarray, counts: np.ndarray):
    with gzip.open(path, "wb") as fh:
        fh.write(np.uint64(keys.size).tobytes())
        fh.write(np.ascontiguousarray(keys, dtype=np.uint64).tobytes())
        fh.write(np.ascontiguousarray(counts, dtype=np.uint16).tobytes())


def read_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with gzip.open(path, "rb") as fh:
        (n,) = np.frombuffer(fh.read(8), dtype=np.uint64)
        n = int(n)
        keys = np.frombuffer(fh.read(n * 8), dtype=np.uint64).copy()
        counts = np.frombuffer(fh.read(n * 2), dtype=np.uint16).copy()
        return keys, counts


WRITE_SHS = 1
WRITE_KVMAP = 2


def dump_maps(prefix: str, ks: Sequence[int], path: str, canon: bool = False,
              flag: int = WRITE_SHS | WRITE_KVMAP, lut=None,
              nthash: bool = False, device="cuda") -> List[str]:
    """Count k-mers of ``path`` for each k and dump <prefix>.<k>.shs /
    <prefix>.<k>.bin (dump_maps, kmer_counter.h:94-133; ``nthash`` selects
    the reference's -htype 2 NTC64 backend).  Returns the written file
    names."""
    ctr = MultiKCounter(ks, canon=canon, lut=lut, nthash=nthash,
                        device=device)
    ctr.add_file(path)
    written = []
    for k, (keys, counts) in zip(ks, ctr.counts()):
        if flag & WRITE_KVMAP:
            fn = f"{prefix}.{k}.bin"
            write_bin(fn, keys, counts)
            written.append(fn)
        if flag & WRITE_SHS:
            fn = f"{prefix}.{k}.shs"
            write_shs(fn, keys)
            written.append(fn)
    return written
