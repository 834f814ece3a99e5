"""Disk-backed k-mer x taxon bit matrix.

Counterpart of ``bonsai_tpu/db/diskarray.py`` (the reference's
DiskBitArray / MMapTaxonomyBitmap, diskarray.h:32-118, and its filler
bitmap_filler_helper, tx.h:250-266): a memory-mapped bit matrix too big
for RAM, with a k-mer -> row index.  The reference's per-bit
__sync_or_and_fetch loop is one ``np.bitwise_or.at`` a batch over a
``np.memmap``, from one writer.  Host numpy, as in the JAX package; the
file bytes are the same.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np


class DiskBitArray:
    """(n_rows, n_cols) bit matrix backed by a file."""

    def __init__(self, path: str, n_rows: int, n_cols: int,
                 create: bool = False):
        self.path = path
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)
        self.row_bytes = (self.n_cols + 7) >> 3
        mode = "w+" if create else "r+"
        self.mm = np.memmap(
            path, dtype=np.uint8, mode=mode,
            shape=(self.n_rows, self.row_bytes),
        )

    def set_bits(self, rows: np.ndarray, cols: np.ndarray):
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        np.bitwise_or.at(
            self.mm, (rows, cols >> 3), (1 << (cols & 7)).astype(np.uint8)
        )

    def get_bit(self, row: int, col: int) -> bool:
        return bool((self.mm[row, col >> 3] >> (col & 7)) & 1)

    def row(self, row: int) -> np.ndarray:
        """Unpacked boolean row."""
        return (
            np.unpackbits(self.mm[row], bitorder="little")[: self.n_cols]
            .astype(bool)
        )

    def popcounts(self) -> np.ndarray:
        """Per-row set-bit counts (streamed)."""
        out = np.empty(self.n_rows, dtype=np.int64)
        step = max(1, (1 << 24) // max(self.row_bytes, 1))
        lut = np.unpackbits(
            np.arange(256, dtype=np.uint8)[:, None], axis=1
        ).sum(1)
        for lo in range(0, self.n_rows, step):
            hi = min(lo + step, self.n_rows)
            out[lo:hi] = lut[self.mm[lo:hi]].sum(axis=1)
        return out

    def flush(self):
        self.mm.flush()


class MMapTaxonomyBitmap:
    """kmer -> taxon-presence bit rows (diskarray.h MMapTaxonomyBitmap):
    rows indexed by position in the sorted kmer key array."""

    def __init__(self, path: str, keys_sorted: np.ndarray, n_taxa: int,
                 create: bool = False):
        self.keys = np.asarray(keys_sorted, dtype=np.uint64)
        self.bits = DiskBitArray(path, self.keys.size, n_taxa, create)
        if create:
            with open(path + ".meta", "w") as fh:
                json.dump({"n_rows": int(self.keys.size),
                           "n_cols": int(n_taxa)}, fh)

    @classmethod
    def open(cls, path: str, keys_sorted: np.ndarray) -> "MMapTaxonomyBitmap":
        with open(path + ".meta") as fh:
            meta = json.load(fh)
        return cls(path, keys_sorted, meta["n_cols"], create=False)

    def set_kmers(self, kmers: np.ndarray, taxon_col: int):
        """Mark `kmers` present for taxon column (bitmap_filler_helper,
        tx.h:250-266); kmers absent from the key set are ignored."""
        kmers = np.asarray(kmers, dtype=np.uint64)
        idx = np.searchsorted(self.keys, kmers)
        idx = np.minimum(idx, self.keys.size - 1)
        ok = self.keys[idx] == kmers
        rows = idx[ok]
        self.bits.set_bits(rows, np.full(rows.size, taxon_col))

    def kmer_row(self, kmer: int) -> Optional[np.ndarray]:
        i = int(np.searchsorted(self.keys, np.uint64(kmer)))
        if i < self.keys.size and self.keys[i] == np.uint64(kmer):
            return self.bits.row(i)
        return None

    def flush(self):
        self.bits.flush()
