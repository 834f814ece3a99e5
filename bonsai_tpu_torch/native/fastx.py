"""ctypes wrapper over the port's C++ FASTA/FASTQ batch parser
(``native/src/fastx.cpp``): parsing, the names' trim (the header up to its
first space or tab, then a '/<digit>' mate suffix off), LUT encoding and
pad-fill of a batch in one C++ pass.  The batch's names, sequences and
qualities leave it as ``io.fastx.Strings`` over the arenas it filled: no
Python object a read.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..io.fastx import Strings
from . import get_lib


class NativeFastxReader:
    def __init__(self, path: str):
        lib = get_lib()
        self.lib = lib
        self.h = lib.btpu_fastx_open(path.encode())
        if not self.h:
            raise FileNotFoundError(path)

    def close(self):
        if self.h:
            self.lib.btpu_fastx_close(self.h)
            self.h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def next_batch(self, max_reads: int, lut: np.ndarray, bucket_len):
        """Parse up to max_reads records.  Returns None at EOF, else
        (names, seqs, quals, codes, lengths): names and seqs ``Strings``,
        quals ``Strings`` for FASTQ and a list of None for FASTA."""
        lib, h = self.lib, self.h
        n = lib.btpu_next_batch(h, max_reads)
        if n < 0:
            raise ValueError(lib.btpu_last_error(h).decode())
        if n == 0:
            return None
        nb = ctypes.c_int64()
        sb = ctypes.c_int64()
        qb = ctypes.c_int64()
        maxlen = ctypes.c_int32()
        has_qual = ctypes.c_int32()
        lib.btpu_batch_info(
            h,
            ctypes.byref(nb),
            ctypes.byref(sb),
            ctypes.byref(qb),
            ctypes.byref(maxlen),
            ctypes.byref(has_qual),
        )
        L = bucket_len(max(int(maxlen.value), 1))
        names_arena = np.empty(max(nb.value, 1), dtype=np.uint8)
        seqs_arena = np.empty(max(sb.value, 1), dtype=np.uint8)
        quals_arena = np.empty(max(qb.value, 1), dtype=np.uint8)
        name_offs = np.empty(n + 1, dtype=np.int64)
        seq_offs = np.empty(n + 1, dtype=np.int64)
        qual_offs = np.empty(n + 1, dtype=np.int64)
        codes = np.empty((n, L), dtype=np.int8)
        lengths = np.empty(n, dtype=np.int32)
        lut8 = np.ascontiguousarray(lut, dtype=np.int8)
        if lut8.size != 256:
            raise ValueError(f"LUT must have 256 entries, got {lut8.size}")
        lib.btpu_batch_fill(
            h,
            names_arena.ctypes.data,
            name_offs.ctypes.data,
            seqs_arena.ctypes.data,
            seq_offs.ctypes.data,
            quals_arena.ctypes.data,
            qual_offs.ctypes.data,
            lut8.ctypes.data,
            codes.ctypes.data,
            L,
            lengths.ctypes.data,
        )
        names = Strings(names_arena, name_offs)
        seqs = Strings(seqs_arena, seq_offs)
        quals = (Strings(quals_arena, qual_offs) if has_qual.value
                 else [None] * n)
        return names, seqs, quals, codes, lengths
