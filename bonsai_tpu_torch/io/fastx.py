"""FASTA/FASTQ input: record reading and read batches.

Counterpart of ``bonsai_tpu/io/fastx.py``.  ``read_fastx`` yields whole
records (genome contigs for the database build); ``batch_reads`` yields
``ReadBatch``es parsed by the port's C++ parser (``native/fastx.py``) for
plain and gzip files, and by ``read_fastx`` through Python's
decompressors for .xz, .bz2 and .zst (the zstd binary where it is on the
path, else the zstandard module), as the reference reads them
(encoder.h:510-530).  Read length pads to a multiple of 32 so that the
2-bit upload (16 codes per u32 word) tiles exactly.
"""

from __future__ import annotations

import bz2
import gzip
import io
import lzma
import shutil
import subprocess
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np


def open_maybe_compressed(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    if path.endswith(".xz"):
        return lzma.open(path, "rb")
    if path.endswith(".bz2"):
        return bz2.open(path, "rb")
    if path.endswith(".zst"):
        if shutil.which("zstd"):
            proc = subprocess.Popen(["zstd", "-dc", path],
                                    stdout=subprocess.PIPE)
            return proc.stdout
        try:
            import zstandard  # type: ignore

            return zstandard.open(path, "rb")
        except ImportError as e:
            raise RuntimeError(
                "no zstd binary or zstandard module available for .zst input"
            ) from e
    return open(path, "rb")


def read_fastx(path: str) -> Iterator[Tuple[bytes, bytes, Optional[bytes]]]:
    """Yield (name, seq, qual) records; name is the header up to the first
    space, qual is None for FASTA."""
    with _buffered(path) as fh:
        first = fh.peek(1)[:1]
        if not first:
            return
        if first == b">":
            yield from _read_fasta(fh)
        elif first == b"@":
            yield from _read_fastq(fh)
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _buffered(path) -> io.BufferedReader:
    fh = open_maybe_compressed(path)
    if hasattr(fh, "peek"):
        return fh
    return io.BufferedReader(fh)


def _parse_fasta_record(rec: bytes):
    hdr_end = rec.find(b"\n")
    if hdr_end < 0:
        hdr_end = len(rec)
    name = rec[1:hdr_end].rstrip(b"\r").split(b" ", 1)[0].split(b"\t", 1)[0]
    seq = rec[hdr_end + 1 :].replace(b"\n", b"").replace(b"\r", b"")
    return name, seq, None


def _read_fasta(fh):
    # records split on '\n>' in large chunks; newlines stripped with
    # bytes.replace
    rest = b""
    while True:
        chunk = fh.read(1 << 23)
        if not chunk:
            break
        rest += chunk
        start = 0
        while True:
            nxt = rest.find(b"\n>", start)
            if nxt < 0:
                break
            yield _parse_fasta_record(rest[start:nxt])
            start = nxt + 1
        if start:
            rest = rest[start:]
    if rest.strip():
        yield _parse_fasta_record(rest)


def _read_fastq(fh):
    while True:
        hdr = fh.readline()
        if not hdr:
            return
        hdr = hdr.rstrip(b"\r\n")
        if not hdr:
            continue
        seq = fh.readline().rstrip(b"\r\n")
        fh.readline()  # '+'
        qual = fh.readline().rstrip(b"\r\n")
        yield hdr[1:].split(b" ", 1)[0], seq, qual


def first_header(path: str) -> str:
    """The first line of a file (a FASTA/FASTQ header), stripped."""
    with _buffered(path) as fh:
        return fh.readline().decode("utf-8", "replace").strip()


def encode_contig(seq: bytes, lut: np.ndarray) -> np.ndarray:
    """Bytes -> int8 codes through an alphabet's LUT (-1 = ambiguous)."""
    return np.asarray(lut, dtype=np.int8)[np.frombuffer(seq, dtype=np.uint8)]


def trim_readno(name: bytes) -> bytes:
    """Strip a '/<digit>' mate suffix (kseq_declare.h trim_readno)."""
    if len(name) > 2 and name[-2:-1] == b"/" and name[-1:].isdigit():
        return name[:-2]
    return name


@dataclass
class ReadBatch:
    names: List[bytes]
    seqs: List[bytes]
    codes: np.ndarray  # (B, L) int8, -1 pad/ambiguous
    lengths: np.ndarray  # (B,) int32
    quals: Optional[List[Optional[bytes]]] = None


def bucket_len(n: int, min_len: int = 64) -> int:
    """Round a read length up to the next length bucket (1.25x steps),
    a multiple of 32."""
    L = min_len
    while L < n:
        L += max(L // 4, 32)
    return (L + 31) & ~31


def _native_ok(path: Optional[str]) -> bool:
    """Whether the C++ parser reads ``path``: plain and .gz files."""
    return path is None or not path.endswith((".xz", ".bz2", ".zst"))


def batch_reads(path: str, lut: np.ndarray, batch_size: int = 4096,
                mate_path: Optional[str] = None) -> Iterator[ReadBatch]:
    """Yield read batches; with ``mate_path`` the mates of a pair are
    adjacent rows (2i, 2i+1), as bseq_read lays out paired input."""
    if _native_ok(path) and _native_ok(mate_path):
        yield from _batch_reads_native(path, lut, batch_size, mate_path)
    else:
        yield from _batch_reads_python(path, lut, batch_size, mate_path)


def _batch_reads_python(path, lut, batch_size, mate_path):
    """The record reader's batches: ``batch_size`` records, mates
    alternating (a pair never straddles batches when it is even)."""
    it = read_fastx(path)
    mate_it = read_fastx(mate_path) if mate_path else None

    def records():
        for r1 in it:
            yield r1
            if mate_it is not None:
                yield next(mate_it)

    names: List[bytes] = []
    seqs: List[bytes] = []
    quals: List[Optional[bytes]] = []
    for name, seq, qual in records():
        names.append(trim_readno(name))
        seqs.append(seq)
        quals.append(qual)
        if len(names) >= batch_size:
            yield _make_batch(names, seqs, quals, lut)
            names, seqs, quals = [], [], []
    if names:
        yield _make_batch(names, seqs, quals, lut)


def _make_batch(names, seqs, quals, lut) -> ReadBatch:
    L = bucket_len(max((len(s) for s in seqs), default=1))
    codes = np.full((len(seqs), L), -1, dtype=np.int8)
    lengths = np.empty(len(seqs), dtype=np.int32)
    lut = np.asarray(lut, dtype=np.int8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = lut[np.frombuffer(s, dtype=np.uint8)]
        lengths[i] = len(s)
    return ReadBatch(names=names, seqs=seqs, codes=codes, lengths=lengths,
                     quals=quals)


def _batch_reads_native(path, lut, batch_size, mate_path):
    from ..native.fastx import NativeFastxReader

    r1 = NativeFastxReader(path)
    r2 = NativeFastxReader(mate_path) if mate_path else None
    try:
        if r2 is None:
            while True:
                got = r1.next_batch(batch_size, lut, bucket_len)
                if got is None:
                    return
                names, seqs, quals, codes, lengths = got
                yield ReadBatch(names=names, seqs=seqs, codes=codes,
                                lengths=lengths, quals=quals)
        half = max(batch_size // 2, 1)
        while True:
            g1 = r1.next_batch(half, lut, bucket_len)
            g2 = r2.next_batch(half, lut, bucket_len)
            if g1 is None or g2 is None:
                return
            yield _interleave(g1, g2)
    finally:
        r1.close()
        if r2 is not None:
            r2.close()


def _interleave(g1, g2) -> ReadBatch:
    n1, s1, q1, c1, l1 = g1
    n2, s2, q2, c2, l2 = g2
    n = min(len(n1), len(n2))
    L = max(c1.shape[1], c2.shape[1])
    codes = np.full((2 * n, L), -1, dtype=np.int8)
    codes[0::2, : c1.shape[1]] = c1[:n]
    codes[1::2, : c2.shape[1]] = c2[:n]
    lengths = np.empty(2 * n, dtype=np.int32)
    lengths[0::2], lengths[1::2] = l1[:n], l2[:n]

    def mix(a, b):
        out = [None] * (2 * n)
        out[0::2], out[1::2] = a[:n], b[:n]
        return out

    return ReadBatch(names=mix(n1, n2), seqs=mix(s1, s2), codes=codes,
                     lengths=lengths, quals=mix(q1, q2))
