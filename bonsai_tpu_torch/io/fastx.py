"""FASTA/FASTQ input: record reading and read batches.

Counterpart of ``bonsai_tpu/io/fastx.py``.  ``read_fastx`` yields whole
records (genome contigs for the database build); ``batch_reads`` yields
``ReadBatch``es parsed by the port's C++ parser (``native/fastx.py``) for
plain and gzip files, and by ``read_fastx`` through Python's
decompressors for .xz, .bz2 and .zst (the zstd binary where it is on the
path, else the zstandard module), as the reference reads them
(encoder.h:510-530).  Read length pads to a multiple of 32 so that the
2-bit upload (16 codes per u32 word) tiles exactly.

A batch from the C++ parser holds its names, sequences and (FASTQ)
qualities as ``Strings``: one byte arena and its prefix offsets each, as
the parser filled them, so that no per-read Python object is made
between the parser and the C++ Kraken formatter, which reads the names'
arena in place.  Every other batch holds lists of ``bytes``; a consumer
indexes, slices and iterates both alike.
"""

from __future__ import annotations

import bz2
import gzip
import io
import lzma
import shutil
import subprocess
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

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


class Strings(Sequence[bytes]):
    """A read-only sequence of ``bytes`` held as one uint8 ``arena`` and
    its ``n + 1`` int64 prefix ``offs``: item i is
    ``arena[offs[i]:offs[i + 1]]``, and ``offs[0]`` need not be 0 (a slice
    is a view of its parent's offsets).  ``[i]`` gives ``bytes``; a slice
    of step 1 gives a ``Strings`` over the same arena, any other step a
    list; it equals a list, or another ``Strings``, of the same bytes."""

    __slots__ = ("arena", "offs")

    def __init__(self, arena: np.ndarray, offs: np.ndarray):
        self.arena = arena
        self.offs = offs

    @classmethod
    def of(cls, items) -> "Strings":
        """The arena and offsets of an iterable of ``bytes``."""
        items = list(items)
        offs = np.zeros(len(items) + 1, dtype=np.int64)
        np.cumsum([len(x) for x in items], out=offs[1:])
        return cls(np.frombuffer(b"".join(items), dtype=np.uint8), offs)

    def __len__(self) -> int:
        return len(self.offs) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                return self.tolist()[i]
            return Strings(self.arena, self.offs[start : max(start, stop) + 1])
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError("Strings index out of range")
        return self.arena[self.offs[i] : self.offs[i + 1]].tobytes()

    def tolist(self) -> List[bytes]:
        """The items as a list of ``bytes``: one copy of the arena, one
        slice an item."""
        o = (self.offs - self.offs[0]).tolist()
        buf = self.arena[self.offs[0] : self.offs[-1]].tobytes()
        return [buf[a:b] for a, b in zip(o, o[1:])]

    def __iter__(self):
        return iter(self.tolist())

    def __eq__(self, other):
        if isinstance(other, Strings):
            other = other.tolist()
        if isinstance(other, list):
            return self.tolist() == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"Strings({self.tolist()!r})"


@dataclass
class ReadBatch:
    """B reads (mates alternating when paired).  ``names``, ``seqs`` and
    ``quals`` are lists of ``bytes``, or ``Strings`` where the C++ parser
    made the batch (``quals`` is then ``Strings`` for FASTQ and a list of
    None for FASTA, as the record reader gives)."""

    names: Sequence[bytes]
    seqs: Sequence[bytes]
    codes: np.ndarray  # (B, L) int8, -1 pad/ambiguous
    lengths: np.ndarray  # (B,) int32
    quals: Optional[Sequence[Optional[bytes]]] = None


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
