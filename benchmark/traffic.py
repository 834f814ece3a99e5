"""The read generator: one general generator that every traffic mix's
data file (``traffic/<mix>.json``) parameterises.

A pool is ``pool`` reads of two origins, in proportions the mix states:

* ``database``: reads drawn from the deployment's genomes, uniformly
  over them, with the read lengths of the mix's reads file (its length
  histogram scaled to the count) and the mix's error model;
* ``file``: the reads of the mix's reads file (real reads of organisms
  that the database may or may not hold), each taken equally often and
  as they are, without errors added.

Every seed gets the same multiset of reads' lengths, the same number of
reads from each genome and of each file read, and the same number of
reverse-complemented reads; the seed draws where in the genomes the
reads start, which of them takes which length and strand, where the
errors fall and the reads' order.  So two seeds give the same work in
another order, and the time of a pass does not follow the seed.

The mix's keys:

* ``reads_file``: ``{"path", "sha256"}`` of a FASTA file of reads in the
  checkout;
* ``origins``: the shares of ``database`` and ``file``, summing to 1;
* ``errors``: per-base ``substitution`` and ``n`` (an N in place of the
  base) rates, and ``reverse_complement``, the share of the database
  reads taken from the reverse strand;
* ``pool``: the reads a pass classifies.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .deploy import BASES, Deployment, pinned, read_fasta

COMPLEMENT = np.arange(256, dtype=np.uint8)
COMPLEMENT[np.frombuffer(b"ACGTacgt", np.uint8)] = np.frombuffer(b"TGCAtgca",
                                                                np.uint8)
CHUNK = 1 << 23  # bases of a generation step's (reads, longest) matrix


def rng_of(seed: int, tag: int) -> np.random.Generator:
    """A generator of the run's ``seed`` (any integer), one stream a tag."""
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed) % (1 << 64), tag])))


def largest_remainder(shares, n: int) -> np.ndarray:
    """Counts summing to ``n`` in proportion to ``shares``."""
    w = np.asarray(shares, dtype=np.float64)
    exact = w / w.sum() * n
    counts = np.floor(exact).astype(np.int64)
    left = n - int(counts.sum())
    counts[np.argsort(-(exact - counts), kind="stable")[:left]] += 1
    return counts


def length_multiset(file_lengths: np.ndarray, n: int) -> np.ndarray:
    """The ``n`` read lengths every seed shares, ascending: the length
    histogram of the reads file scaled by largest remainders."""
    ln, cnt = np.unique(np.asarray(file_lengths, np.int64),
                        return_counts=True)
    return np.repeat(ln, largest_remainder(cnt, n))


@dataclass
class Pool:
    """A pass's reads, held as the FASTA file the program reads: record i
    is ``>r<i>`` (``name(i)``) and its bases on one line, which are
    ``buf[start[i]:start[i] + lengths[i]]``; ``origin`` is 0 database,
    1 file."""

    buf: np.ndarray  # uint8, the FASTA file
    start: np.ndarray  # int64 (n,)
    lengths: np.ndarray  # int64 (n,)
    origin: np.ndarray  # int8 (n,)
    width: int  # digits of a read's number in its name

    @classmethod
    def empty(cls, lengths, origin) -> "Pool":
        """A pool of reads of ``lengths`` with the headers and line ends
        written and the bases still to fill."""
        lengths = np.asarray(lengths, dtype=np.int64)
        n = lengths.size
        width = max(len(str(max(n - 1, 0))), 1)
        h = width + 3
        rec = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(h + lengths + 1, out=rec[1:])
        buf = np.empty(int(rec[-1]), dtype=np.uint8)
        if buf.size >= 1 << 31:
            raise ValueError("a pool of 2 GiB or more")
        digits = np.arange(n, dtype=np.int64)
        head = np.empty((n, h), dtype=np.uint8)
        head[:, 0] = ord(">")
        head[:, 1] = ord("r")
        head[:, h - 1] = ord("\n")
        for j in range(width):
            head[:, h - 2 - j] = ord("0") + digits % 10
            digits //= 10
        buf[(rec[:-1, None] + np.arange(h)).ravel()] = head.ravel()
        buf[rec[1:] - 1] = ord("\n")
        return cls(buf, rec[:-1] + h, lengths, np.asarray(origin, np.int8),
                   width)

    @property
    def n(self) -> int:
        return self.lengths.size

    @property
    def bases(self) -> int:
        return int(self.lengths.sum())

    def name(self, i: int) -> str:
        return f"r{i:0{self.width}d}"

    def read(self, i: int) -> np.ndarray:
        return self.buf[self.start[i]:self.start[i] + self.lengths[i]]

    def fasta(self) -> np.ndarray:
        return self.buf

    def valid_kmers(self, k: int) -> np.ndarray:
        """Per read, its positions whose k bases hold no N (the k-mers a
        read can probe)."""
        bad = np.zeros(self.buf.size + 1, dtype=np.int64)
        np.cumsum((self.buf == ord("N")) | (self.buf == ord("n")),
                  out=bad[1:])
        m = max(self.buf.size - k + 1, 0)
        good = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(bad[k:k + m] == bad[:m], out=good[1:])
        ok = self.lengths >= k
        s = self.start[ok]
        out = np.zeros(self.n, dtype=np.int64)
        out[ok] = good[s + self.lengths[ok] - k + 1] - good[s]
        return out


def _fill(rng, pool, flat, tstart, rc, mutate, err, at, end) -> None:
    """Reads ``at:end`` of ``pool``: each template ``flat[tstart:tstart +
    length]``, gathered as one (reads, longest) matrix and reversed and
    complemented where ``rc``; where ``mutate``, a base substituted by
    another ACGT base at the ``substitution`` rate and made an N at the
    ``n`` rate."""
    ln = pool.lengths[at:end]
    r = rc[at:end]
    # int32 offsets (the library and the file are under 2 GiB): a row's
    # j-th base is first + step * j, its step -1 where it is reversed
    j = np.arange(int(ln.max()) if ln.size else 0, dtype=np.int32)
    inside = j[None, :] < ln[:, None]
    step = np.where(r, -1, 1).astype(np.int32)
    first = (tstart[at:end] + np.where(r, ln - 1, 0)).astype(np.int32)
    idx = first[:, None] + step[:, None] * j
    idx[~inside] = 0
    m = flat[idx]
    m[r] = COMPLEMENT[m[r]]
    # events at uniform cells of the matrix, kept inside mutable reads
    keep = inside & mutate[at:end, None]
    for rate, apply in ((float(err.get("substitution", 0.0)), _substitute),
                        (float(err.get("n", 0.0)), _make_n)):
        cells = _events(rng, m.size, rate)
        cells = cells[keep.reshape(-1)[cells]]
        apply(rng, m.reshape(-1), cells)
    pool.buf[(pool.start[at:end, None].astype(np.int32) + j)[inside]] = \
        m[inside]


def _events(rng, m: int, p: float) -> np.ndarray:
    """Positions of events at rate ``p`` in ``m`` cells (a binomial count
    at uniform positions)."""
    if not p or not m:
        return np.zeros(0, dtype=np.int64)
    return rng.integers(0, m, rng.binomial(m, p))


def _substitute(rng, t: np.ndarray, at: np.ndarray) -> None:
    code = np.searchsorted(BASES, t[at])
    ok = (code < 4) & (BASES[np.minimum(code, 3)] == t[at])
    at, code = at[ok], code[ok]
    t[at] = BASES[(code + rng.integers(1, 4, at.size)) & 3]


def _make_n(rng, t: np.ndarray, at: np.ndarray) -> None:
    t[at] = ord("N")


def reads_file(traffic: dict, root: str):
    """[uint8 ASCII bases] of the mix's pinned reads file."""
    return [s for _, s in read_fasta(pinned(root, traffic["reads_file"]))]


def make_pool(traffic: dict, dep: Deployment, seed: int, root: str) -> Pool:
    """The pass's reads for ``seed`` (see the module docstring); ``root``
    is the checkout the reads file's path is relative to."""
    n = int(traffic["pool"])
    rng = rng_of(seed, 1)
    shares = traffic["origins"]
    if abs(sum(shares.values()) - 1.0) > 1e-9 or set(shares) - {"database",
                                                              "file"}:
        raise ValueError(f"origins {shares}: database and file shares "
                         "summing to 1")
    n_db, n_file = largest_remainder(
        [shares.get("database", 0.0), shares.get("file", 0.0)], n)
    file_reads = reads_file(traffic, root)
    # the library: every genome record, then every file read, end to end
    recs = [r for g in dep.genomes for r in g.records] + file_reads
    at = np.zeros(len(recs) + 1, dtype=np.int64)
    np.cumsum([r.size for r in recs], out=at[1:])
    flat = np.concatenate(recs)
    if flat.size >= 1 << 31:
        raise ValueError("a library of 2 GiB or more")
    per_genome = largest_remainder(np.ones(len(dep.genomes)), int(n_db))
    lengths = length_multiset([r.size for r in file_reads], int(n_db))[
        rng.permutation(int(n_db))]
    tstart = np.zeros(int(n_db), dtype=np.int64)
    g0, r0 = 0, 0
    for g, cnt in zip(dep.genomes, per_genome):
        sizes = np.array([r.size for r in g.records], dtype=np.int64)
        want = lengths[g0:g0 + cnt]
        rec = rng.choice(sizes.size, int(cnt), p=sizes / sizes.sum())
        if np.any(want > sizes[rec]):
            raise ValueError(f"{g.name}: a record shorter than a read")
        tstart[g0:g0 + cnt] = at[r0 + rec] + (
            rng.random(int(cnt)) * (sizes[rec] - want + 1)).astype(np.int64)
        g0 += int(cnt)
        r0 += len(g.records)
    fidx = np.repeat(np.arange(len(file_reads)),
                     largest_remainder(np.ones(len(file_reads)), int(n_file)))
    fbase = len(recs) - len(file_reads)
    tstart = np.concatenate([tstart, at[fbase + fidx]])
    lengths = np.concatenate([lengths, np.diff(at)[fbase + fidx]])
    origin = np.repeat(np.array([0, 1], np.int8), [n_db, n_file])
    rc = np.zeros(n, dtype=bool)
    rc[rng.permutation(int(n_db))[:int(round(float(
        traffic["errors"].get("reverse_complement", 0)) * n_db))]] = True
    order = rng.permutation(n)
    tstart, lengths, origin, rc = (tstart[order], lengths[order],
                                   origin[order], rc[order])
    pool = Pool.empty(lengths, origin)
    step = int(lengths.max()) if n else 1
    done = 0
    while done < n:
        end = min(done + max(CHUNK // step, 1), n)
        _fill(rng, pool, flat, tstart, rc, origin == 0, traffic["errors"],
              done, end)
        done = end
    return pool
