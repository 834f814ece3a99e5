"""Synthetic inputs for K2 ``resolve`` where the ec batch does not reach:
a taxonomy of NCBI's size and depth (``deep_tree``), rows over it whose
reads each walk a real LCA (``deep_rows``), and long reads (P > 1024,
``long_reads``); and protein for the Python API's alphabets and the
other-alphabet builds, the forward reading frames of a genome
(``translate``, ``write_frames``).  ``chip_smoke.py``,
``kernel_ab`` and the tests make them from a numpy seed or the repo's
genomes.
"""

from __future__ import annotations

import numpy as np

from ..io import fastx
from ..taxonomy.tree import TaxTree


def deep_tree(rng, n: int = 1 << 21, depth: int = 40, full: int = 25,
              grow: float = 1.6) -> TaxTree:
    """A synthetic taxonomy of ``n`` nodes shaped like NCBI's: level d
    holds up to grow^(d-1) nodes (the same count at every level past the
    geometric part, so that the levels sum to ``n``), each node below
    level ``full`` has a child, so lineages end at depths ``full`` to
    ``depth`` (``lift`` has 6 levels at the defaults); parents are drawn
    at random from the level above; taxids are a random permutation, so
    compact order follows no lineage.  Root: taxid 1."""
    sizes = [1]
    while len(sizes) < depth:
        sizes.append(int(np.ceil(grow ** len(sizes))))
    for d in range(1, depth):
        cap = (n - sum(sizes[:d])) // (depth - d)
        sizes[d] = max(sizes[d - 1] if d < full else 1, min(sizes[d], cap))
    sizes[-1] += n - sum(sizes)
    taxids = np.concatenate([[1], rng.permutation(np.arange(2, n + 1))])
    par = np.zeros(n, dtype=np.int64)
    start, prev = 1, np.zeros(1, dtype=np.int64)
    for d in range(1, depth):
        p = rng.integers(0, prev.size, sizes[d])
        if d < full:  # every node above ``full`` gets a child
            k = min(sizes[d], prev.size)
            p[:k] = np.arange(k)
        idx = np.arange(start, start + sizes[d])
        par[idx] = prev[p]
        prev, start = idx, start + sizes[d]
    ptax = np.where(np.arange(n) == 0, 0, taxids[par])
    return TaxTree(dict(zip(taxids.tolist(), ptax.tolist())))


def _climb(tree: TaxTree, x, steps):
    """The ancestor ``steps`` levels above each node of ``x``."""
    x, steps = x.copy(), np.asarray(steps).copy()
    while (steps > 0).any():
        up = steps > 0
        x[up] = tree.parent[x[up]]
        steps[up] -= 1
    return x


def deep_rows(rng, tree: TaxTree, R: int = 8192, W: int = 74,
              p_hit: float = 0.6, split: int = 22):
    """(cidx, hit) numpy rows of R reads over ``tree`` (``deep_tree``):
    each read picks a leaf L whose ancestor A at depth ``split`` has
    leaves under two of its children, and a leaf S under another child of
    A than L's; a position hits with probability ``p_hit``; a fifth of
    the hits fall on A's lineage, the rest half on L's lineage below A
    and half on S's.  The deepest hit of each side then scores the same,
    so every read ties two taxa below A and walks their LCA through every
    level of ``lift``."""
    depth = tree.depth
    kids = np.bincount(tree.parent[1:], minlength=depth.size)
    leaves = np.flatnonzero(kids == 0)
    leaves = leaves[leaves > 0]
    clade = _climb(tree, leaves, depth[leaves] - split)
    sub = _climb(tree, leaves, depth[leaves] - split - 1)
    order = np.lexsort((sub, clade))
    leaves, clade, sub = leaves[order], clade[order], sub[order]
    both = clade * depth.size + sub
    lo = np.searchsorted(clade, clade)
    cnt = np.searchsorted(clade, clade, side="right") - lo
    sub_lo = np.searchsorted(both, both)
    sub_cnt = np.searchsorted(both, both, side="right") - sub_lo
    i = rng.choice(np.flatnonzero(cnt > sub_cnt), R)
    j = lo[i] + (rng.random(R) * (cnt[i] - sub_cnt[i])).astype(np.int64)
    j = np.where(j >= sub_lo[i], j + sub_cnt[i], j)
    L, S, A = leaves[i], leaves[j], clade[i]
    hit = rng.random((R, W)) < p_hit
    key = np.where(hit, rng.random((R, W)), 2.0)
    rank = np.empty((R, W), dtype=np.int64)
    np.put_along_axis(rank, np.argsort(key, axis=1),
                      np.arange(W)[None, :].repeat(R, 0), axis=1)
    m = hit.sum(1)
    shared = m // 5 + (m - m // 5) % 2
    half = (m - shared) // 2
    side = np.where(rank < shared[:, None], 0,
                    np.where(rank < (shared + half)[:, None], 1, 2))
    base = np.choose(side, [A[:, None], L[:, None], S[:, None]])
    lim = np.choose(side, [np.full((R, 1), split), (depth[L] - split)[:, None],
                           (depth[S] - split)[:, None]])
    cidx = _climb(tree, base.ravel(),
                  (rng.random((R, W)) * lim).astype(np.int64).ravel())
    return np.where(hit, cidx.reshape(R, W), 0).astype(np.int32), hit


def long_reads(genome: str, lut, rng, R: int = 64):
    """R reads of 1100-4000 bases cut from the first record of ``genome``,
    one base in 50 replaced at random, so that they hit several taxa and
    miss: a batch with P > 1024."""
    seq = next(iter(fastx.read_fastx(genome)))[1]
    starts = rng.integers(0, len(seq) - 4000, R)
    lens = rng.integers(1100, 4000, R)
    seqs = [bytearray(seq[s : s + n]) for s, n in zip(starts, lens)]
    for s in seqs:
        for j in rng.integers(0, len(s), len(s) // 50):
            s[j] = b"ACGT"[rng.integers(0, 4)]
    seqs = [bytes(s) for s in seqs]
    L = fastx.bucket_len(int(lens.max()))
    codes = np.full((R, L), -1, dtype=np.int8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = lut[np.frombuffer(s, dtype=np.uint8)]
    return fastx.ReadBatch(names=[b"r"] * R, seqs=seqs, codes=codes,
                           lengths=lens.astype(np.int32), quals=[None] * R)


# the standard genetic code, codons in TCAG order (NCBI translation table 1)
CODE = b"FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"


def translate(seq: bytes, frame: int) -> bytes:
    """Reading frame ``frame`` (0-2) of a DNA sequence as one-letter
    protein by the standard code: stops as '*', a codon with a base other
    than ACGT as 'X'."""
    idx = np.full(256, -1, np.int64)
    for i, b in enumerate(b"TCAG"):
        idx[b] = idx[b | 32] = i
    c = idx[np.frombuffer(seq, np.uint8)[frame:]]
    c = c[: c.size // 3 * 3].reshape(-1, 3)
    code = np.frombuffer(CODE, np.uint8)
    aa = code[(c[:, 0] * 16 + c[:, 1] * 4 + c[:, 2]) % 64]
    return np.where((c < 0).any(1), ord("X"), aa).astype(np.uint8).tobytes()


def write_frames(genome: str, out: str, width: int = 80) -> str:
    """The three forward reading frames of every record of ``genome``,
    translated (``translate``), as the FASTA file ``out``, lines of
    ``width`` residues: record ``<name> frame <f>`` for each record name
    and f = 0, 1, 2, in that order, so that the file's first accession is
    the genome's and a nameidmap of the genomes resolves it.  Returns
    ``out``."""
    with open(out, "wb") as fh:
        for name, seq, _ in fastx.read_fastx(genome):
            for f in range(3):
                aa = translate(seq, f)
                fh.write(b">%s frame %d\n" % (name, f))
                fh.write(b"\n".join(aa[i : i + width]
                                    for i in range(0, len(aa), width)))
                fh.write(b"\n")
    return out


AMINO20 = b"ACDEFGHIKLMNPQRSTVWY"


def protein_reads(frames, n: int, seed: int, length: int = 33,
                  sub: float = 0.02, ambiguous: float = 0.01,
                  random_share: float = 0.1, paired: bool = False):
    """``n`` protein reads of ``length`` residues (33: the translated frame
    of a 100-bp read) drawn from the records of the FASTA files ``frames``
    (``write_frames``) by ``numpy.random.default_rng(seed)``: a start
    uniform over every record's windows, then a residue in 50 (``sub``)
    replaced by one of the 20 amino acids, one in 100 (``ambiguous``) by
    'X'; a share ``random_share`` of the reads are random residues
    instead.  With ``paired``, read i's mate follows it on the same record
    after a gap of 0-30 residues (its own substitutions and 'X's), and
    the result is (reads, mates).  Returns lists of bytes."""
    rng = np.random.default_rng(seed)
    recs = [np.frombuffer(s, np.uint8) for p in frames
            for _, s, _ in fastx.read_fastx(p)]
    span = 2 * length + 30 if paired else length
    starts = np.array([max(r.size - span + 1, 0) for r in recs], np.int64)
    ends = np.cumsum(starts)
    pick = rng.integers(0, int(ends[-1]), n)
    rec = np.searchsorted(ends, pick, side="right")
    off = pick - (ends[rec] - starts[rec])
    gap = rng.integers(0, 31, n) if paired else np.zeros(n, np.int64)
    aa = np.frombuffer(AMINO20, np.uint8)
    rand = rng.random(n) < random_share

    def cut(at):
        out = np.empty((n, length), np.uint8)
        for r in np.unique(rec):
            rows = np.flatnonzero(rec == r)
            out[rows] = recs[r][at[rows, None] + np.arange(length)]
        mut = rng.random((n, length))
        out = np.where(mut < sub, aa[rng.integers(0, 20, (n, length))], out)
        out = np.where(rng.random((n, length)) < ambiguous, ord("X"), out)
        out[rand] = aa[rng.integers(0, 20, (int(rand.sum()), length))]
        return [row.tobytes() for row in out]

    reads = cut(off)
    if not paired:
        return reads
    return reads, cut(off + length + gap)


def write_reads(path: str, reads) -> str:
    """The reads as FASTA records ``>r<i>``; returns ``path``."""
    with open(path, "wb") as fh:
        for i, r in enumerate(reads):
            fh.write(b">r%d\n%s\n" % (i, r))
    return path


# The read sets of chip_smoke.py's phase 9k (classify of the other
# alphabets) and of tests/alphabet_classify_jax.py, which pins their
# Kraken text from the JAX package: name -> (reads, seed, paired, the
# number of genomes (in the manifest's order) whose frames they come from)
ALPHABET_READ_SETS = {
    "PROTEIN20 single": (200_000, 20261041, False, 5),
    "PROTEIN20 paired": (100_000, 20261042, True, 5),
    "PROTEIN_3BIT single": (50_000, 20261043, False, 2),
}
