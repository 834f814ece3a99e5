"""The plain reference: a Kraken-style classification worked out again
from the genomes and the taxonomy, in numpy and plain torch.

It imports nothing of the program and takes nothing the program made:
it reads a deployment (``deploy.py``) and the reads of a pool
(``traffic.py``) and works out

* ``lca_map``: every canonical k-mer of the database's genomes with the
  LCA of the taxa of the genomes that hold it (the build's content);
* ``kmer_taxa``: the same value for given k-mers only (0 where no genome
  holds one), which is all a read's classification needs;
* ``kraken_line``: a read's Kraken record (``C``/``U``, name, taxon,
  length, ``M:`` the valid k-mers that miss, ``A:`` the positions with
  an ambiguous base, then the hit taxa run-length coded, in k-mer
  order), its taxon the LCA of the hit taxa of highest score, where a
  taxon's score is the count of hits on it and on its ancestors.

A k-mer is the 2-bit code of k bases (A 0, C 1, G 2, T 3; the first base
highest), canonical as the smaller of it and its reverse complement; a
window with any other base holds none.  ``control=True`` breaks one
guarantee of the configuration: each k-mer keeps the taxon of the first
genome that holds it instead of the LCA of all of them, as a build that
let its first writer win would.  ``image_taxa`` reads keys back through
a slot image, the table the program placed, by the table's format.

The heavy part (every k-mer of every genome) runs as plain torch
operations on the device given, a card after the measured window, the
CPU in tests.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

LUT = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate(b"ACGT"):
    LUT[_c] = _i
    LUT[_c | 32] = _i
AMBIG_WRAP = 1 << 32


class Taxonomy:
    """The parent map as arrays over compact indices, with vectorised LCA."""

    def __init__(self, parent: Dict[int, int]):
        ids = sorted(set(parent) | {p for p in parent.values() if p})
        self.ids = np.array(ids, dtype=np.int64)
        idx = {t: i for i, t in enumerate(ids)}
        # the root, and a taxon only named as a parent, are their own
        self.parent = np.array([idx[parent[t]] if parent.get(t) else idx[t]
                                for t in ids], dtype=np.int64)
        depth = np.zeros(len(ids), dtype=np.int64)
        for i in range(len(ids)):
            d, j = 0, i
            while self.parent[j] != j:
                j = self.parent[j]
                d += 1
            depth[i] = d
        self.depth = depth
        self._anc: Dict[int, set] = {}

    def index(self, taxids) -> np.ndarray:
        t = np.asarray(taxids, dtype=np.int64)
        i = np.searchsorted(self.ids, t)
        if np.any(i >= self.ids.size) or np.any(self.ids[np.minimum(
                i, self.ids.size - 1)] != t):
            raise ValueError("a taxid outside the taxonomy")
        return i

    def lca_idx(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Pairwise LCA of compact indices."""
        a, b = a.copy(), b.copy()
        while True:
            da, db = self.depth[a], self.depth[b]
            up_a, up_b = da > db, db > da
            if not (up_a.any() or up_b.any()):
                break
            a[up_a] = self.parent[a[up_a]]
            b[up_b] = self.parent[b[up_b]]
        ne = a != b
        while ne.any():
            a[ne] = self.parent[a[ne]]
            b[ne] = self.parent[b[ne]]
            ne = a != b
        return a

    def lca(self, a: int, b: int) -> int:
        i = self.index([a, b])
        return int(self.ids[self.lca_idx(i[:1], i[1:])[0]])

    def ancestors(self, t: int) -> set:
        """``t`` and every taxon above it."""
        got = self._anc.get(t)
        if got is None:
            j = int(self.index([t])[0])
            got = {int(self.ids[j])}
            while self.parent[j] != j:
                j = int(self.parent[j])
                got.add(int(self.ids[j]))
            self._anc[t] = got
        return got


def fold(keys: np.ndarray, taxids: np.ndarray, tax: Taxonomy,
         control: bool = False):
    """(distinct keys, each one's LCA taxid) of (key, taxid) pairs given
    in genome order; ``control``: each key's first taxid."""
    order = np.argsort(keys, kind="stable")
    k, t = keys[order], taxids[order]
    if not k.size:
        return k, t
    head = np.ones(k.size, dtype=bool)
    head[1:] = k[1:] != k[:-1]
    starts = np.flatnonzero(head)
    out = tax.index(t[starts])
    if not control:
        size = np.diff(np.append(starts, k.size))
        ti = tax.index(t)
        for j in range(1, int(size.max())):
            more = size > j
            out[more] = tax.lca_idx(out[more], ti[starts[more] + j])
    return k[starts], tax.ids[out]


def codes_of(bases: np.ndarray, device) -> torch.Tensor:
    """int8 codes (-1 for any base but ACGT) of uint8 ASCII bases."""
    lut = torch.from_numpy(LUT).to(device)
    return lut[torch.from_numpy(np.array(bases, dtype=np.uint8)).to(device)
               .to(torch.int64)]


def genome_kmers(records: List[np.ndarray], k: int, canonical: bool,
                 device) -> torch.Tensor:
    """The distinct k-mers (int64, ascending) of a genome's records."""
    parts = []
    for rec in records:
        if rec.size < k:
            continue
        km, ok = kmers(codes_of(rec, device), k, canonical)
        parts.append(km[ok])
    if not parts:
        return torch.zeros(0, dtype=torch.int64, device=device)
    return torch.unique(torch.cat(parts))


def kmers(codes: torch.Tensor, k: int, canonical: bool):
    """(k-mer at each start, whether its window holds k ACGT bases) of an
    int8 code row (-1 ambiguous), k <= 31."""
    if not 1 <= k <= 31:
        raise ValueError(f"k={k}: the reference takes 1 <= k <= 31")
    n = codes.numel() - k + 1
    c = codes.clamp(min=0).to(torch.int64)
    fwd = torch.zeros(n, dtype=torch.int64, device=codes.device)
    rev = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for j in range(k):
        fwd = (fwd << 2) | c[j:j + n]
        rev = rev | ((3 - c[j:j + n]) << (2 * j))
    bad = torch.zeros(codes.numel() + 1, dtype=torch.int64,
                      device=codes.device)
    bad[1:] = torch.cumsum((codes < 0).to(torch.int64), 0)
    ok = bad[k:] == bad[:n]
    return (torch.minimum(fwd, rev) if canonical else fwd), ok


def lca_map(dep, device, control: bool = False):
    """(keys uint64 ascending, LCA taxids uint32) of every k-mer of the
    database's genomes."""
    tax = Taxonomy(dep.parent)
    keys, taxa = [], []
    for g in dep.genomes:
        km = genome_kmers(g.records, dep.k, dep.canonical, device).cpu().numpy()
        keys.append(km)
        taxa.append(np.full(km.size, g.taxid, dtype=np.int64))
    k, t = fold(np.concatenate(keys), np.concatenate(taxa), tax, control)
    return k.astype(np.uint64), t.astype(np.uint32)


def kmer_taxa(dep, queries: np.ndarray, device,
              control: bool = False) -> np.ndarray:
    """The LCA taxid (0: no genome holds it) of each of ``queries``
    (distinct k-mers, int64 ascending)."""
    tax = Taxonomy(dep.parent)
    q = torch.from_numpy(queries).to(device)
    qi, gt = [], []
    for g in dep.genomes:
        km = genome_kmers(g.records, dep.k, dep.canonical, device)
        if not q.numel() or not km.numel():
            continue
        at = torch.searchsorted(q, km).clamp(max=q.numel() - 1)
        found = at[q[at] == km].cpu().numpy()
        qi.append(found)
        gt.append(np.full(found.size, g.taxid, dtype=np.int64))
    out = np.zeros(queries.size, dtype=np.int64)
    if qi:
        k, t = fold(np.concatenate(qi), np.concatenate(gt), tax, control)
        out[k] = t
    return out


def read_kmers(pool, reads: np.ndarray, k: int, canonical: bool, device):
    """[(k-mers, valid)] of the pool's ``reads``, worked out together: the
    reads end to end, a window that crosses a read's end not taken."""
    seqs = [pool.read(int(i)) for i in reads]
    if not seqs:
        return []
    km, ok = kmers(codes_of(np.concatenate(seqs), device), k, canonical) \
        if sum(s.size for s in seqs) >= k else (None, None)
    km = km.cpu().numpy() if km is not None else None
    ok = ok.cpu().numpy() if ok is not None else None
    out, at = [], 0
    for s in seqs:
        n = max(s.size - k + 1, 0)
        out.append((km[at:at + n], ok[at:at + n]) if n else
                   (np.zeros(0, np.int64), np.zeros(0, bool)))
        at += s.size
    return out


def resolve(hits: np.ndarray, tax: Taxonomy) -> int:
    """The taxon of a read's hit taxa: the LCA of those of highest score,
    a taxon's score the hits on it and on its ancestors; 0 for none."""
    if not hits.size:
        return 0
    uniq, cnt = np.unique(hits, return_counts=True)
    count = dict(zip(uniq.tolist(), cnt.tolist()))
    score = {t: sum(count[a] for a in tax.ancestors(t) if a in count)
             for t in count}
    best = max(score.values())
    tied = [t for t in sorted(score) if score[t] == best]
    out = tied[0]
    for t in tied[1:]:
        out = tax.lca(out, t)
    return out


def _runs(hits: np.ndarray) -> List[str]:
    if not hits.size:
        return []
    edge = np.flatnonzero(np.diff(hits)) + 1
    starts = np.concatenate([[0], edge])
    ends = np.concatenate([edge, [hits.size]])
    return [f"{int(hits[s])}:{int(e - s)}" for s, e in zip(starts, ends)]


def kraken_line(name: str, length: int, taxa: np.ndarray, valid: np.ndarray,
                k: int, tax: Taxonomy) -> Optional[str]:
    """A read's Kraken record from its per-position taxa (0: no hit) and
    valid flags, or None for an unclassified read (the CLI's default
    writes none)."""
    hit = valid & (taxa != 0)
    hits = taxa[hit]
    taxon = resolve(hits, tax)
    if not taxon:
        return None
    n_valid = int(valid.sum())
    cols = ["C", name, str(taxon), str(length)]
    missing = n_valid - int(hit.sum())
    ambig = (length - k + 1 - n_valid) % AMBIG_WRAP
    if missing:
        cols.append(f"M:{missing}")
    if ambig:
        cols.append(f"A:{ambig}")
    cols += _runs(hits)
    return "\t".join(cols) + "\n"


def kraken_lines(dep, pool, judged: np.ndarray, device,
                 control: bool = False) -> Dict[str, Optional[str]]:
    """{name: Kraken record or None} of the pool's reads ``judged``."""
    tax = Taxonomy(dep.parent)
    per = read_kmers(pool, judged, dep.k, dep.canonical, device)
    qs = [km[ok] for km, ok in per]
    queries = np.unique(np.concatenate(qs)) if qs else np.zeros(0, np.int64)
    value = kmer_taxa(dep, queries, device, control)
    out = {}
    for i, (km, ok) in zip(judged, per):
        taxa = np.zeros(km.size, dtype=np.int64)
        if ok.any():
            taxa[ok] = value[np.searchsorted(queries, km[ok])]
        out[pool.name(int(i))] = kraken_line(
            pool.name(int(i)), int(pool.lengths[i]), taxa, ok, dep.k, tax)
    return out


# -- the slot image a classifier uploads --------------------------------------
#
# The table's format (``db/table.py`` of the program states it): a bucket
# is a row of four u64 slots; a key's hash h = splitmix64(key), its first
# bucket h & (nb - 1), its quotient q = h >> lg(nb), its second bucket the
# first xor (splitmix64(q ^ BSALT) & (nb - 1)); a slot holds
# [occupied:1 | choice:1 | q | value index:lg(nb) - 2], its value the
# index into the image's distinct values (inline) or the slot's entry of
# a (nb, 4) value array; a value is the taxid << 32 | a tree index.

BSALT = np.uint64(0xA24BAED4963EE407)
OCCUPIED = np.uint64(1) << np.uint64(63)


def splitmix64(x: np.ndarray) -> np.ndarray:
    u = np.uint64
    x = np.asarray(x, dtype=np.uint64) + u(0x9E3779B97F4A7C15)
    x = (x ^ (x >> u(30))) * u(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> u(27))) * u(0x94D049BB133111EB)
    return x ^ (x >> u(31))


def image_taxa(slots: np.ndarray, vals: np.ndarray, inline: bool,
               keys: np.ndarray):
    """(slots that hold a key, [taxid a slot of each of ``keys`` holds,
    0 where none does, -1 where both buckets do]) of a slot image read
    by the format above, in blocks of keys."""
    slots = np.asarray(slots, dtype=np.uint64)
    nb = slots.shape[0]
    lgnb = nb.bit_length() - 1
    vbits = np.uint64(max(lgnb - 2, 0))
    vmask = (np.uint64(1) << vbits) - np.uint64(1)
    flat = slots.reshape(-1)
    out = np.zeros(keys.size, dtype=np.int64)
    for s in range(0, keys.size, 1 << 22):
        h = splitmix64(keys[s:s + (1 << 22)])
        b1 = h & np.uint64(nb - 1)
        q = h >> np.uint64(lgnb)
        b2 = b1 ^ (splitmix64(q ^ BSALT) & np.uint64(nb - 1))
        got = np.zeros(h.size, dtype=np.int64)
        seen = np.zeros(h.size, dtype=np.int64)
        for choice, b in ((0, b1), (1, b2)):
            want = OCCUPIED | (np.uint64(choice) << np.uint64(62)) | (
                q << vbits)
            rows = slots[b.astype(np.int64)]
            match = (rows & ~vmask) == want[:, None]
            hit = match.any(axis=1)
            col = match.argmax(axis=1)
            seen += match.sum(axis=1)
            word = rows[np.arange(h.size), col]
            if inline:
                v = np.asarray(vals, np.uint64)[(word & vmask).astype(
                    np.int64)]
            else:
                v = np.asarray(vals, np.uint64).reshape(-1)[
                    b.astype(np.int64) * 4 + col]
            got = np.where(hit, (v >> np.uint64(32)).astype(np.int64), got)
        got[seen > 1] = -1
        out[s:s + h.size] = got
    occupied = int(np.count_nonzero(flat & OCCUPIED))
    return occupied, out


def map_differ(ref_vals: np.ndarray, taxa: np.ndarray, held: int) -> int:
    """The keys of the reference's map that a table gets wrong (missing,
    held twice or under another taxon), and the keys it holds beyond the
    map's: ``taxa`` is the table's answer a reference key, ``held`` the
    keys the table holds."""
    wrong = int(np.count_nonzero(np.asarray(taxa, np.int64)
                                 != np.asarray(ref_vals, np.int64)))
    return wrong + abs(int(held) - int(np.asarray(ref_vals).size))
