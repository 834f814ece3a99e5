"""Database builds on the host: the classify map (kmer -> LCA taxid), the
two phase-1 maps and the hash-scored phase 2.

Counterpart of ``bonsai_tpu/db/build.py`` for DNA seeds with k <= 32
and the schemes lex, entropy-file (``build -e``) and hash (``build
-t|-f --phase1-db``):

* ``lca_map``, contiguous and unwindowed: each genome's distinct
  (canonical) k-mers come from the host C++ ``btpu_canon_kmer_set``;
* ``lca_map``, every other discipline (``-w``, ``-C -w``, ``-S``,
  ``-e``): the plain torch encoder (``core/encoder.py``) runs on
  halo-overlapped chunks of each contig, as ``_contig_sets`` does
  (build.py:134-169), the trailing partial window of a non-final chunk
  dropped where the uncanonical windowed discipline makes one;
* ``taxdepth_map`` (TDencode(depth, lca)) and ``ftct_map``
  ((n_genomes << 32) | lca), lex scores (build.py:594,620);
* ``minimized_map`` (build.py:644): the genomes' minimizers under the
  phase-1 map's score::Hash order, each kept with the low 32 bits
  (the taxid) of its phase-1 value.

Genomes fold in with the shared k-way merge ``btpu_merge_fold_stats``,
which emits per-key Euler-interval extrema (and the group size) that map
to the LCA on the host.  LCA folding is associative and commutative, so
the content is the JAX package's bit for bit.  The device build of the
same maps is ``db/build_device.py``.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import os
from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.alphabet import DNA4
from ..core.encoder import BatchEncoder
from ..core.spacer import Spacer
from ..io import fastx
from ..native import get_lib
from ..taxonomy.ncbi import parse_nameid_map, taxid_for_path
from ..taxonomy.tree import TaxTree
from .table import KmerTable, ScoreMap, unique_u64

TAX_T_MAX = 0xFFFFFFFF
U64_MAX = (1 << 64) - 1


def TDencode(depth, taxid):
    """Tax-depth value: ((~0 - depth) << 32) | taxid (feature_min.h:10-20)."""
    return ((TAX_T_MAX - np.asarray(depth, dtype=np.uint64)) << np.uint64(32)
            ) | np.asarray(taxid, dtype=np.uint64)


def FMencode(count, taxid):
    """Feature-count value: (count << 32) | taxid."""
    return (np.asarray(count, dtype=np.uint64) << np.uint64(32)
            ) | np.asarray(taxid, dtype=np.uint64)


FOLD_EVERY = 8  # genomes buffered between folds (bounds host memory)
BLOCK = 1 << 22  # windows per chunk of the windowed encoder (the JAX default)


def _check(sp: Spacer, canonicalize: bool, scheme: str = "lex",
           score_map: ScoreMap | None = None) -> None:
    if not 1 <= sp.k <= 32:
        raise ValueError(f"k={sp.k}: the build supports 1 <= k <= 32")
    # the encoder raises for every discipline that is not ported
    BatchEncoder(sp, canonicalize, scheme, score_map=score_map)


def genome_kmer_set(path: str, sp: Spacer, canonicalize: bool = True,
                    scheme: str = "lex",
                    score_map: ScoreMap | None = None) -> np.ndarray:
    """Sorted distinct emitted (canonical) k-mers or minimizers of one
    genome (fill_set_genome, feature_min.h:67-82)."""
    _check(sp, canonicalize, scheme, score_map)
    lib = get_lib()
    lut = np.ascontiguousarray(DNA4.lut, dtype=np.int8)
    # only the contiguous unwindowed discipline takes the host C++ path
    # (_native_kmer_fn, build.py:105-131)
    native = sp.unspaced() and sp.unwindowed()
    enc = None if native else BatchEncoder(sp, canonicalize, scheme,
                                           score_map=score_map)
    pieces = []
    for _, seq, _ in fastx.read_fastx(path):
        if len(seq) < sp.c:
            continue
        if enc is not None:
            pieces.extend(_contig_sets(enc, seq, lut, sp, BLOCK))
            continue
        buf = np.frombuffer(seq, dtype=np.uint8)
        out = np.empty(len(seq), dtype=np.uint64)
        m = lib.btpu_canon_kmer_set(buf.ctypes.data, len(seq), lut.ctypes.data,
                                    sp.k, int(canonicalize), out.ctypes.data)
        if m < 0:
            raise ValueError("btpu_canon_kmer_set failed")
        pieces.append(out[:m])
    if not pieces:
        return np.zeros(0, dtype=np.uint64)
    return unique_u64(np.concatenate(pieces))


def drops_partial_window(sp: Spacer, enc: BatchEncoder) -> bool:
    """Whether a non-final chunk loses its column 0 (build.py:151-166):
    the trailing partial window of the uncanonical windowed discipline
    is not a real contig end there.  The rule is the JAX package's: it
    holds wherever w > c and the seed is uncanonical, spaced seeds too."""
    return sp.w > sp.c and not enc.canon


def _contig_sets(enc: BatchEncoder, seq: bytes, lut, sp: Spacer,
                 block: int) -> List[np.ndarray]:
    """Emissions of one contig through the plain encoder, in chunks of
    ``block`` windows that overlap by a w - 1 base halo."""
    out = []
    halo = sp.w - 1
    start = 0
    while start < len(seq):
        end = min(start + block + halo, len(seq))
        is_last = end >= len(seq)
        codes = torch.from_numpy(fastx.encode_contig(seq[start:end], lut))
        em = enc.emissions(codes[None, :],
                           torch.tensor([end - start], dtype=torch.int32))
        mask = em.mask
        if not is_last and drops_partial_window(sp, enc):
            mask = mask.clone()
            mask[:, 0] = False
        out.append(em.values[mask].numpy().view(np.uint64))
        if is_last:
            break
        start += block
    return out


def _fold_stats_to_taxa(tree: TaxTree, tmin, tmax, n_miss, n_nz, mmin, mmax):
    """Per-key group stats -> folded taxids with the reference lca()
    contract (util.h:634-663): 0 is the identity, a taxid absent from the
    tree poisons the fold to 0xFFFFFFFF unless every non-zero member is
    that same taxid, disjoint roots resolve to 1."""
    n = tree.tin.shape[0]
    node_of_tin = np.zeros(int(tree.tin.max()) + 2, dtype=np.int32)
    node_of_tin[tree.tin[1:]] = np.arange(1, n, dtype=np.int32)
    has_pres = tmax >= 0
    a = node_of_tin[np.where(has_pres, tmin, 0)]
    b = node_of_tin[np.where(has_pres, tmax, 0)]
    # (a, b) range over a tiny domain (the input taxa): LCA each distinct
    # pair once through a table
    pres_mask = np.zeros(n, dtype=bool)
    pres_mask[a] = True
    pres_mask[b] = True
    dom = np.flatnonzero(pres_mask)
    if dom.size <= 1024:
        rank = np.cumsum(pres_mask, dtype=np.int32) - 1
        la, lb = np.meshgrid(dom, dom, indexing="ij")
        lca_tab = tree._lca_compact(
            la.ravel().astype(np.int32), lb.ravel().astype(np.int32)
        ).reshape(dom.size, dom.size)
        r = lca_tab[rank[a], rank[b]]
    else:
        r = tree._lca_compact(a, b)
    out = tree.tax_ids_compact()[r]
    out = np.where(has_pres & (r == 0), np.uint32(1), out)  # disjoint roots
    if n_miss.any():
        all_same_missing = (~has_pres) & (n_miss > 0) & (mmin == mmax)
        out = np.where(
            (n_miss > 0) & ~all_same_missing, np.uint32(0xFFFFFFFF), out
        )
        out = np.where(all_same_missing, mmin, out)
    if not n_nz.all():
        out = np.where(n_nz == 0, np.uint32(0), out)
    return out.astype(np.uint32)


def lca_fold_runs(acc_keys: np.ndarray, acc_taxa: np.ndarray,
                  runs: List[Tuple[np.ndarray, int]], tree: TaxTree,
                  want_counts: bool = False):
    """Fold sorted-unique runs [(kset, taxid)] into the accumulated
    (keys, taxa) state with one k-way merge; returns the new state, and
    with ``want_counts`` each key's group size (the number of runs, plus
    the state, that hold it: the ftct genome count)."""
    n = tree.tin.shape[0]
    BIG = np.int32(2 * n + 4)
    key_arrs, tin_arrs, tval_arrs, tin_consts, tval_consts = [], [], [], [], []
    if acc_keys.size:
        t = np.ascontiguousarray(acc_taxa, dtype=np.uint32)
        ut = unique_u64(t).astype(np.uint32)
        cu = tree.compact(ut, missing_ok=True)
        tin_u = np.where(cu != 0, tree.tin[cu], BIG).astype(np.int32)
        key_arrs.append(np.ascontiguousarray(acc_keys, dtype=np.uint64))
        tin_arrs.append(np.ascontiguousarray(tin_u[np.searchsorted(ut, t)]))
        tval_arrs.append(t)
        tin_consts.append(0)
        tval_consts.append(0)
    for kset, taxid in runs:
        if not len(kset):
            continue
        cix = int(tree.compact(np.array([taxid], dtype=np.uint32),
                               missing_ok=True)[0])
        key_arrs.append(np.ascontiguousarray(kset, dtype=np.uint64))
        tin_arrs.append(None)
        tval_arrs.append(None)
        tin_consts.append(int(tree.tin[cix]) if cix != 0 else int(BIG))
        tval_consts.append(int(taxid) & 0xFFFFFFFF)
    G = len(key_arrs)
    if G == 0:
        empty = (np.zeros(0, np.uint64), np.zeros(0, np.uint32))
        return empty + ((np.zeros(0, np.int64),) if want_counts else ())
    N = sum(a.size for a in key_arrs)
    out_keys = np.empty(N, dtype=np.uint64)
    tmin = np.empty(N, dtype=np.int32)
    tmax = np.empty(N, dtype=np.int32)
    nmiss, nnz, mmin, mmax, count = (np.empty(N, dtype=np.uint32)
                                     for _ in range(5))
    ptrs = ctypes.c_void_p * G
    lens = np.array([a.size for a in key_arrs], dtype=np.int64)
    tic = np.array(tin_consts, dtype=np.int32)
    tvc = np.array(tval_consts, dtype=np.uint32)
    m = get_lib().btpu_merge_fold_stats(
        G, ptrs(*[a.ctypes.data for a in key_arrs]), lens.ctypes.data,
        ptrs(*[None if a is None else a.ctypes.data for a in tin_arrs]),
        tic.ctypes.data,
        ptrs(*[None if a is None else a.ctypes.data for a in tval_arrs]),
        tvc.ctypes.data, int(BIG), out_keys.ctypes.data, tmin.ctypes.data,
        tmax.ctypes.data, nmiss.ctypes.data, nnz.ctypes.data,
        mmin.ctypes.data, mmax.ctypes.data, count.ctypes.data,
    )
    taxa = _fold_stats_to_taxa(tree, tmin[:m], tmax[:m], nmiss[:m], nnz[:m],
                               mmin[:m], mmax[:m])
    if want_counts:
        return out_keys[:m].copy(), taxa, count[:m].astype(np.int64)
    return out_keys[:m].copy(), taxa


def _genome_sets(paths: Sequence[str], sp: Spacer, canonicalize: bool,
                 name_map: Dict[str, int], scheme: str = "lex",
                 score_map: ScoreMap | None = None):
    """Yield (kset, taxid) per genome in order; the k-mer extraction
    releases the GIL, so a few genomes run at a time in threads, at most
    2 * workers in flight."""
    workers = min(4, max(len(paths), 1), os.cpu_count() or 1)
    with cf.ThreadPoolExecutor(workers) as pool:
        todo = deque(paths)
        inflight = deque()
        while todo or inflight:
            while todo and len(inflight) < 2 * workers:
                p = todo.popleft()
                inflight.append(
                    (p, pool.submit(genome_kmer_set, p, sp, canonicalize,
                                    scheme, score_map))
                )
            p, fut = inflight.popleft()
            yield fut.result(), taxid_for_path(p, name_map)


def lca_map(paths: Sequence[str], tree: TaxTree,
            name_map: Dict[str, int] | str, sp: Spacer,
            canonicalize: bool = True, scheme: str = "lex") -> KmerTable:
    """Classify database: kmer -> LCA of the taxids of the genomes that
    hold it (feature_min.h:178-183,205-228)."""
    _check(sp, canonicalize, scheme)
    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    keys = np.zeros(0, np.uint64)
    taxa = np.zeros(0, np.uint32)
    buf: List[Tuple[np.ndarray, int]] = []
    for run in _genome_sets(paths, sp, canonicalize, name_map, scheme):
        buf.append(run)
        if len(buf) >= FOLD_EVERY:
            keys, taxa = lca_fold_runs(keys, taxa, buf, tree)
            buf = []
    if buf:
        keys, taxa = lca_fold_runs(keys, taxa, buf, tree)
    return KmerTable(keys, taxa.astype(np.uint32))


def _phase1_fold(paths, tree, name_map, sp, canonicalize, want_counts):
    """The phase-1 fold, lex scores as in the JAX package (build.py:607)."""
    _check(sp, canonicalize)
    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    runs = list(_genome_sets(paths, sp, canonicalize, name_map))
    return lca_fold_runs(np.zeros(0, np.uint64), np.zeros(0, np.uint32), runs,
                         tree, want_counts=want_counts)


def taxdepth_map(paths: Sequence[str], tree: TaxTree,
                 name_map: Dict[str, int] | str, sp: Spacer,
                 canonicalize: bool = True) -> KmerTable:
    """Phase-1 map: kmer -> TDencode(depth, lca taxid); a poisoned
    (0xFFFFFFFF) fold packs as 1 (feature_min.h:198-203,230-250)."""
    k, v = _phase1_fold(paths, tree, name_map, sp, canonicalize, False)
    return KmerTable(k, taxdepth_values(tree, v))


def ftct_map(paths: Sequence[str], tree: TaxTree,
             name_map: Dict[str, int] | str, sp: Spacer,
             canonicalize: bool = True) -> KmerTable:
    """Phase-1 feature-count map: kmer -> (n_genomes << 32) | lca taxid
    (feature_min.h:192-197,251-265, as intended)."""
    k, v, counts = _phase1_fold(paths, tree, name_map, sp, canonicalize, True)
    return KmerTable(k, ftct_values(v, counts))


def taxdepth_values(tree: TaxTree, taxa: np.ndarray) -> np.ndarray:
    """Folded taxids -> tax-depth values (build.py:613-616)."""
    packed = np.where(taxa == np.uint32(TAX_T_MAX), np.uint64(1),
                      TDencode(tree.depth_of(taxa), taxa))
    return packed.astype(np.uint64)


def ftct_values(taxa: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Folded taxids and genome counts -> feature-count values."""
    return FMencode(np.minimum(counts, TAX_T_MAX), taxa).astype(np.uint64)


def phase2_content(keys: np.ndarray, phase1: KmerTable,
                   scores: np.ndarray | None = None):
    """The phase-2 map's content from its minimizers (build.py:663-672):
    the distinct keys that phase 1 holds, each with the low 32 bits (the
    taxid) of its phase-1 value, by a host probe of phase 1.  A key that
    phase 1 lacks cannot be scored and is dropped: the canonical(OVERFLOW)
    == 0 that an all-N window emits, where phase 1 holds no poly-A
    (update_minimized_map, feature_min.h:274, as intended).  ``scores``,
    where given, are the phase-1 scores of ``keys`` (sorted and distinct)
    from the card (KB5): then only the keys that scored U64_MAX are probed
    here, to tell a missing key from a stored U64_MAX value."""
    if scores is None:
        keys = unique_u64(keys)
        vals, found = phase1.probe_np(keys)
    else:
        vals = scores
        found = scores != np.uint64(U64_MAX)
        miss = ~found
        found[miss] = phase1.probe_np(keys[miss])[1]
    return keys[found], (vals[found] & np.uint64(TAX_T_MAX)).astype(np.uint32)


def minimized_map(paths: Sequence[str], phase1: KmerTable, tree: TaxTree,
                  name_map: Dict[str, int] | str, sp: Spacer,
                  canonicalize: bool = True) -> KmerTable:
    """Phase 2 from phase 1: the genomes' minimizers under the score::Hash
    order of ``phase1`` (each k-mer scored by its phase-1 value), kept
    with the taxid of their phase-1 value (feature_min.h:185-190,267-281).
    ``tree`` is not read; it keeps the JAX signature."""
    smap = ScoreMap(phase1)
    _check(sp, canonicalize, "hash", smap)
    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    sets = [kset for kset, _ in _genome_sets(paths, sp, canonicalize,
                                              name_map, "hash", smap)]
    keys = np.concatenate(sets) if sets else np.zeros(0, np.uint64)
    return KmerTable(*phase2_content(keys, phase1))


def content_digest(table: KmerTable) -> str:
    """sha256 over the sorted little-endian key and value arrays (the
    digest the golden manifest records)."""
    import hashlib

    h = hashlib.sha256()
    h.update(table.keys_sorted.astype("<u8").tobytes())
    h.update(table.vals_sorted.astype("<u8").tobytes())
    return h.hexdigest()
