"""Database builds on the host: the classify map (kmer -> LCA taxid), the
two phase-1 maps and the hash-scored phase 2.

Counterpart of ``bonsai_tpu/db/build.py`` for seeds with k <= 32 of
every input type and the schemes lex, entropy-file (``build -e``) and
hash (``build -t|-f --phase1-db``):

* ``genome_kmer_set``, contiguous and unwindowed DNA: each genome's
  distinct (canonical) k-mers come from the host C++
  ``btpu_canon_kmer_set``;
* every other discipline (``-w``, ``-C -w``, ``-S``, ``-e``, another
  input type), and every discipline with ``use_device``: the encoder
  (``core/encoder.py``) runs on halo-overlapped chunks of ``block``
  windows of each contig, as ``_contig_sets`` does (build.py:134-169),
  the trailing partial window of a non-final chunk dropped where the
  uncanonical windowed discipline makes one; on the CPU its plain torch
  versions, with ``use_device`` on ``device`` (KB1, or KB4 for ``-C
  -w``, on the card);
* ``lca_map`` through ``IncrementalLCABuilder``, a streaming fold that a
  checkpoint (the JAX package's ``.npz`` of keys, taxa and the genomes
  done) resumes, in either package;
* ``taxdepth_map`` (TDencode(depth, lca)) and ``ftct_map``
  ((n_genomes << 32) | lca), lex scores (build.py:594,620);
* ``minimized_map`` (build.py:644): the genomes' minimizers under the
  phase-1 map's score::Hash order, each kept with the low 32 bits
  (the taxid) of its phase-1 value; of any input type, whose phase-1
  map scores its folded k-mers.

Genomes fold in with the shared k-way merge ``btpu_merge_fold_stats``,
which emits per-key Euler-interval extrema (and the group size) that map
to the LCA on the host; ``lca_fold_pairs`` folds unsorted (key, taxid)
pairs by a sort and per-run extrema.  LCA folding is associative and
commutative, so the content is the JAX package's bit for bit.  The
device build of the same maps is ``db/build_device.py``.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import os
from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.alphabet import InputType, alphabet_of
from ..core.encoder import BatchEncoder
from ..core.spacer import Spacer
from ..io import fastx
from ..native import get_lib
from ..taxonomy.ncbi import parse_nameid_map, taxid_for_path
from ..taxonomy.tree import TaxTree
from .table import KmerTable, ScoreMap, unique_u64

TAX_T_MAX = 0xFFFFFFFF
U64_MAX = (1 << 64) - 1
DNA = InputType.DNA


def TDencode(depth, taxid):
    """Tax-depth value: ((~0 - depth) << 32) | taxid (feature_min.h:10-20)."""
    return ((TAX_T_MAX - np.asarray(depth, dtype=np.uint64)) << np.uint64(32)
            ) | np.asarray(taxid, dtype=np.uint64)


def TDdepth(v):
    """The depth of a tax-depth value (build.py:46)."""
    return TAX_T_MAX - (np.asarray(v, dtype=np.uint64) >> np.uint64(32)
                        ).astype(np.uint32)


def TDtax(v):
    """The taxid of a tax-depth value (build.py:50)."""
    return (np.asarray(v, dtype=np.uint64) & np.uint64(TAX_T_MAX)
            ).astype(np.uint32)


def FMencode(count, taxid):
    """Feature-count value: (count << 32) | taxid."""
    return (np.asarray(count, dtype=np.uint64) << np.uint64(32)
            ) | np.asarray(taxid, dtype=np.uint64)


def FMcount(v):
    """The genome count of a feature-count value (build.py:60)."""
    return (np.asarray(v, dtype=np.uint64) >> np.uint64(32)).astype(np.uint32)


def FMtax(v):
    """The taxid of a feature-count value (build.py:64)."""
    return (np.asarray(v, dtype=np.uint64) & np.uint64(TAX_T_MAX)
            ).astype(np.uint32)


FOLD_EVERY = 8  # genomes buffered between folds (bounds host memory)
BLOCK = 1 << 22  # windows per chunk of the windowed encoder (the JAX default)


def _check(sp: Spacer, canonicalize: bool, scheme: str = "lex",
           score_map: ScoreMap | None = None,
           input_type: InputType = DNA) -> None:
    if not 1 <= sp.k <= 32:
        raise ValueError(f"k={sp.k}: the build supports 1 <= k <= 32")
    # the encoder raises for every discipline that is not ported
    BatchEncoder(sp, canonicalize, scheme, input_type, score_map)


def genome_kmer_set(path: str, sp: Spacer, canonicalize: bool = True,
                    scheme: str = "lex", input_type: InputType = DNA,
                    score_map: ScoreMap | None = None,
                    use_device: bool = False, block: int = BLOCK,
                    device="cuda") -> np.ndarray:
    """Sorted distinct emitted (canonical) k-mers or minimizers of one
    genome (fill_set_genome, feature_min.h:67-82; build.py:70-102).
    ``input_type`` picks the alphabet's table.  Contiguous unwindowed DNA
    takes the host C++ path unless ``use_device``; otherwise each contig
    goes through the encoder in chunks of ``block`` windows, on CPU
    tensors, or with ``use_device`` on ``device`` ("cuda", the default,
    raises without a card; "cpu" runs the plain versions)."""
    _check(sp, canonicalize, scheme, score_map, input_type)
    it = InputType(input_type)
    dev = None
    if use_device:
        from .build_device import as_device

        dev = as_device(device)
    lut = np.ascontiguousarray(alphabet_of(it).lut, dtype=np.int8)
    # only contiguous unwindowed DNA takes the host C++ path
    # (_native_kmer_fn, build.py:105-131)
    native = (not use_device and sp.unspaced() and sp.unwindowed()
              and it == DNA)
    enc = None if native else BatchEncoder(sp, canonicalize, scheme, it,
                                           score_map)
    pieces = []
    for _, seq, _ in fastx.read_fastx(path):
        if len(seq) < sp.c:
            continue
        if enc is not None:
            pieces.extend(_contig_sets(enc, seq, lut, sp, block, dev))
            continue
        buf = np.frombuffer(seq, dtype=np.uint8)
        out = np.empty(len(seq), dtype=np.uint64)
        m = get_lib().btpu_canon_kmer_set(buf.ctypes.data, len(seq),
                                          lut.ctypes.data, sp.k,
                                          int(canonicalize), out.ctypes.data)
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
                 block: int, device=None) -> List[np.ndarray]:
    """Emissions of one contig through the encoder, in chunks of
    ``block`` windows that overlap by a w - 1 base halo, on CPU tensors
    or on ``device``."""
    out = []
    halo = sp.w - 1
    start = 0
    while start < len(seq):
        end = min(start + block + halo, len(seq))
        is_last = end >= len(seq)
        codes = torch.from_numpy(fastx.encode_contig(seq[start:end], lut))
        lengths = torch.tensor([end - start], dtype=torch.int32)
        if device is not None:
            codes, lengths = codes.to(device), lengths.to(device)
        em = enc.emissions(codes[None, :], lengths)
        mask = em.mask
        if not is_last and drops_partial_window(sp, enc):
            mask = mask.clone()
            mask[:, 0] = False
        out.append(em.values[mask].cpu().numpy().view(np.uint64))
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


def lca_fold_pairs(keys: np.ndarray, taxa: np.ndarray, tree: TaxTree):
    """Fold duplicate keys of unsorted (key, taxid) pairs to the LCA of
    their taxids (build.py:347-428): sort by key, then each run's set-LCA
    from its Euler-interval extrema, LCA(S) = LCA(argmin tin, argmax tin).
    0 is the identity, a taxid missing from the tree poisons the run to
    0xFFFFFFFF unless every non-zero member is that same taxid, and
    disjoint roots give 1 (util.h:634-663).  Returns sorted distinct
    (keys, taxa)."""
    keys = np.asarray(keys, dtype=np.uint64)
    taxa = np.asarray(taxa, dtype=np.uint32)
    if keys.size == 0:
        return keys.copy(), taxa.copy()
    k = np.array(keys, copy=True)
    t = np.array(taxa, copy=True)
    get_lib().btpu_radix_sort_kv(k.ctypes.data, t.ctypes.data, k.size)
    first = np.empty(k.size, dtype=bool)
    first[0] = True
    first[1:] = k[1:] != k[:-1]
    starts = np.flatnonzero(first)
    if starts.size == k.size:  # every key distinct
        return k, t
    # the taxa take few values (one a genome): compact those, not every
    # element
    ut = unique_u64(t).astype(np.uint32)
    cu = tree.compact(ut, missing_ok=True)
    inv = np.searchsorted(ut, t)
    n = tree.tin.shape[0]
    BIG = np.int32(2 * n + 4)
    tins = np.where(cu != 0, tree.tin[cu], BIG).astype(np.int32)[inv]
    tmin = np.minimum.reduceat(tins, starts)
    tmax = np.maximum.reduceat(np.where(tins == BIG, np.int32(-2), tins),
                               starts)
    nz = t != 0
    miss = nz & (cu[inv] == 0)
    n_miss = np.add.reduceat(miss.astype(np.int64), starts)
    n_nz = np.add.reduceat(nz.astype(np.int64), starts)
    mmin = np.minimum.reduceat(np.where(miss, t, np.uint32(TAX_T_MAX)), starts)
    mmax = np.maximum.reduceat(np.where(miss, t, np.uint32(0)), starts)
    return k[starts], _fold_stats_to_taxa(tree, tmin, tmax, n_miss, n_nz,
                                          mmin, mmax)


def _on_stream(stream, fn, *args, **kw):
    """fn(*args, **kw) with ``stream`` current (None: as it is)."""
    if stream is None:
        return fn(*args, **kw)
    with torch.cuda.stream(stream):
        return fn(*args, **kw)


def _genome_sets(paths: Sequence[str], sp: Spacer, canonicalize: bool,
                 name_map: Dict[str, int], scheme: str = "lex",
                 score_map: ScoreMap | None = None,
                 input_type: InputType = DNA, use_device: bool = False,
                 block: int = BLOCK, device="cuda"):
    """Yield (kset, taxid) per genome in order; the k-mer extraction
    releases the GIL, so a few genomes run at a time in threads, at most
    2 * workers in flight.  With ``use_device`` on a card the threads
    share it and launch on the caller's current stream, one stream: each
    kernel call takes its own scratch from the caching allocator."""
    stream = None
    if use_device:
        from .build_device import as_device

        dev = as_device(device)
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
    workers = min(4, max(len(paths), 1), os.cpu_count() or 1)
    with cf.ThreadPoolExecutor(workers) as pool:
        todo = deque(paths)
        inflight = deque()
        while todo or inflight:
            while todo and len(inflight) < 2 * workers:
                p = todo.popleft()
                inflight.append((p, pool.submit(
                    _on_stream, stream, genome_kmer_set, p, sp, canonicalize,
                    scheme, input_type, score_map, use_device, block,
                    device)))
            p, fut = inflight.popleft()
            yield fut.result(), taxid_for_path(p, name_map)


class IncrementalLCABuilder:
    """A streaming, checkpointable fold of genomes' k-mer sets into the
    classify map (build.py:451-531).  LCA folding is associative and
    commutative, so the running state (sorted keys and their folded taxa)
    and the list of genomes done are a whole checkpoint: genomes fold in
    every ``fold_every``, a checkpoint follows every
    ``checkpoint_every_folds`` folds, and one given an existing
    ``checkpoint_path`` resumes from it.  The file is the JAX package's:
    ``np.savez`` of keys (u64), taxa (u32) and done (the paths as bytes),
    written to ``<path>.tmp.npz`` and moved onto the path, so either
    package resumes the other's."""

    def __init__(self, tree: TaxTree, checkpoint_path: str | None = None,
                 fold_every: int = FOLD_EVERY,
                 checkpoint_every_folds: int = 1):
        self.tree = tree
        self.checkpoint_path = checkpoint_path
        self.fold_every = fold_every
        self.checkpoint_every_folds = checkpoint_every_folds
        self._folds_since_ckpt = 0
        self.keys = np.zeros(0, np.uint64)
        self.taxa = np.zeros(0, np.uint32)
        self.done: List[str] = []
        self._buf: List[Tuple[np.ndarray, int]] = []
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            with np.load(checkpoint_path, allow_pickle=False) as z:
                self.keys = z["keys"]
                self.taxa = z["taxa"]
                self.done = [p.decode() for p in z["done"]]

    def pending(self, paths: Sequence[str]) -> List[str]:
        """The paths not folded in yet, in order."""
        done = set(self.done)
        return [p for p in paths if p not in done]

    def add_genome(self, path: str, taxid: int, kset: np.ndarray) -> None:
        self._buf.append((kset, int(taxid)))
        self.done.append(path)
        if len(self._buf) >= self.fold_every:
            self.fold()
            self._folds_since_ckpt += 1
            if (self.checkpoint_path is not None
                    and self._folds_since_ckpt >= self.checkpoint_every_folds):
                self.save_checkpoint()
                self._folds_since_ckpt = 0

    def fold(self) -> None:
        if self._buf:
            self.keys, self.taxa = lca_fold_runs(self.keys, self.taxa,
                                                 self._buf, self.tree)
            self._buf = []

    def save_checkpoint(self) -> None:
        self.fold()
        tmp = self.checkpoint_path + ".tmp.npz"
        np.savez(tmp[: -len(".npz")], keys=self.keys, taxa=self.taxa,
                 done=np.array([p.encode() for p in self.done]))
        os.replace(tmp, self.checkpoint_path)

    def finish(self) -> KmerTable:
        return KmerTable(*self.finish_arrays())

    def finish_arrays(self):
        """(sorted keys, taxa) without placing the probe table (the scale
        path: the sharded savers place a table a shard)."""
        self.fold()
        return self.keys, self.taxa.astype(np.uint32)


def lca_map(paths: Sequence[str], tree: TaxTree,
            name_map: Dict[str, int] | str, sp: Spacer,
            canonicalize: bool = True, scheme: str = "lex",
            input_type: InputType = DNA, use_device: bool = False,
            checkpoint_path: str | None = None, block: int = BLOCK,
            as_arrays: bool = False, checkpoint_every_folds: int = 1,
            device="cuda"):
    """Classify database: kmer -> LCA of the taxids of the genomes that
    hold it (feature_min.h:178-183,205-228; build.py:534-591), folded by
    an ``IncrementalLCABuilder``: with ``checkpoint_path`` the build
    checkpoints as it goes, resumes the genomes a checkpoint lacks, and
    saves the whole state at the end.  ``as_arrays`` returns the sorted
    (keys, taxa) without placing the table.  ``input_type``,
    ``use_device``, ``block`` and ``device`` are ``genome_kmer_set``'s."""
    _check(sp, canonicalize, scheme, None, input_type)
    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    fold = IncrementalLCABuilder(
        tree, checkpoint_path, checkpoint_every_folds=checkpoint_every_folds)
    pending = fold.pending(list(paths))
    sets = _genome_sets(pending, sp, canonicalize, name_map, scheme,
                        input_type=input_type, use_device=use_device,
                        block=block, device=device)
    for p, (kset, taxid) in zip(pending, sets):
        fold.add_genome(p, taxid, kset)
    if checkpoint_path is not None:
        fold.save_checkpoint()
    return fold.finish_arrays() if as_arrays else fold.finish()


def _phase1_fold(paths, tree, name_map, sp, canonicalize, want_counts,
                 input_type, use_device, device):
    """The phase-1 fold, lex scores as in the JAX package (build.py:607)."""
    _check(sp, canonicalize, input_type=input_type)
    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    runs = list(_genome_sets(paths, sp, canonicalize, name_map,
                             input_type=input_type, use_device=use_device,
                             device=device))
    return lca_fold_runs(np.zeros(0, np.uint64), np.zeros(0, np.uint32), runs,
                         tree, want_counts=want_counts)


def taxdepth_map(paths: Sequence[str], tree: TaxTree,
                 name_map: Dict[str, int] | str, sp: Spacer,
                 canonicalize: bool = True, input_type: InputType = DNA,
                 use_device: bool = False, device="cuda") -> KmerTable:
    """Phase-1 map: kmer -> TDencode(depth, lca taxid); a poisoned
    (0xFFFFFFFF) fold packs as 1 (feature_min.h:198-203,230-250)."""
    k, v = _phase1_fold(paths, tree, name_map, sp, canonicalize, False,
                        input_type, use_device, device)
    return KmerTable(k, taxdepth_values(tree, v))


def ftct_map(paths: Sequence[str], tree: TaxTree,
             name_map: Dict[str, int] | str, sp: Spacer,
             canonicalize: bool = True, input_type: InputType = DNA,
             use_device: bool = False, device="cuda") -> KmerTable:
    """Phase-1 feature-count map: kmer -> (n_genomes << 32) | lca taxid
    (feature_min.h:192-197,251-265, as intended)."""
    k, v, counts = _phase1_fold(paths, tree, name_map, sp, canonicalize, True,
                                input_type, use_device, device)
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
                  canonicalize: bool = True, input_type: InputType = DNA,
                  use_device: bool = False, device="cuda") -> KmerTable:
    """Phase 2 from phase 1: the genomes' minimizers under the score::Hash
    order of ``phase1`` (each k-mer scored by its phase-1 value), kept
    with the taxid of their phase-1 value (feature_min.h:185-190,267-281;
    build.py:644-668).  ``input_type`` is the genomes' and the phase-1
    map's (another alphabet's k-mers are scored as its fold leaves them);
    ``use_device`` and ``device`` are ``genome_kmer_set``'s.  ``tree`` is
    not read; it keeps the JAX signature."""
    smap = ScoreMap(phase1)
    _check(sp, canonicalize, "hash", smap, input_type)
    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    sets = [kset for kset, _ in _genome_sets(
        paths, sp, canonicalize, name_map, "hash", smap, input_type,
        use_device, device=device)]
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
