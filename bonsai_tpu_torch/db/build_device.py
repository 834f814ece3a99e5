"""Database build on the card: the sort-based deterministic LCA fold.

Counterpart of ``bonsai_tpu/db/build_device.py`` for the disciplines the
port's encoder takes (k <= 32 of every input type: contiguous unwindowed,
canonical (DNA) or uncanonical windowed, spaced; lex, entropy-file or
phase-1 hash scores).  Each function takes the JAX ``input_type``: the
genomes are encoded with that alphabet's table (``alphabet_of(it).lut``)
and folded as its k-mers fold.
LCA merging is associative and commutative, so a build is a fold of
per-genome distinct-minimizer sets:

* a STATE is (keys, pad, node, orig, cnt) of some capacity, sorted by
  (unsigned key, pad) with pads (key U64_MAX, pad 1) last, so the valid
  entries are a prefix and a real U64_MAX key still orders before the
  pads.  Keys are int64-held u64, pad uint8, node int32 (compact index),
  orig int32 holding the u32 taxid (compared only with ==/!=), cnt int32
  holding the u32 genome count; ``n`` is the valid count, a 0-d int64
  tensor on the state's device.  Pads carry zero node, orig and cnt.
* a genome streams through the encoder (KB1 ``core/encoder.py``
  ``minimizers``, or KB4 ``compacted_minimizers`` for the uncanonical
  windowed discipline) in chunks of ``block`` windows that overlap by a
  w - 1 base halo, a non-final chunk's trailing partial window dropped
  where that discipline makes one; KB2 ``sort_unique`` turns each chunk
  into a sorted-unique key set, and KB3 ``merge_fold`` merges it into the
  genome's state without summing counts (chunks of one genome repeat
  keys);
* genome states merge pairwise in a tree, summing counts, which gives
  the ftct genome count.

The JAX package pads every chunk to block + w - 1 bases so that jit sees
one shape; the port runs eagerly, so the last chunk of a contig holds
only its own bases.  The emissions are the same: padding emits nothing.

Every function takes an explicit ``device``: on "cuda" the kernels run,
on "cpu" their plain torch versions (``sort_unique_plain``,
``merge_fold_plain``, ``minimizers_plain``,
``compacted_minimizers_plain``).  The phase-1 maps score lex, as the JAX
package's do; ``device_minimized_map`` (phase 2) scores each k-mer by its
phase-1 value, probed inside KB1 and KB4.

``ShardedLCAFold`` and ``sharded_lca_map`` fold over the ``db`` ranks of
a mesh (``parallel/mesh.py``): rank s owns the key range [splitter[s -
1], splitter[s]) (the last rank's upper end inclusive), and each chunk of
the stream goes to every rank, where ``key_range`` (the key-range mode
of ``csrc/bitmix.cu``) flags the rank's keys, KB2 sorts and dedups them
and KB3 merges them into the rank's state of a fixed capacity.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

import itertools
import os

from .. import kernels
from ..classify.resolve import lca_device
from ..core.alphabet import InputType, alphabet_of
from ..core.bitops import SIGN, i64
from ..core.encoder import BatchEncoder
from ..core.spacer import Spacer
from ..io import fastx
from ..taxonomy.ncbi import parse_nameid_map, taxid_for_path
from ..taxonomy.tree import TAX_MISSING, TaxTree
from ..util import span
from .build import (_check, drops_partial_window, ftct_values, phase2_content,
                    taxdepth_values)
from .table import KmerTable, ScoreMap

U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _pow2(x: int) -> int:
    return 1 << max(int(max(x, 1) - 1).bit_length(), 3)


def _i32(v: int) -> int:
    """The int32 with the bits of the u32 ``v``."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


def as_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available")
    return dev


# -- states --------------------------------------------------------------------

class State:
    """Sorted-unique padded build state (see the module docstring)."""

    __slots__ = ("keys", "pad", "node", "orig", "cnt", "n")

    def __init__(self, keys, pad, node, orig, cnt, n):
        self.keys, self.pad, self.node, self.orig, self.cnt = (
            keys, pad, node, orig, cnt)
        self.n = n

    @property
    def cap(self) -> int:
        return self.keys.shape[0]

    @classmethod
    def empty(cls, device, cap: int = 8) -> "State":
        z = torch.zeros(cap, dtype=torch.int32, device=device)
        return cls(torch.full((cap,), -1, dtype=torch.int64, device=device),
                   torch.ones(cap, dtype=torch.uint8, device=device), z,
                   z.clone(), z.clone(),
                   torch.zeros((), dtype=torch.int64, device=device))

    @classmethod
    def from_sorted_keys(cls, keys, pad, n, node: int, orig: int) -> "State":
        """Constant-taxon state (one genome) from a sorted-unique padded
        key array."""
        real = pad == 0
        return cls(keys, pad,
                   torch.where(real, node, 0).to(torch.int32),
                   torch.where(real, _i32(orig), 0).to(torch.int32),
                   real.to(torch.int32), n)

    @classmethod
    def from_numpy(cls, keys, pad, node, orig, cnt, n: int,
                   device) -> "State":
        """A state from host arrays (u64 keys, u8 pad, i32 node, u32 orig
        and cnt), e.g. ``np.asarray`` of a JAX ``_State``'s fields."""
        def up(a, dt):  # a copy: the arrays may be read-only views
            return torch.from_numpy(np.array(a).view(dt)).to(device)

        return cls(up(np.asarray(keys, np.uint64), np.int64),
                   up(np.asarray(pad, np.uint8), np.uint8),
                   up(np.asarray(node, np.int32), np.int32),
                   up(np.asarray(orig, np.uint32), np.int32),
                   up(np.asarray(cnt, np.uint32), np.int32),
                   torch.tensor(int(n), dtype=torch.int64, device=device))

    def numpy(self):
        """Host (keys u64, pad u8, node i32, orig u32, cnt u32, n)."""
        return (self.keys.cpu().numpy().view(np.uint64), self.pad.cpu().numpy(),
                self.node.cpu().numpy(),
                self.orig.cpu().numpy().view(np.uint32),
                self.cnt.cpu().numpy().view(np.uint32), int(self.n))

    def trimmed(self) -> "State":
        """Slice to the power-of-two capacity that covers the valid prefix
        (reads ``n`` on the host)."""
        cap = _pow2(int(self.n))
        if cap >= self.cap:
            return self
        return State(self.keys[:cap], self.pad[:cap], self.node[:cap],
                     self.orig[:cap], self.cnt[:cap], self.n)


# -- KB2: chunk sort + dedup ---------------------------------------------------

def sort_unique_plain(keys: torch.Tensor, emitted: torch.Tensor, cap: int):
    """Plain torch KB2: the sorted distinct emitted keys (unsigned order)
    padded to ``cap`` with U64_MAX, pad (cap,) uint8 and their count n
    (0-d int64)."""
    u = torch.unique(keys[emitted] ^ SIGN, sorted=True) ^ SIGN
    n = u.shape[0]
    out = torch.full((cap,), -1, dtype=torch.int64, device=keys.device)
    out[:n] = u
    pad = torch.ones(cap, dtype=torch.uint8, device=keys.device)
    pad[:n] = 0
    return out, pad, torch.tensor(n, dtype=torch.int64, device=keys.device)


def sort_unique(keys: torch.Tensor, emitted: torch.Tensor):
    """KB2 (``csrc/sort_unique.cu``): see ``sort_unique_plain``, which
    serves CPU tensors.  keys (E,) int64, emitted (E,) bool; the capacity
    is the smallest power of two >= max(E, 8).  The kernel takes fewer
    than 2^30 keys (its tile counts are 30-bit)."""
    E = keys.shape[0]
    cap = _pow2(E)
    if keys.device.type == "cpu":
        return sort_unique_plain(keys, emitted, cap)
    if keys.device.type != "cuda":
        raise ValueError(f"sort_unique: no kernel for device {keys.device}")
    if E >= 1 << 30:
        raise ValueError(f"sort_unique: {E} keys, the kernel takes < 2^30")
    dev = keys.device
    kernels.check(keys, "keys", torch.int64, dev, (E,))
    kernels.check(emitted, "emitted", torch.bool, dev, (E,))
    out = torch.empty(cap, dtype=torch.int64, device=dev)
    pad = torch.empty(cap, dtype=torch.uint8, device=dev)
    n = torch.empty((), dtype=torch.int64, device=dev)
    scratch = kernels.scratch("bk_sort_unique", E, dev)
    kernels.launch("bk_sort_unique", dev, keys.data_ptr(), emitted.data_ptr(),
                   E, cap, out.data_ptr(), pad.data_ptr(), n.data_ptr(),
                   scratch.data_ptr())
    sort_unique.launches += 1
    return out, pad, n


sort_unique.launches = 0


# -- KB3: merge + LCA fold -----------------------------------------------------

def combine_pair(tax: Dict[str, torch.Tensor], root1: int, nx, ox, ny, oy):
    """Reference-exact pairwise lca on (compact node, u32-in-int32 taxid)
    pairs (build_device.py:96-120), each rule overriding the ones before
    it.  Returns (node int32, orig int32)."""
    r = lca_device(nx, ny, tax)
    node = r
    orig = tax["tax_ids"][r]
    disjoint = (r == 0) & (nx != 0) & (ny != 0)
    node = torch.where(disjoint, root1, node)
    orig = torch.where(disjoint, 1, orig)
    missing = ((nx == 0) & (ox != 0)) | ((ny == 0) & (oy != 0))
    node = torch.where(missing, 0, node)
    orig = torch.where(missing, _i32(TAX_MISSING), orig)
    node = torch.where(ox == 0, ny, node)
    orig = torch.where(ox == 0, oy, orig)
    take_x = (oy == 0) | (ox == oy)
    node = torch.where(take_x, nx, node)
    orig = torch.where(take_x, ox, orig)
    return node.to(torch.int32), orig.to(torch.int32)


def merge_fold_plain(a: State, b: State, tax: Dict[str, torch.Tensor],
                     root1: int, sum_counts: bool) -> State:
    """Plain torch KB3: the (key, pad)-ordered merge of two states (a's
    entry first on a tie), each pair of equal real keys folded into its
    first entry by ``combine_pair`` (counts added when ``sum_counts``),
    the second dropped; capacity a.cap + b.cap."""
    keys = torch.cat([a.keys, b.keys])
    pad = torch.cat([a.pad, b.pad])
    order = torch.sort(pad, stable=True).indices
    order = order[torch.sort(keys[order] ^ SIGN, stable=True).indices]
    keys, pad = keys[order], pad[order]
    node = torch.cat([a.node, b.node])[order]
    orig = torch.cat([a.orig, b.orig])[order]
    cnt = torch.cat([a.cnt, b.cnt])[order]
    real = pad == 0
    dup = torch.zeros_like(real)
    dup[:-1] = (keys[:-1] == keys[1:]) & real[:-1] & real[1:]
    cn, co = combine_pair(tax, root1, node, orig, node.roll(-1), orig.roll(-1))
    node = torch.where(dup, cn, node)
    orig = torch.where(dup, co, orig)
    if sum_counts:
        cnt = torch.where(dup, cnt + cnt.roll(-1), cnt)
    second = torch.zeros_like(real)
    second[1:] = dup[:-1]
    keep = (real & ~second).nonzero()[:, 0]
    out = State.empty(keys.device, keys.shape[0])
    n = keep.shape[0]
    out.keys[:n], out.pad[:n] = keys[keep], 0
    out.node[:n], out.orig[:n], out.cnt[:n] = node[keep], orig[keep], cnt[keep]
    out.n = torch.tensor(n, dtype=torch.int64, device=keys.device)
    return out


def merge_fold(a: State, b: State, tax: Dict[str, torch.Tensor], root1: int,
               sum_counts: bool) -> State:
    """KB3 (``csrc/merge_fold.cu``): see ``merge_fold_plain``, which
    serves CPU tensors.  ``tax`` is ``TaxTree.device_arrays`` on the
    states' device; ``root1`` the compact index of taxid 1.  The kernel
    takes a combined capacity below 2^30 (its tile counts are 30-bit)."""
    dev = a.keys.device
    if dev.type == "cpu":
        return merge_fold_plain(a, b, tax, root1, sum_counts)
    if dev.type != "cuda":
        raise ValueError(f"merge_fold: no kernel for device {dev}")
    for s, tag in ((a, "a"), (b, "b")):
        c = s.cap
        kernels.check(s.keys, f"{tag}.keys", torch.int64, dev, (c,))
        kernels.check(s.pad, f"{tag}.pad", torch.uint8, dev, (c,))
        for f in ("node", "orig", "cnt"):
            kernels.check(getattr(s, f), f"{tag}.{f}", torch.int32, dev, (c,))
    n = tax["depth"].shape[0]
    for f in ("depth", "parent", "tax_ids"):
        kernels.check(tax[f], f, torch.int32, dev, (n,))
    levels = tax["lift"].shape[0]
    kernels.check(tax["lift"], "lift", torch.int32, dev, (levels, n))
    N = a.cap + b.cap
    if N >= 1 << 30:
        raise ValueError(f"merge_fold: capacity {N}, the kernel takes < 2^30")
    out = State(torch.empty(N, dtype=torch.int64, device=dev),
                torch.empty(N, dtype=torch.uint8, device=dev),
                *(torch.empty(N, dtype=torch.int32, device=dev)
                  for _ in range(3)),
                torch.empty((), dtype=torch.int64, device=dev))
    scratch = kernels.scratch("bk_merge_fold", N, dev)
    kernels.launch(
        "bk_merge_fold", dev,
        *(t.data_ptr() for t in (a.keys, a.pad, a.node, a.orig, a.cnt)), a.cap,
        *(t.data_ptr() for t in (b.keys, b.pad, b.node, b.orig, b.cnt)), b.cap,
        tax["lift"].data_ptr(), levels, n, tax["depth"].data_ptr(),
        tax["parent"].data_ptr(), tax["tax_ids"].data_ptr(), root1,
        int(sum_counts),
        *(t.data_ptr() for t in (out.keys, out.pad, out.node, out.orig,
                                 out.cnt, out.n)),
        scratch.data_ptr(),
    )
    merge_fold.launches += 1
    return out


merge_fold.launches = 0


# -- folds ---------------------------------------------------------------------

def _node_of(tree: TaxTree, taxid: int) -> int:
    return int(tree.compact(np.array([taxid], dtype=np.uint32),
                            missing_ok=True)[0])


def _tree_device(tree: TaxTree, device):
    return tree.device_arrays(device), _node_of(tree, 1)


def _genome_state(path: str, sp: Spacer, enc: BatchEncoder, taxid: int,
                  node: int, tax, root1: int, block: int, device) -> State:
    """One genome -> its folded state (distinct emitted minimizers with the
    genome's taxid), encoded by the table of the encoder's input type.
    Contigs shorter than the seed span are skipped."""
    halo = sp.w - 1
    drop0 = drops_partial_window(sp, enc)
    lut = _lut(enc.it)
    acc = State.empty(device)
    records = iter(fastx.read_fastx(path))
    while True:
        with span("genome_read"):
            rec = next(records, None)
        if rec is None:
            break
        seq = rec[1]
        if len(seq) < sp.c:
            continue
        start = 0
        while start < len(seq):
            end = min(start + block + halo, len(seq))
            is_last = end >= len(seq)
            with span("genome_read"):
                codes = torch.from_numpy(
                    fastx.encode_contig(seq[start:end], lut))
            with span("fold"):
                # The trim reads the previous merge's n on the host one
                # chunk late, as the JAX package does: the card runs that
                # merge while the host parses and encodes this chunk.
                acc = acc.trimmed()
                lengths = torch.tensor([end - start], dtype=torch.int32)
                em = enc.emissions(codes[None, :].to(device),
                                   lengths.to(device))
                mask = em.mask[0]
                if drop0 and not is_last:  # not a real contig end
                    mask = mask.clone()
                    mask[0] = False
                dk, dp, dn = sort_unique(em.values[0], mask)
                st = State.from_sorted_keys(dk, dp, dn, node, taxid)
                acc = merge_fold(acc, st, tax, root1, sum_counts=False)
            if is_last:
                break
            start += block
    with span("fold"):
        return acc.trimmed()


def _tree_fold(states: List[State], tax, root1: int) -> State:
    """Pairwise tree reduction of one or more states (counts summed)."""
    while len(states) > 1:
        nxt = [merge_fold(states[i], states[i + 1], tax, root1,
                          sum_counts=True).trimmed()
               for i in range(0, len(states) - 1, 2)]
        if len(states) % 2:
            nxt.append(states[-1])
        states = nxt
    return states[0]


def _finish_fold(states: List[State], tax, root1: int, want_counts: bool):
    """``_tree_fold`` of the states -> host (keys u64, taxa u32[, counts
    int64])."""
    if not states:
        out = (np.zeros(0, np.uint64), np.zeros(0, np.uint32))
        return out + ((np.zeros(0, np.int64),) if want_counts else ())
    with span("fold_fetch"):
        st = _tree_fold(states, tax, root1)
        n = int(st.n)  # fetch the valid prefix only
        out = (st.keys[:n].cpu().numpy().view(np.uint64),
               st.orig[:n].cpu().numpy().view(np.uint32))
        if want_counts:
            out += (st.cnt[:n].cpu().numpy().view(np.uint32).astype(
                np.int64),)
        return out


def device_fold_runs(runs: Sequence[Tuple[np.ndarray, int]], tree: TaxTree,
                     want_counts: bool = False, device="cuda"):
    """Device fold of explicit per-genome sorted-unique u64 key sets
    [(keys, taxid)] -> host (keys, taxa[, counts]), as
    ``db/build.lca_fold_runs``."""
    dev = as_device(device)
    tax, root1 = _tree_device(tree, dev)
    states = []
    for kset, taxid in runs:
        kset = np.asarray(kset, dtype=np.uint64)
        cap = _pow2(kset.size)
        keys = np.full(cap, U64_MAX, dtype=np.uint64)
        keys[: kset.size] = kset
        pad = np.ones(cap, dtype=np.uint8)
        pad[: kset.size] = 0
        states.append(State.from_sorted_keys(
            torch.from_numpy(keys.view(np.int64)).to(dev),
            torch.from_numpy(pad).to(dev),
            torch.tensor(kset.size, dtype=torch.int64, device=dev),
            _node_of(tree, taxid), int(taxid) & 0xFFFFFFFF))
    return _finish_fold(states, tax, root1, want_counts)


def _lut(it: InputType) -> np.ndarray:
    """The alphabet table of the input type ``it`` (build_device.py:424)."""
    return np.ascontiguousarray(alphabet_of(InputType(it)).lut, np.int8)


def _device_gather(paths: Sequence[str], tree: TaxTree, name_map,
                   sp: Spacer, canonicalize: bool, block: int, device,
                   scheme: str = "lex", score_map: ScoreMap | None = None,
                   input_type: InputType = InputType.DNA):
    _check(sp, canonicalize, scheme, score_map, input_type)
    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    dev = as_device(device)
    enc = BatchEncoder(sp, canonicalize, scheme, input_type, score_map)
    tax, root1 = _tree_device(tree, dev)
    states = []
    for p in paths:
        taxid = taxid_for_path(p, name_map)
        states.append(_genome_state(p, sp, enc, int(taxid) & 0xFFFFFFFF,
                                    _node_of(tree, taxid), tax, root1, block,
                                    dev))
    return states, tax, root1


def device_lca_map(paths: Sequence[str], tree: TaxTree,
                   name_map: Dict[str, int] | str, sp: Spacer,
                   canonicalize: bool = True, scheme: str = "lex",
                   input_type: InputType = InputType.DNA,
                   block: int = 1 << 22, device="cuda") -> KmerTable:
    """Classify database built on the card; content-identical to
    ``db/build.lca_map`` (feature_min.h:178-183,205-228).  As in the JAX
    package, the uncanonical windowed discipline (-C with w > k) equals
    the host build only at equal ``block``: a window that straddles a
    chunk edge next to an N can select another minimizer."""
    states, tax, root1 = _device_gather(paths, tree, name_map, sp,
                                        canonicalize, block, device, scheme,
                                        input_type=input_type)
    keys, taxa = _finish_fold(states, tax, root1, want_counts=False)
    return KmerTable(keys, taxa)


def device_taxdepth_map(paths: Sequence[str], tree: TaxTree,
                        name_map: Dict[str, int] | str, sp: Spacer,
                        canonicalize: bool = True,
                        input_type: InputType = InputType.DNA,
                        block: int = 1 << 22, device="cuda") -> KmerTable:
    """Phase-1 tax-depth map on the card: kmer -> TDencode(depth, lca)
    (feature_min.h:198-203,230-250)."""
    states, tax, root1 = _device_gather(paths, tree, name_map, sp,
                                        canonicalize, block, device,
                                        input_type=input_type)
    keys, taxa = _finish_fold(states, tax, root1, want_counts=False)
    return KmerTable(keys, taxdepth_values(tree, taxa))


def device_ftct_map(paths: Sequence[str], tree: TaxTree,
                    name_map: Dict[str, int] | str, sp: Spacer,
                    canonicalize: bool = True,
                    input_type: InputType = InputType.DNA,
                    block: int = 1 << 22, device="cuda") -> KmerTable:
    """Phase-1 feature-count map on the card: kmer -> (n_genomes << 32) |
    lca (feature_min.h:192-197,251-265, as intended)."""
    states, tax, root1 = _device_gather(paths, tree, name_map, sp,
                                        canonicalize, block, device,
                                        input_type=input_type)
    keys, taxa, counts = _finish_fold(states, tax, root1, want_counts=True)
    return KmerTable(keys, ftct_values(taxa, counts))


def device_minimized_map(paths: Sequence[str], phase1: KmerTable,
                         tree: TaxTree, name_map: Dict[str, int] | str,
                         sp: Spacer, canonicalize: bool = True,
                         input_type: InputType = InputType.DNA,
                         block: int = 1 << 22, device="cuda") -> KmerTable:
    """Phase 2 on the card (build_device.py:758-784): the genomes'
    minimizers under the score::Hash order of ``phase1`` (its probe image
    uploaded once, probed inside KB1 and KB4), folded by KB2 and KB3 as
    the JAX function folds them (the LCAs are then dropped); the folded
    keys, sorted and distinct, are scored by KB5 ``lookup_scores`` before
    they leave the card, and ``db/build.phase2_content`` keeps those that
    phase 1 holds.  ``input_type`` is the genomes' and the phase-1 map's
    (KB5 takes folded keys of any alphabet).  Content-identical to
    ``db/build.minimized_map``."""
    smap = ScoreMap(phase1)
    states, tax, root1 = _device_gather(paths, tree, name_map, sp,
                                        canonicalize, block, device, "hash",
                                        smap, input_type)
    if not states:
        return KmerTable(*phase2_content(np.zeros(0, np.uint64), phase1))
    st = _tree_fold(states, tax, root1)
    keys = st.keys[: int(st.n)]
    scores = smap.lookup_scores(keys)
    return KmerTable(*phase2_content(keys.cpu().numpy().view(np.uint64),
                                     phase1,
                                     scores.cpu().numpy().view(np.uint64)))


# -- the key-range filter of the sharded fold ---------------------------------

def key_range_plain(keys: torch.Tensor, pad: torch.Tensor, lo: int, hi: int,
                    last: bool) -> torch.Tensor:
    """Plain torch ``key_range``: pad == 0 and lo <= key and (key < hi, or
    key <= hi where ``last``), unsigned; lo, hi u64 as Python ints."""
    k = keys ^ SIGN
    lo_s, hi_s = i64(lo) ^ SIGN, i64(hi) ^ SIGN
    upper = (k <= hi_s) if last else (k < hi_s)
    return (pad == 0) & (k >= lo_s) & upper


def key_range(keys: torch.Tensor, pad: torch.Tensor, lo: int, hi: int,
              last: bool) -> torch.Tensor:
    """The key-range mode of ``csrc/bitmix.cu`` (``bk_key_range``, the
    rank filter of ``ShardedLCAFold``): see ``key_range_plain``, which
    serves CPU tensors.  keys (n,) int64, pad (n,) uint8 -> (n,) bool."""
    if not (0 <= lo < 1 << 64 and 0 <= hi < 1 << 64):
        raise ValueError(f"key range [{lo}, {hi}]: u64 bounds expected")
    if keys.device.type == "cpu":
        return key_range_plain(keys, pad, lo, hi, last)
    if keys.device.type != "cuda":
        raise ValueError(f"key_range: no kernel for device {keys.device}")
    dev = keys.device
    n = keys.numel()
    kernels.check(keys, "keys", torch.int64, dev, (n,))
    kernels.check(pad, "pad", torch.uint8, dev, (n,))
    flag = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        kernels.launch("bk_key_range", dev, keys.data_ptr(), pad.data_ptr(),
                       n, lo, hi, int(last), flag.data_ptr())
        key_range.launches += 1
    return flag


key_range.launches = 0


# -- the sharded fold ----------------------------------------------------------

class ShardedLCAFold:
    """The LCA fold over the ``db`` axis of a mesh
    (``bonsai_tpu/db/build_device.py`` ``ShardedLCAFold``): each rank owns
    a key range and folds the stream's keys in it into its own state of
    ``cap`` entries, so the ranks exchange nothing; the result is the
    ranges' concatenation in rank order, content-identical to
    ``db/build.lca_map``.  ``splitters`` (ndb - 1 ascending u64) default
    to an even split of the 64-bit key space.  A chunk that would take a
    rank past ``cap`` raises and leaves every state as it was before the
    chunk."""

    def __init__(self, tree: TaxTree, mesh, cap: int, splitters=None):
        self.tree = tree
        self.mesh = mesh
        self.ndb = mesh.shape["db"]
        self.cap = int(cap)
        if splitters is None:
            step = (1 << 64) // self.ndb
            splitters = [step * i for i in range(1, self.ndb)]
        spl = [int(x) for x in np.asarray(splitters, dtype=np.uint64)]
        if len(spl) != self.ndb - 1:
            raise ValueError(f"{len(spl)} splitters for {self.ndb} ranks")
        self._bounds = {}
        for s in range(self.ndb):
            lo = 0 if s == 0 else spl[s - 1]
            hi = spl[s] if s < self.ndb - 1 else (1 << 64) - 1
            self._bounds[s] = (lo, hi, s == self.ndb - 1)
        self._tax = {}
        self.states = {}
        for r in mesh.local_ranks:
            dev = mesh.device(r)
            if dev not in self._tax:
                self._tax[dev] = _tree_device(tree, dev)
            self.states[r] = State.empty(dev, self.cap)

    def add_chunk(self, keys: torch.Tensor, pad: torch.Tensor, node: int,
                  orig: int) -> None:
        """Fold one chunk of the stream, (E,) int64 keys and uint8 pads
        (the same on every rank), with its genome's compact node and
        taxid, into every rank's range."""
        new = {}
        for r, st in self.states.items():
            dev = st.keys.device
            tax, root1 = self._tax[dev]
            k, p = keys.to(dev), pad.to(dev)
            lo, hi, last = self._bounds[self.mesh.index(r, "db")]
            dk, dp, dn = sort_unique(k, key_range(k, p, lo, hi, last))
            chunk = State.from_sorted_keys(dk, dp, dn, node, orig)
            new[r] = merge_fold(st, chunk, tax, root1, sum_counts=False)
        nv = {r: int(out.n) for r, out in new.items()}
        if any(v > self.cap for v in nv.values()):
            raise RuntimeError(f"shard capacity {self.cap} exceeded: per-rank "
                               f"valid={nv}; re-run with a larger cap")
        c = self.cap
        for r, out in new.items():
            self.states[r] = State(out.keys[:c], out.pad[:c], out.node[:c],
                                   out.orig[:c], out.cnt[:c], out.n)

    def finish(self):
        """Host (keys u64, taxa u32): every rank's valid entries, the
        ranges in rank order (sorted and distinct)."""
        ks, ts = {}, {}
        for r, st in self.states.items():
            s = self.mesh.index(r, "db")
            if s in ks:
                continue
            n = int(st.n)
            ks[s] = st.keys[:n].cpu().numpy().view(np.uint64)
            ts[s] = st.orig[:n].cpu().numpy().view(np.uint32)
        if self.mesh.distributed and self.mesh.process_count > 1:
            import torch.distributed as dist

            got = [None] * self.mesh.process_count
            dist.all_gather_object(got, (ks, ts))
            for k_, t_ in got:
                ks.update(k_)
                ts.update(t_)
        order = range(self.ndb)
        return (np.concatenate([ks[s] for s in order]),
                np.concatenate([ts[s] for s in order]).astype(np.uint32))


def sharded_lca_map(paths: Sequence[str], tree: TaxTree,
                    name_map: Dict[str, int] | str, sp: Spacer, mesh,
                    canonicalize: bool = True, scheme: str = "lex",
                    input_type: InputType = InputType.DNA,
                    block: int = 1 << 22, cap: int | None = None) -> KmerTable:
    """The classify database folded over a mesh's ``db`` ranks
    (``bonsai_tpu/db/build_device.py`` ``sharded_lca_map``),
    content-identical to ``db/build.lca_map``.  The stream is encoded on
    the mesh's first device, chunk by chunk as ``device_lca_map``'s; the
    key-range splitters are the quantiles of the keys of the first 16
    chunks (an even split of [0, 4^k) where they degenerate, as the JAX
    rule has it for every input type: content does not depend on the
    splitters), and ``cap`` (default: an estimate from the input's bytes)
    bounds each rank.  ``input_type`` is the genomes' (its alphabet's
    table, build_device.py:675)."""
    if isinstance(name_map, str):
        name_map = parse_nameid_map(name_map)
    _check(sp, canonicalize, scheme, None, input_type)
    enc = BatchEncoder(sp, canonicalize, scheme, input_type)
    lut = _lut(input_type)
    ndb = mesh.shape["db"]
    dev = mesh.device(mesh.local_ranks[0])
    drop0 = drops_partial_window(sp, enc)
    if cap is None:
        total = sum(os.path.getsize(p) for p in paths)
        # ~1 distinct k-mer a base at most, 2x for gzip, 1.5 margin
        est = total * (3 if any(p.endswith(".gz") for p in paths) else 1)
        cap = _pow2(int(est * 1.5 / ndb) + (1 << 12))

    def chunks():
        halo = sp.w - 1
        for p in paths:
            taxid = taxid_for_path(p, name_map)
            node = _node_of(tree, taxid)
            for _, seq, _ in fastx.read_fastx(p):
                if len(seq) < sp.c:
                    continue
                start = 0
                while start < len(seq):
                    end = min(start + block + halo, len(seq))
                    is_last = end >= len(seq)
                    codes = torch.from_numpy(
                        fastx.encode_contig(seq[start:end], lut))
                    em = enc.emissions(
                        codes[None, :].to(dev),
                        torch.tensor([end - start], dtype=torch.int32,
                                     device=dev))
                    mask = em.mask[0]
                    if drop0 and not is_last:  # not a real contig end
                        mask = mask.clone()
                        mask[0] = False
                    yield (torch.where(mask, em.values[0], -1),
                           (~mask).to(torch.uint8), node,
                           int(taxid) & 0xFFFFFFFF)
                    if is_last:
                        break
                    start += block

    stream = chunks()
    # balanced splitters from the key quantiles of up to 16 leading chunks
    # (k-mer keys fill [0, 4^k) and skew toward canonical minima)
    head, sample = [], []
    for item in stream:
        head.append(item)
        sample.append(item[0][item[1] == 0].cpu().numpy().view(np.uint64))
        if len(head) >= 16:
            break
    if not head:
        return KmerTable(np.zeros(0, np.uint64), np.zeros(0, np.uint32))
    fk = np.concatenate(sample)
    splitters = None
    if fk.size >= ndb:
        qs = np.quantile(fk.astype(np.float64), np.arange(1, ndb) / ndb)
        qs = np.minimum(qs, np.nextafter(2.0**64, 0.0))
        splitters = np.unique(qs.astype(np.uint64))
        if splitters.size < ndb - 1:  # degenerate: an even split
            splitters = None
    if splitters is None and 2 * sp.k < 64:
        dom = np.uint64(1) << np.uint64(2 * sp.k)
        splitters = (np.arange(1, ndb, dtype=np.uint64) * dom) // np.uint64(
            ndb)
    fold = ShardedLCAFold(tree, mesh, cap, splitters=splitters)
    for keys, pad, node, orig in itertools.chain(head, stream):
        fold.add_chunk(keys, pad, node, orig)
    keys, taxa = fold.finish()
    return KmerTable(keys, taxa)
