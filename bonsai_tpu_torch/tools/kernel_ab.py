"""Time the kernels of an earlier revision against the current ones.

Compiles some kernels' sources from a directory that holds an earlier
revision's ``bonsai_tpu_torch/csrc/`` (unpacked with ``git archive``,
say) into a library of its own, and calls the port's own wrappers on it
(``using`` routes ``kernels.launch`` to that library), so both revisions
take the same inputs and checks.  On one CUDA card, at the shapes that
``chip_smoke.py`` times, it checks that both revisions give the same
output and times them in turns: parent, change, change, parent.  Then it
lists each revision's kernels by device time from one ``torch.profiler``
window, as a second opinion.

    python -m bonsai_tpu_torch.tools.kernel_ab PARENT_CSRC GENOME NODES

KB1 ``minimizers`` (the first 4M windows of GENOME at k = 31, W = 1 and
W = 10, and at the seed disciplines' shapes: -k 21 -S 0x16,1x4 at W = 1,
-k 25 -w 37 -e at W = 13, and the hash-scored phase 2's: -k 25 -w 37 -t
at W = 13, -k 21 -S 0x16,1x4 -w 40 -t at W = 16), KB4
``compacted_minimizers`` (-C -k 31 -w 40 at W = 10, -C -k 25 -w 37 -e
and -C -k 25 -w 37 -t at W = 13), KB5 ``lookup_scores`` (2^22 k-mers,
half stored) and KB3 ``merge_fold`` (two 2^22-slot states with 3M valid
entries each, counts summed; NODES is a ``nodes.dmp`` whose taxids label
them).  The phase-1 map of a hash case is the chunk's own seeds and
random keys, 9.8M in all with 6 values (2^22 buckets, 128 MiB of slots,
inline: the ec -k 25 -t map's size).  Then the Python API's kernels at
the shapes of ``chip_smoke.py``'s phase 9d: KB1 -k 21 -S 0x16,1x4 -w 40
and KB4 -k 31 -w 40 (canonical) and -k 13 -w 29 under the Shannon score,
and on the forward frame 0 of GENOME's first record as protein
(``synthetic.translate``): KB1 unwindowed (its rolled fold) PROTEIN20
at k = 7 and 14, PROTEIN at k = 8, PROTEIN_3BIT at k = 22, PROTEIN_6
-k 12 -S 1x11 -w 30 Shannon, KB4 PROTEIN_14 -k 10 -w 24 and PROTEIN20
-k 7 -w 20 Shannon; KR1 at k = 31 and 64 canonical, 200 and 4097 (past
its tile), and at kmercnt's chunk, the first 2^20 bases, at k = 17 and
31 canonical; KB4's stream source (k = 64, W = 37) and K128's pack and
canonical pack of the whole record at k = 33, 40, 55 and 64 (phase
9f's).  Then the
sketch kernels at the shapes of ``chip_smoke.py``'s phase 9e on GENOME's
first record: KS1 (hashed, a new sketch a call, at p = 14, 16, 17, 20, 12
and 15, and its first 4, 16 and 64 x 2^p at p = 8, 12 and 14) and KS4
(wang_hash, nuccount, nuccount at an 8-B offset; KS5 at ndb = 4 and the
key-range mode as its controls) on its canonical 31-mers, KS1 at
errexp's sets (2^16 keys at p = 12, 2^12 at p = 8) and a GenomeChunker
chunk (2^20 31-mers, p = 16), KS2 (m = 4096, -S -s and default, a new
sketch a call and a full one, the sketch of the same stream) on the same
stream, KS3 on its k = 31 rolling-hash stream, and KB2 on its first 4M
windows' k = 31 W = 1 minimizers (the build's chunk); then, as a
yardstick of KS1's register raise alone, torch's ``scatter_reduce_``
(amax) of the precomputed index and rho at p = 14 and 16.  KB1, KB4, KB5,
KR1, KS1, KS4 and KS5 are timed by replaying a CUDA graph of 100
captured calls between two events (``gather_bench.graph_ms``), KB3, KB2
and KS3 (whose wrappers read the distinct count) and KS2 by CUDA events
around 100 back-to-back calls.  A case whose
entry point the parent's library lacks is skipped, and says so.  With
``--sketch`` only these sketch cases and KB2 run (``-k NAME``: only the
cases whose name holds a NAME; only their sources are built; each ``-e
EDIT`` an edited copy of PARENT_CSRC, ``SKETCH_EDITS``, timed in the same
turns), with ``--api``
only the Python API's cases (KB1, KB4, KR1 and K128 above; ``-k NAME``
and ``-e EDIT`` as with ``--sketch``, its edits ``KB4_EDITS``,
``KR1_EDITS`` and ``K128_EDITS``: pass the tree's ``csrc`` as
PARENT_CSRC to take a step of K128's design back out):

    python -m bonsai_tpu_torch.tools.kernel_ab --sketch PARENT_CSRC GENOME \\
        [-k NAME] [-e EDIT]...
    python -m bonsai_tpu_torch.tools.kernel_ab --api PARENT_CSRC GENOME \\
        [-k NAME] [-e EDIT]...

    python -m bonsai_tpu_torch.tools.kernel_ab --classify PARENT_CSRC \\
        READS NODES NAMEID GENOME...

K1 ``encode_probe``, K2 ``resolve`` and K3 ``step_outputs`` on the first
8192 reads of READS against the k = 31 database of the GENOMEs, built on
the host (NAMEID maps their sequence names to taxids), in dictionary
mode as ``classify`` runs them; the outputs of one kernel feed the next.
K1 runs the batch in the mask channel, and in the sparse-N channel (a
list of its in-read Ns; skipped for a parent without
``bk_encode_probe_sparse``); after the parent cases the tree's sparse
and mask instantiations are checked equal and timed against each other
in turns.
K1's spaced instantiation runs the same batch against the GENOMEs'
-k 21 -S 0x16,1x4 database, built on the card.  K1's radix
instantiation (skipped for a parent without ``bk_encode_probe_radix``)
runs at ``chip_smoke.py`` phase 9k's shape: 8192 protein reads of 33
residues (``synthetic.protein_reads`` of the GENOMEs' forward frames)
against their PROTEIN20 -k 7 database, built on the card.
K1 runs twice more where its probes hit: the same batch on a table of
its own k-mers, and the scale probe's shape of ``chip_smoke.py`` at 2^24
keys.  K2 runs three times more: on K1's output for that table (every
position hits), on 8192 rows of width 74 over a synthetic taxonomy of
2^21 nodes with lineages 25-40 deep (``synthetic.deep_tree`` and
``deep_rows``: the reads tie two deep taxa, so their LCA is walked), and
on 64 long reads of the first GENOME (P > 1024, ``synthetic.long_reads``);
each K2 case prints its bound (``bounds.resolve_work``) first.  A call
takes tens of microseconds, about what the host takes to enqueue it, so
these are timed by replaying a CUDA graph of 100 captured calls between
two events (``gather_bench.graph_ms``); a yardstick, one
elementwise torch pass over K3's output bytes, is timed the same way.
From a checkout:

    python -m bonsai_tpu_torch.tools.kernel_ab --classify \\
        build/parent/bonsai_tpu_torch/csrc \\
        tests/data/kraken_benchmarks/HiSeq_accuracy.fa \\
        tests/data/golden/ec_nodes.dmp tests/data/golden/ec_nameidmap.txt \\
        tests/data/ec/*.fna.gz

With ``--route`` (the same arguments as ``--classify``, then any
``-e EDIT``) KD1's three launches run at ``chip_smoke.py`` phase 9g's
shapes: the first a2a round of the first 8192 reads of READS at (1, 4)
on the k = 31 database of the GENOMEs (the sharded classifier's own
round, its four ranks sharing the card): rank 0's frame (ndb = 4,
capacity factor 1.05), the round's four probes in turn, each rank's
received frame against its own sub-table, rank 0's probe alone (its
sub-table's rows stay in L2 between replays) and rank 0's collect; the
probe and collect of two later rounds (``later_rounds``: the second
round at capacity factor 0.05, and a frame of nearly all U64_MAX pad
rows); then the frame at 4M random queries (ndb = 4, none done) and rank
0's queries at ndb = 1024.  All by graph replay, each with its bound
(``bounds``) and each probe's split of its keys (``bounds.probe_split``)
printed first, and rank 0's frame also by events around back-to-back
wrapper calls, which the host's enqueue can bound.  A collect call is
the collect alone on a state cloned once (it updates the state in
place, the same bytes each call); its outputs are checked from that
state.  Last, the floors of those launches (``gather_bench.empty_launch``
by graph replay: empty at the probe's and collect's grids, and a
cooperative one with a grid barrier at collect's).  Each EDIT names an edited copy of
PARENT_CSRC (``ROUTE_EDITS``, several joined by '+': the probe reading
row 1 only, design (a) loading both candidate rows at once and, on it,
more keys a thread or the pad rows probed once a block, fixed block
sizes, other queries a collect thread, the cooperative collect), timed
in the same turns;
pass the tree's own ``bonsai_tpu_torch/csrc`` as the parent to sweep
the tree's design:

    python -m bonsai_tpu_torch.tools.kernel_ab --route \\
        build/parent/bonsai_tpu_torch/csrc \\
        tests/data/kraken_benchmarks/HiSeq_accuracy.fa \\
        tests/data/golden/ec_nodes.dmp tests/data/golden/ec_nameidmap.txt \\
        tests/data/ec/*.fna.gz [-e EDIT]...

With ``--hash`` only the hash-scored phase 2's kernels run, at the
default mode's shapes and maps: KB1 -k 25 -w 37 -t (W = 13) and -k 21 -S
0x16,1x4 -w 40 -t (W = 16), KB4 -C -k 25 -w 37 -t and KB5 (2^22 k-mers,
half stored), and on the genome's frame 0 translated the other
alphabets' instantiations, KB1 PROTEIN_6 -k 12 -S 1x11 -w 30 -t (W = 8)
and KB4 PROTEIN20 -k 7 -w 20 -t (W = 14), each by graph replay with its
slot rows (``bounds.probe_rows``) and G rows/s beside its time.  The
change is the tree's build of their sources, and each library's blocks a
SM (the entry points ``bk_*_hash_blocks_per_sm``, the tree's appended to
a copy of a source that lacks them or put in place of a parent's that
takes other arguments) and ptxas's registers and spills are printed
first.
Each EDIT names an edited copy of the parent's sources (``HASH_EDITS``,
several joined by '+'), timed in the same turns: a design experiment
(the probe or the value read taken out, another batch size, KB5 slice
by slice: ``kb5-sliced``, ``SLICED_KB5``); an edit that changes the
output is timed but not checked.  With ``--fold``, KB5 also runs on the
-k 25 -t phase-1 map of the GENOMEs after it, built on the card (NAMEID
maps their sequence names to taxids of NODES): at the folded keys of the
-k 25 -w 37 -t phase-2 device build, as ``chip_smoke.py`` phase 9c
scores them, and at 2^16 to 2^22 k-mers half stored:

    python -m bonsai_tpu_torch.tools.kernel_ab --hash PARENT_CSRC GENOME \\
        [EDIT...] [--fold tests/data/golden/ec_nodes.dmp \\
        tests/data/golden/ec_nameidmap.txt tests/data/ec/*.fna.gz]

Each prints one line per case, then the results as one JSON object, and
needs a CUDA card.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import kernels
from ..core import encoder as enc
from ..core.alphabet import DNA4
from ..db import build_device as bd
from ..db.table import unique_u64
from ..io import fastx
from ..taxonomy.tree import TaxTree
from .bounds import resolve_bound_text
from .gather_bench import graph_ms, time_ms
from .synthetic import deep_rows, deep_tree, long_reads, translate

SEED = 20261016
ITERS = 100  # calls a timing: a few ms of device time even at 30 us a call
OUT_DIR = os.path.join(os.path.dirname(kernels.BUILD_DIR), "kernel_ab")
BUILD_SOURCES = ("merge_fold", "minimizers", "compacted_minimizers",
                 "lookup_scores", "rolling", "sort_unique", "hll", "setsketch",
                 "bitmix", "encode128")
CLASSIFY_SOURCES = ("encode_probe", "encode_probe_radix", "resolve",
                    "step_outputs")
# the source of each --sketch case's entry point
SKETCH_SOURCES = {
    "bk_hll_fill": "hll", "bk_csetsketch_update": "setsketch",
    "bk_sort_count": "sort_unique", "bk_sort_unique": "sort_unique",
    "bk_bitmix": "bitmix", "bk_shard_owner": "bitmix",
    "bk_key_range": "bitmix", "bk_nuccount": "bitmix"}
ROUTE_SOURCES = ("route",)
HASH_SOURCES = ("minimizers", "compacted_minimizers", "lookup_scores")
CLASSIFY_BATCH = 8192
# KB1's and KB4's one entry point each
KB1, KB4 = "bk_minimizers_gen", "bk_compacted_minimizers_gen"
# --hash's design of KB5 slice by slice (the edit kb5-sliced, measured and
# not kept: PERF.md "PR 20"): the image's rows cut into S = 2^ls slices of
# at most 16 MiB (slot rows, and flat values at the same row indices), and
# the k-mers probed in that order so that the resident blocks read one or
# two slices, which stay in L2.  A memset of the counters, then
#   1. count_kernel: each k-mer's first bucket's slice counted (warp-
#      aggregated shared atomics, one device atomic a slice a block);
#   2. scatter_kernel: a tile's (h, index) staged by slice in shared memory,
#      each slice's run reserved with one device atomic and written in
#      order; the second buckets' slices counted (each slice's room in the
#      miss list);
#   3. probe1_kernel: the first rows in slice order, the score written at
#      the k-mer's index; a miss appended to its second bucket's slice of
#      the miss list (warp-aggregated device atomics);
#   4. probe2_kernel: the second rows of the miss list (places past a
#      slice's misses idle), the score or U64_MAX.
# Its scratch (24 B a k-mer) is taken with cudaMallocAsync on the stream.
SLICED_KB5 = r"""constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kSliceBytesLog2 = 24;  // 16 MiB a slice
constexpr int kMaxSlicesLog2 = 8;
constexpr int kMaxSlices = 1 << kMaxSlicesLog2;
constexpr int kPerThread = 8;  // k-mers a thread of steps 1 and 2
constexpr int kTile = kThreads * kPerThread;
using Scan = cub::BlockScan<uint32_t, kThreads>;

// log2 of the slices of an image, 0 where it has one
int slices_log2(int lgnb, int is_inline) {
  const int row_log2 = is_inline ? 5 : 6;  // slot row, and flat values
  const int ls = lgnb + row_log2 - kSliceBytesLog2;
  return ls <= 0 ? 0 : ls < kMaxSlicesLog2 ? ls : kMaxSlicesLog2;
}

// The scratch of the sliced path: per slice the first buckets' counts and
// cursors and the second buckets' counts and cursors (u32), then the
// slice-ordered list (h, index) and the miss list (h, index).
struct Scratch {
  uint32_t *cnt1, *cur1, *cnt2, *cur2;
  uint64_t *h1, *h2;
  uint32_t *i1, *i2;
};

constexpr int64_t kHead = 16 * kMaxSlices;  // the counters, 16-B aligned

int64_t scratch_bytes(int64_t n) { return kHead + 24 * n; }

Scratch carve(void* base, int64_t n) {
  char* p = (char*)base;
  uint32_t* c = (uint32_t*)p;
  Scratch s{c, c + kMaxSlices, c + 2 * kMaxSlices, c + 3 * kMaxSlices};
  s.h1 = (uint64_t*)(p + kHead);
  s.h2 = s.h1 + n;
  s.i1 = (uint32_t*)(s.h2 + n);
  s.i2 = s.i1 + n;
  return s;
}

__device__ __forceinline__ void buckets(const bk::ProbeTable& t, uint64_t h,
                                        uint64_t* b1, uint64_t* b2) {
  const uint64_t bmask = (1ULL << t.lgnb) - 1;
  *b1 = h & bmask;
  *b2 = *b1 ^ (bk::splitmix64((h >> t.lgnb) ^ bk::kBucketSalt) & bmask);
}

// one shared (or device) atomic a group of lanes adding to the same
// counter: each active lane gets its rank among the earlier lanes of its
// group plus the counter's value before the group's add
__device__ __forceinline__ uint32_t aggregated_add(uint32_t* ctr,
                                                   unsigned active,
                                                   int key) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(active, key);
  const int leader = __ffs(peers) - 1;
  uint32_t base = 0;
  if (lane == leader) base = atomicAdd(ctr, (uint32_t)__popc(peers));
  base = __shfl_sync(peers, base, leader);
  return base + __popc(peers & ((1u << lane) - 1));
}

// step 1: the first buckets' slices counted
__global__ void __launch_bounds__(kThreads)
    count_kernel(const uint64_t* __restrict__ kmers, int64_t n,
                 bk::ProbeTable t, int shift, int S,
                 uint32_t* __restrict__ cnt1) {
  __shared__ uint32_t s_cnt[kMaxSlices];
  for (int s = threadIdx.x; s < S; s += kThreads) s_cnt[s] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int64_t i = base + u * kThreads;
    const bool in = i < n;
    const unsigned active = __ballot_sync(kAll, in);
    if (in) {
      const uint64_t b1 = bk::splitmix64(kmers[i]) & ((1ULL << t.lgnb) - 1);
      const int s = (int)(b1 >> shift);
      aggregated_add(&s_cnt[s], active, s);
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += kThreads)
    if (s_cnt[s]) atomicAdd(&cnt1[s], s_cnt[s]);
}

// the exclusive prefix sums of cnt[0..S) into start[0..S] (start[S], the
// total), by the block
__device__ __forceinline__ void slice_starts(const uint32_t* cnt, int S,
                                             uint32_t* start,
                                             Scan::TempStorage& tmp) {
  const int s = threadIdx.x;
  uint32_t v = s < S ? __ldcg(cnt + s) : 0, first, total;
  Scan(tmp).ExclusiveSum(v, first, total);
  if (s < S) start[s] = first;
  if (s == 0) start[S] = total;
  __syncthreads();
}

// step 2: (h, index) of a tile into first-slice order, by runs; the second
// buckets' slices counted
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const uint64_t* __restrict__ kmers, int64_t n,
                   bk::ProbeTable t, int shift, int S, Scratch sc) {
  __shared__ Scan::TempStorage tmp;
  __shared__ uint32_t s_start[kMaxSlices + 1];
  __shared__ uint32_t s_cnt[kMaxSlices], s_cnt2[kMaxSlices];
  __shared__ uint32_t s_off[kMaxSlices], s_out[kMaxSlices];
  __shared__ uint64_t s_h[kTile];
  __shared__ uint32_t s_i[kTile];
  __shared__ uint8_t s_sl[kTile];
  const int tid = threadIdx.x;
  for (int s = tid; s < S; s += kThreads) s_cnt[s] = s_cnt2[s] = 0;
  slice_starts(sc.cnt1, S, s_start, tmp);  // its barrier orders the zeros
  const int64_t tile0 = (int64_t)blockIdx.x * kTile;
  uint64_t h[kPerThread];
  uint32_t rank[kPerThread];
  int sl[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int64_t i = tile0 + u * kThreads + tid;
    const bool in = i < n;
    const unsigned active = __ballot_sync(kAll, in);
    if (in) {
      uint64_t b1, b2;
      h[u] = bk::splitmix64(kmers[i]);
      buckets(t, h[u], &b1, &b2);
      sl[u] = (int)(b1 >> shift);
      rank[u] = aggregated_add(&s_cnt[sl[u]], active, sl[u]);
      const int s2 = (int)(b2 >> shift);
      aggregated_add(&s_cnt2[s2], active, s2);
    }
  }
  __syncthreads();
  {  // each slice's place in the tile and its run in the list
    const int s = tid;
    const uint32_t c = s < S ? s_cnt[s] : 0;
    uint32_t first, total;
    Scan(tmp).ExclusiveSum(c, first, total);
    if (s < S) {
      s_off[s] = first;
      // the run's first list index less its first tile place (mod 2^32)
      if (c) s_out[s] = s_start[s] + atomicAdd(&sc.cur1[s], c) - first;
      if (s_cnt2[s]) atomicAdd(&sc.cnt2[s], s_cnt2[s]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    if (tile0 + u * kThreads + tid < n) {
      const uint32_t p = s_off[sl[u]] + rank[u];
      s_h[p] = h[u];
      s_i[p] = (uint32_t)(tile0 + u * kThreads + tid);
      s_sl[p] = (uint8_t)sl[u];
    }
  }
  __syncthreads();
  const int m = (int)min((int64_t)kTile, n - tile0);
  for (int p = tid; p < m; p += kThreads) {
    const uint32_t g = s_out[s_sl[p]] + p;
    sc.h1[g] = s_h[p];
    sc.i1[g] = s_i[p];
  }
}

// the score of a match in a row (as probe.cuh's probe reads the value)
__device__ __forceinline__ uint64_t value_of(const bk::ProbeTable& t,
                                             uint64_t acc) {
  int64_t idx = t.is_inline ? (int64_t)(uint32_t)acc : (int64_t)acc;
  if (idx > t.n_vals - 1) idx = t.n_vals - 1;
  return t.vals[idx];
}

// step 3: the first rows, slice by slice; misses into the miss list by
// their second bucket's slice
__global__ void __launch_bounds__(kThreads)
    probe1_kernel(int64_t n, bk::ProbeTable t, int shift, int S, Scratch sc,
                  uint64_t* __restrict__ out) {
  __shared__ Scan::TempStorage tmp;
  __shared__ uint32_t s_start[kMaxSlices + 1];
  slice_starts(sc.cnt2, S, s_start, tmp);
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  bool miss = false;
  uint64_t h = 0, b1 = 0, b2 = 0;
  uint32_t idx = 0;
  if (p < n) {
    h = __ldcs(sc.h1 + p);
    idx = __ldcs(sc.i1 + p);
    buckets(t, h, &b1, &b2);
    const ulonglong2 lo = t.slots[2 * b1], hi = t.slots[2 * b1 + 1];
    uint64_t acc = 0;
    const uint64_t e = (1ULL << 63) | ((h >> t.lgnb) << t.vbits);
    if (bk::match_row(t, lo, hi, e, b1, acc))
      out[idx] = value_of(t, acc);
    else
      miss = true;
  }
  const unsigned active = __ballot_sync(kAll, miss);
  if (miss) {
    const int s2 = (int)(b2 >> shift);
    const uint32_t g = s_start[s2] +
                       aggregated_add(&sc.cur2[s2], active, s2);
    __stcs(sc.h2 + g, h);
    __stcs(sc.i2 + g, idx);
  }
}

// step 4: the second rows of the misses, slice by slice
__global__ void __launch_bounds__(kThreads)
    probe2_kernel(int64_t n, bk::ProbeTable t, int S, Scratch sc,
                  uint64_t* __restrict__ out) {
  __shared__ Scan::TempStorage tmp;
  __shared__ uint32_t s_start[kMaxSlices + 1];
  slice_starts(sc.cnt2, S, s_start, tmp);
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  int lo = 0, hi = S;  // the slice whose room holds p: start <= p
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (s_start[mid] <= (uint32_t)p) lo = mid; else hi = mid;
  }
  if ((uint32_t)p - s_start[lo] >= __ldcg(sc.cur2 + lo)) return;
  const uint64_t h = __ldcs(sc.h2 + p);
  const uint32_t idx = __ldcs(sc.i2 + p);
  uint64_t b1, b2;
  buckets(t, h, &b1, &b2);
  const ulonglong2 r0 = t.slots[2 * b2], r1 = t.slots[2 * b2 + 1];
  uint64_t acc = 0;
  const uint64_t e = (3ULL << 62) | ((h >> t.lgnb) << t.vbits);
  out[idx] = bk::match_row(t, r0, r1, e, b2, acc) ? value_of(t, acc) : ~0ULL;
}

unsigned blocks(int64_t n, int64_t per) {
  return (unsigned)((n + per - 1) / per);
}

// the sliced path on ``st`` for an image past one slice (its scratch taken
// and given back on the stream), or -1 for the direct kernel
int sliced_lookup(const bk::ProbeTable& t, const uint64_t* km, int64_t n,
                  uint64_t* o, cudaStream_t st) {
  const int ls = slices_log2(t.lgnb, t.is_inline);
  if (!ls || n >= ((int64_t)1 << 32)) return -1;
  void* scratch = nullptr;
  cudaError_t e = cudaMallocAsync(&scratch, scratch_bytes(n), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(scratch, 0, kHead, st);
  if (e != cudaSuccess) return (int)e;
  const int S = 1 << ls, shift = t.lgnb - ls;
  const Scratch sc = carve(scratch, n);
  count_kernel<<<blocks(n, kTile), kThreads, 0, st>>>(km, n, t, shift, S,
                                                      sc.cnt1);
  scatter_kernel<<<blocks(n, kTile), kThreads, 0, st>>>(km, n, t, shift, S,
                                                        sc);
  probe1_kernel<<<blocks(n, kThreads), kThreads, 0, st>>>(n, t, shift, S, sc,
                                                          o);
  probe2_kernel<<<blocks(n, kThreads), kThreads, 0, st>>>(n, t, S, sc, o);
  e = cudaFreeAsync(scratch, st);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

"""

# --hash's edited copies of the parent's sources, for design experiments:
# name -> (whether the output stays the parent's, substitutions (file, old
# text, new text)).  A copy takes each substitution whose old text its file
# holds, and must take one.
HASH_EDITS = {
    # the hash score a constant (0, or U64_MAX in a batch): the roll and
    # the window, no probe
    "no-probe": (False, (
        ("probe.cuh",
         "  uint64_t v = 0;\n  return probe(t, kmer, &v) ? v : ~0ULL;",
         "  return 0;"),
        ("probe.cuh", "    n = n_;\n", "    n = 0;\n"),
    )),
    # the slot rows read, the value not: its index stands in for it
    "no-value": (False, (
        ("probe.cuh", "*val = t.vals[idx];", "*val = (uint64_t)idx;"),
        ("probe.cuh", "out[u] = t.vals[idx];", "out[u] = (uint64_t)idx;"),
    )),
    # another number of k-mers a thread probes at once
    **{f"U{u}": (True, tuple((f, "kProbeBatch = 4;", f"kProbeBatch = {u};")
                             for f in ("minimizers.cu",
                                       "compacted_minimizers.cu")))
       for u in (1, 2, 6, 8)},
    # KB1's window minima skipped: the roll, the probes and the output
    "no-window": (False, (("minimizers.cu", "  if (W > 1) {\n    uint16_t suf",
                           "  if (false) {\n    uint16_t suf"),)),
    # KB5 with 4 k-mers a thread, probed together (ProbeBatch)
    "kb5-x4": (True, (("lookup_scores.cu",
                       "  const int64_t i = (int64_t)blockIdx.x * kThreads "
                       "+ threadIdx.x;\n  if (i >= n) return;\n"
                       "  out[i] = bk::hash_score(t, kmers[i]);",
                       "  const int64_t i0 = (int64_t)blockIdx.x * kThreads"
                       " * 4 + threadIdx.x;\n  uint64_t km[4], sc[4];\n"
                       "  int m = 0;\n#pragma unroll\n"
                       "  for (int u = 0; u < 4; ++u) {\n"
                       "    const bool in = i0 + u * kThreads < n;\n"
                       "    km[u] = in ? kmers[i0 + u * kThreads] : 0;\n"
                       "    m += in;\n  }\n"
                       "  bk::hash_scores(t, km, sc, m);\n#pragma unroll\n"
                       "  for (int u = 0; u < 4; ++u)\n"
                       "    if (u < m) out[i0 + u * kThreads] = sc[u];"),)),
    # KB5 slice by slice (SLICED_KB5) for an image past one 16 MiB slice
    "kb5-sliced": (True, (
        ("lookup_scores.cu", '#include "probe.cuh"\n',
         '#include <cub/block/block_scan.cuh>\n\n#include "probe.cuh"\n'),
        ("lookup_scores.cu", "}  // namespace\n", SLICED_KB5 +
         "}  // namespace\n"),
        ("lookup_scores.cu", "  const int64_t blocks = (n + kThreads - 1) / "
         "kThreads;\n", "  const int sl = sliced_lookup(t, (const uint64_t*)"
         "kmers, n,\n                               (uint64_t*)out, "
         "(cudaStream_t)stream);\n  if (sl >= 0) return sl;\n"
         "  const int64_t blocks = (n + kThreads - 1) / kThreads;\n"),
    )),
    # the hash instantiations held to 3 blocks a SM (at most 85 registers)
    "lb3": (True, tuple((f, f"__launch_bounds__(kThreads)\n    {kern}(",
                         f"__launch_bounds__(kThreads, 3)\n    {kern}(")
                        for f, kern in (("minimizers.cu", "minimizers_kernel"),
                                        ("compacted_minimizers.cu",
                                         "window_kernel"))) + (
        ("compacted_minimizers.cu",
         "__launch_bounds__(kThreads) window_kernel(Args a)",
         "__launch_bounds__(kThreads, 3) window_kernel(Args a)"),)),
}

# --route's design (a): a probe that loads both candidate rows of a key
# before comparing either (one random trip where probe.cuh's probe makes
# two on a miss; row 1 still decides where it holds the key), one pass of
# kDualKeys keys a thread
DUAL_PROBE = r"""constexpr int kDualThreads = 256;  // a probe block's threads
constexpr int kDualKeys = 1;  // received keys a probe thread

// A received key's two candidate rows, both loaded at once: the second
// bucket is b1 ^ splitmix64(q ^ salt), a function of the key alone.
""" + r"""struct DualRows {
  ulonglong2 row[4];  // row 1's 16-B halves, then row 2's
  uint64_t b1, b2, e;  // the buckets; row 1's slot tag (row 2 adds bit 62)
};

__device__ __forceinline__ void issue(const bk::ProbeTable& t, uint64_t key,
                                      DualRows& d) {
  const uint64_t bmask = (1ULL << t.lgnb) - 1;
  const uint64_t h = bk::splitmix64(key);
  const uint64_t q = h >> t.lgnb;
  d.b1 = h & bmask;
  d.b2 = d.b1 ^ (bk::splitmix64(q ^ bk::kBucketSalt) & bmask);
  d.e = (1ULL << 63) | (q << t.vbits);
  d.row[0] = t.slots[2 * d.b1];
  d.row[1] = t.slots[2 * d.b1 + 1];
  d.row[2] = t.slots[2 * d.b2];
  d.row[3] = t.slots[2 * d.b2 + 1];
}

// Whether the key is in the image and, where it is, the value index of
// probe: row 1 decides where it holds a match, else row 2; the matching
// lanes' fields (inline, summed in 32 bits) or flat slot positions
// (64-bit) summed, clamped to the value array.  *sel is the u32 of the
// sum, probe's sel_out.
__device__ __forceinline__ bool locate(const bk::ProbeTable& t,
                                       const DualRows& d, int64_t* idx,
                                       uint32_t* sel) {
  uint64_t acc = 0;
  bool found = bk::match_row(t, d.row[0], d.row[1], d.e, d.b1, acc);
  if (!found)
    found = bk::match_row(t, d.row[2], d.row[3], d.e | (1ULL << 62), d.b2,
                          acc);
  *sel = (uint32_t)acc;
  int64_t i = t.is_inline ? (int64_t)(uint32_t)acc : (int64_t)acc;
  *idx = i > t.n_vals - 1 ? t.n_vals - 1 : i;
  return found;
}

// kDualKeys keys a thread, a block's kDualThreads apart; one pass
__global__ void __launch_bounds__(kDualThreads)
    probe_kernel(const uint64_t* __restrict__ recv, int64_t n,
                 bk::ProbeTable t, int want_idx, uint64_t* __restrict__ resp) {
  const int64_t i0 =
      (int64_t)blockIdx.x * (kDualThreads * kDualKeys) + threadIdx.x;
  DualRows d[kDualKeys];
#pragma unroll
  for (int u = 0; u < kDualKeys; ++u) {
    const int64_t i = i0 + u * kDualThreads;
    if (i < n) issue(t, recv[i], d[u]);
  }
  int64_t idx[kDualKeys];
  uint32_t sel[kDualKeys];
  bool found[kDualKeys];
#pragma unroll
  for (int u = 0; u < kDualKeys; ++u)
    found[u] = i0 + u * kDualThreads < n && locate(t, d[u], &idx[u], &sel[u]);
#pragma unroll
  for (int u = 0; u < kDualKeys; ++u) {
    const int64_t i = i0 + u * kDualThreads;
    if (i >= n) break;
    uint64_t w = 0;
    if (found[u]) {
      const uint64_t val = t.vals[idx[u]];
      w = (want_idx ? (uint64_t)sel[u] << 32 : val & ~0xFFFFFFFFull) |
          (1ull << 31) | (val & 0x7FFFFFFFull);
    }
    resp[i] = w;
  }
}

"""
# the serial probe kernel's head (probe.cuh's probe a thread) at blocks
# of t threads
PROBE_HEAD = ("__launch_bounds__({t})\n    probe_kernel(const uint64_t* "
              "__restrict__ recv, int64_t n,\n                 bk::ProbeTable"
              " t, int want_idx, uint64_t* __restrict__ resp) {{\n  const "
              "int64_t stride = (int64_t)gridDim.x * {t};\n  for (int64_t i ="
              " (int64_t)blockIdx.x * {t} + threadIdx.x; i < n;")
DUAL_LAUNCH = ("  constexpr int64_t span = kDualThreads * kDualKeys;\n"
               "  probe_kernel<<<(unsigned)((n + span - 1) / span), "
               "kDualThreads, 0,\n                 (cudaStream_t)stream>>>("
               "(const uint64_t*)recv, n, t,\n"
               "                                         want_idx, "
               "(uint64_t*)resp);")
# a cooperative collect (coop): the blocks' counts in a device array, a
# grid barrier, block 0's sum
COOP_SUM = """    g_cnt[blockIdx.x] = sum;
  }
  cg::this_grid().sync();
  if (blockIdx.x == 0 && warp == 0) {
    unsigned long long sum = 0;
    for (int r = lane; r < (int)gridDim.x; r += 32) sum += __ldcg(g_cnt + r);
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) sum += __shfl_xor_sync(kAll, sum, x);
    if (lane == 0) *pending = sum;
  }
}
"""
COOP_LAUNCH = """  void* args[] = {&b, &sq, &Q, &dump, &d, &h, &c, &o, &p};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      vec ? (const void*)collect_kernel<true>
          : (const void*)collect_kernel<false>,
      grid, dim3(kThreads), args, 0, s);
  cudaGetLastError();
  return (int)e;
"""
# --route's edited copies, as HASH_EDITS; their texts are those of the
# serial probe at blocks of kThreads (an earlier revision's route.cu and
# probe.cuh: row1, dual, pt*) or the tree's (row1, dual, pt*, coop, cq*,
# no-vec), so pass either as the parent;
# "dual" makes design (a), and keys2, keys4, pad-once and pt* edit it
# further ("dual+keys2")
ROUTE_EDITS = {
    # the probe reads row 1 only, a key missing there is missing: inexact
    "row1": (False, (
        ("probe.cuh", "for (int ch = 0; ch < 2 && !found; ++ch)",
         "for (int ch = 0; ch < 1 && !found; ++ch)"),
        ("route.cu", "  d.row[2] = t.slots[2 * d.b2];\n"
         "  d.row[3] = t.slots[2 * d.b2 + 1];\n",
         "  d.row[2] = d.row[3] = make_ulonglong2(0, 0);\n"),
    )),
    # design (a), DUAL_PROBE: the serial probe renamed and left unused
    "dual": (True, (
        ("route.cu", "    probe_kernel(const uint64_t* __restrict__ recv",
         "    probe_kernel_serial(const uint64_t* __restrict__ recv"),
        ("route.cu", "size_t frame_smem(int64_t ndb)",
         DUAL_PROBE + "size_t frame_smem(int64_t ndb)"),
        *(("route.cu", f"  probe_kernel<<<{g}, {t}, 0, (cudaStream_t)stream>>>("
           "\n      (const uint64_t*)recv, n, t, want_idx, (uint64_t*)resp);",
           DUAL_LAUNCH) for g, t in (("grid(n)", "kThreads"),
                                     ("probe_grid(n)", "kProbeThreads"))),
    )),
    # received keys a thread of design (a), all rows in flight together
    **{f"keys{k}": (True, (("route.cu", "kDualKeys = 1;",
                            f"kDualKeys = {k};"),)) for k in (2, 4)},
    # a probe block's threads, fixed: the parent's (256), design (a)'s
    # (256) or the tree's (128)
    **{f"pt{t}": (True, (
        ("route.cu", PROBE_HEAD.format(t="kThreads"), PROBE_HEAD.format(t=t)),
        ("route.cu", "  probe_kernel<<<grid(n), kThreads, 0,",
         f"  probe_kernel<<<grid({grid}), {t}, 0,"),
        ("route.cu", "kDualThreads = 256;", f"kDualThreads = {t};"),
        ("route.cu", "kProbeThreads = 128;", f"kProbeThreads = {t};"),
    )) for t, grid in ((32, "8 * n"), (64, "4 * n"), (128, "2 * n"),
                       (256, "n"), (512, "(n + 1) / 2"))},
    # queries a collect thread
    **{f"cq{q}": (True, (("route.cu", "kCollectQ = 4;",
                          f"kCollectQ = {q};"),)) for q in (8, 16)},
    # collect's scalar loads and stores, whatever the alignment
    "no-vec": (True, (("route.cu", "  const bool vec = (uintptr_t)slotq",
                       "  const bool vec = false && (uintptr_t)slotq"),)),
    # collect as one cooperative launch whose blocks meet at a grid
    # barrier, block 0 summing their counts (COOP_SUM; up to the blocks
    # resident at once: 9g's shapes)
    "coop": (True, (
        ("route.cu", "__device__ unsigned long long g_tally = 0;\n",
         "__device__ unsigned long long g_cnt[kCollectBlocks];\n"),
        ("route.cu", "    const unsigned long long old =\n"
         "        atomicAdd(&g_tally, (1ull << kTallyShift) | sum);\n"
         "    if ((old >> kTallyShift) == gridDim.x - 1) {  // the last block\n"
         "      *pending = (old & ((1ull << kTallyShift) - 1)) + sum;\n"
         "      g_tally = 0;\n    }\n  }\n}\n", COOP_SUM),
        ("route.cu", "  if (vec)\n    collect_kernel<true><<<grid, kThreads, 0,"
         " s>>>(b, sq, Q, dump, d, h, c, o,\n"
         "                                                   p);\n  else\n"
         "    collect_kernel<false><<<grid, kThreads, 0, s>>>(b, sq, Q, dump,"
         " d, h, c,\n                                                    o, p);"
         "\n  return (int)cudaGetLastError();\n", COOP_LAUNCH),
    )),
    # design (b) on design (a): the U64_MAX rows priced once a block:
    # thread 0 probes U64_MAX while the others' rows are in flight, and a
    # thread whose key is U64_MAX stores that word from shared memory
    "pad-once": (True, (
        ("route.cu", "  DualRows d[kDualKeys];\n#pragma unroll\n"
         "  for (int u = 0; u < kDualKeys; ++u) {\n"
         "    const int64_t i = i0 + u * kDualThreads;\n"
         "    if (i < n) issue(t, recv[i], d[u]);\n  }\n",
         "  __shared__ uint64_t s_pad;\n  DualRows d[kDualKeys];\n"
         "  bool pad[kDualKeys];\n#pragma unroll\n"
         "  for (int u = 0; u < kDualKeys; ++u) {\n"
         "    const int64_t i = i0 + u * kDualThreads;\n"
         "    const uint64_t key = i < n ? recv[i] : ~0ull;\n"
         "    pad[u] = key == ~0ull;\n    if (!pad[u]) issue(t, key, d[u]);\n"
         "  }\n  if (threadIdx.x == 0) {\n    DualRows p;\n"
         "    issue(t, ~0ull, p);\n    int64_t x;\n    uint32_t sl;\n"
         "    const bool f = locate(t, p, &x, &sl);\n"
         "    const uint64_t val = f ? t.vals[x] : 0;\n"
         "    s_pad = f ? (want_idx ? (uint64_t)sl << 32\n"
         "                          : val & ~0xFFFFFFFFull) |\n"
         "                    (1ull << 31) | (val & 0x7FFFFFFFull)\n"
         "              : 0;\n  }\n  __syncthreads();\n"),
        ("route.cu", "    found[u] = i0 + u * kDualThreads < n && locate(",
         "    found[u] = i0 + u * kDualThreads < n && !pad[u] && locate("),
        ("route.cu", "    resp[i] = w;\n  }\n}\n\nsize_t frame_smem",
         "    resp[i] = pad[u] ? s_pad : w;\n  }\n}\n\nsize_t frame_smem"),
    )),
}
# the default and --api modes' edited copies of KB4 (compacted_minimizers.cu),
# as HASH_EDITS: the places a thread of the scoring pass (lex,
# entropy-file, DNA Shannon) unrolls
KB4_EDITS = {
    f"score-u{u}": (True, (("compacted_minimizers.cu",
                            "#pragma unroll 4\n      for (int pl = base",
                            f"#pragma unroll {u}\n      for (int pl = base"),))
    for u in (1, 2, 8)
}
# the default and --api modes' edited copies of K128's pack (encode128.cu),
# each a step of its design taken back out (pass the tree's csrc as the
# parent): k128-warmup, the first window rolled from its k codes one at a
# time; k128-rc, the reverse complement taken by rc128 at every window in
# place of the rolled one; k128-scalar, a lane and a flag a position a
# store; k128-st, plain stores in place of streaming ones; k128-t256 and
# k128-t64, tiles of 4096 and 1024 positions (blocks of 256 and 64);
# k128-run32, 32 windows a thread in blocks of 64
K128_EDITS = {
    "k128-warmup": (True, (("encode128.cu",
                            "  first_window(w32, b0, k, &hi, &lo, &last_n, "
                            "&last_big);\n",
                            "  hi = lo = 0, last_n = last_big = -1;\n"
                            "  for (int i = 0; i < k; ++i) {\n"
                            "    const int c = s_code[b0 + i];\n"
                            "    if (c < 0) last_n = i;\n"
                            "    if (c > 3) last_big = i;\n"
                            "    hi = ((hi << 2) | (lo >> 62)) & hmask;\n"
                            "    lo = (lo << 2) | (uint64_t)(c < 0 ? 0 : c & 3);"
                            "\n  }\n"),)),
    "k128-rc": (True, (("encode128.cu",
                        "    const bool take_rc = kCanon && ",
                        "    if (kCanon) rc128(hi, lo, k_hi, &rhi, &rlo);\n"
                        "    const bool take_rc = kCanon && "),)),
    "k128-scalar": (True, (
        ("encode128.cu", "  if (r0 + kRun <= npos && ((uintptr_t)erow & 15) "
         "== 0) {", "  if (false) {"),
        ("encode128.cu", "  const int head = (int)(((uintptr_t)hrow >> 3) & "
         "1);", "  const int head = 0;\n  for (int p = tid; p < npos; p += "
         "kThreads) {\n    hrow[p] = (int64_t)s_hi[sx(p)];\n    lrow[p] = "
         "(int64_t)s_lo[sx(p)];\n  }\n  if (true) return;"),
    )),
    "k128-st": (True, (
        ("encode128.cu", "__stcs((ulonglong2*)(hrow + p), make_ulonglong2("
         "s_hi[x], s_hi[y]));", "*(ulonglong2*)(hrow + p) = make_ulonglong2("
         "s_hi[x], s_hi[y]);"),
        ("encode128.cu", "__stcs((ulonglong2*)(lrow + p), make_ulonglong2("
         "s_lo[x], s_lo[y]));", "*(ulonglong2*)(lrow + p) = make_ulonglong2("
         "s_lo[x], s_lo[y]);"),
        ("encode128.cu", "__stcs((uint4*)erow + q, make_uint4(f[0], f[1], "
         "f[2], f[3]));", "((uint4*)erow)[q] = make_uint4(f[0], f[1], f[2], "
         "f[3]);"),
    )),
    **{f"k128-t{t}": (True, (("encode128.cu", "constexpr int kThreads = 128;",
                              f"constexpr int kThreads = {t};"),))
       for t in (256, 64)},
    "k128-run32": (True, (
        ("encode128.cu", "constexpr int kThreads = 128;",
         "constexpr int kThreads = 64;"),
        ("encode128.cu", "constexpr int kRun = 16;", "constexpr int kRun = 32;"),
    )),
}
# the default and --api modes' edited copies of KB1 (minimizers.cu):
# kb1-stcs, its keys and flags by streaming stores
KB1_EDITS = {
    "kb1-stcs": (True, (
        ("minimizers.cu", "        *(ulonglong2*)(krow + s0) =\n"
         "            make_ulonglong2(s_val[sx(s0)], s_val[sx(s0 + 1)]);",
         "        __stcs((ulonglong2*)(krow + s0),\n"
         "            make_ulonglong2(s_val[sx(s0)], s_val[sx(s0 + 1)]));"),
        ("minimizers.cu", "    *(uint4*)erow = make_uint4(f[0], f[1], f[2], "
         "f[3]);", "    __stcs((uint4*)erow, make_uint4(f[0], f[1], f[2], "
         "f[3]));"),
    )),
}
# the --api mode's edited copies of KR1 (rolling.cu): its blocks held to
# 3 or 4 a SM (at most 85 or 64 registers a thread)
KR1_EDITS = {
    f"kr1-lb{b}": (True, (("rolling.cu",
                           "__launch_bounds__(kThreads)\n    cyclic_kernel(",
                           f"__launch_bounds__(kThreads, {b})\n"
                           "    cyclic_kernel("),))
    for b in (3, 4)
}
# --sketch's thread-block-cluster design of KS1 (the edit ks1-c8, measured
# and not kept: PERF.md row 21): a cluster of 8 blocks (sm_90) splits one
# u32 copy of the registers, a block's slice 2^(p - 3) in its shared
# memory; a key's raise is an atomicMax on its register's block through
# distributed shared memory (map_shared_rank); the cluster syncs after the
# zeroing and before each block flushes its own slice.  As many clusters
# as the card holds at once (cudaOccupancyMaxActiveClusters), fewer where
# n < 2^p x that; for 5 <= p <= 18 and n >= kGlobalBelow x 2^p, launched
# with cudaLaunchKernelEx and a cluster dimension, before the tree's paths.
CLUSTER_KS1 = r"""namespace cg = cooperative_groups;

template <bool kWang>
__global__ void __launch_bounds__(kSharedThreads)
    hll_fill_cluster(const uint64_t* __restrict__ keys, int64_t n, int p,
                     uint32_t* __restrict__ regs) {
  extern __shared__ uint4 s4[];
  uint32_t* s = (uint32_t*)s4;
  cg::cluster_group cluster = cg::this_cluster();
  const int slice_bits = p - 3, words = 1 << (slice_bits - 2);
  for (int i = threadIdx.x; i < words; i += kSharedThreads)
    s4[i] = make_uint4(0, 0, 0, 0);
  cluster.sync();
  for_each_key<kSharedThreads, kPairs>(keys, n, [&](uint64_t key) {
    uint32_t idx, rho;
    index_rho<kWang>(key, p, &idx, &rho);
    atomicMax(cluster.map_shared_rank(
                  s + (idx & ((1u << slice_bits) - 1)), idx >> slice_bits),
              rho);
  });
  cluster.sync();
  uint32_t* mine = regs + ((size_t)cluster.block_rank() << slice_bits);
  const uint4* g4 = (const uint4*)mine;
  for (int i = threadIdx.x; i < words; i += kSharedThreads) {
    const uint4 v = s4[i];
    if (v.x | v.y | v.z | v.w) raise4(mine + 4 * i, v, __ldcg(g4 + i));
  }
}

// -1 where the design does not take p or n, else the CUDA error
template <bool kWang>
int fill_cluster(const uint64_t* keys, int64_t n, int p, uint32_t* regs,
                 cudaStream_t s) {
  constexpr int kCluster = 8;
  if (p < 5 || p > 18 || n < ((int64_t)kGlobalBelow << p)) return -1;
  const auto kernel = hll_fill_cluster<kWang>;
  // host calls once (a p), made before any graph captures a launch
  static bool ready;
  static int active[19];
  cudaError_t e = cudaSuccess;
  if (!ready) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 4 << 15);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kSharedThreads);
  cfg.dynamicSmemBytes = (size_t)4 << (p - 3);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!active[p]) {
    e = cudaOccupancyMaxActiveClusters(&active[p], kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (active[p] < 1) return (int)cudaErrorInvalidConfiguration;
  }
  const int64_t copies = (n + (1ll << p) - 1) >> p;
  cfg.gridDim = dim3((unsigned)((copies < active[p] ? copies : active[p]) *
                                kCluster));
  return (int)cudaLaunchKernelEx(&cfg, kernel, keys, n, p, regs);
}

"""
# the --sketch mode's edited copies.  Of a parent's KS1 that raises byte
# registers by compare-and-swap, a block a ~2 x 2^p keys:
# ks1-grid, a grid from the card (4 blocks of 512 a SM).  Of the tree's
# KS1 (hll.cu): ks1-c8, the thread-block-cluster design (CLUSTER_KS1);
# the shared path's blocks of 512 threads, its registers capped for 2
# blocks a SM (ks1-lb2); the global path's 1 key pair a thread a turn,
# blocks of 512, 16 blocks a SM; the size switch (ks1-global: the global
# path at every n; ks1-shared: a copy a block wherever it fits).  Of the
# tree's KS4 nuccount (bitmix.cu): plain stores in place of streaming ones
# (ks4-st), 2 or 8 k-mers a lane pair.
SKETCH_EDITS = {
    "ks1-grid": (True, (("hll.cu",
                         "int64_t g = (n + 2 * m - 1) / (2 * m);",
                         "int64_t g = sms * 4;"),)),
    "ks1-c8": (True, (
        ("hll.cu", "#include <cstdint>\n",
         "#include <cooperative_groups.h>\n#include <cstdint>\n"),
        ("hll.cu", "}  // namespace\n", CLUSTER_KS1 + "}  // namespace\n"),
        ("hll.cu", "  return (int)(wang ? fill<true>(k, n, p, r, s) : "
         "fill<false>(k, n, p, r, s));\n",
         "  const int cl = wang ? fill_cluster<true>(k, n, p, r, s)\n"
         "                      : fill_cluster<false>(k, n, p, r, s);\n"
         "  if (cl >= 0) return cl;\n"
         "  return (int)(wang ? fill<true>(k, n, p, r, s) : "
         "fill<false>(k, n, p, r, s));\n"),
    )),
    "ks1-st512": (True, (("hll.cu", "kSharedThreads = 1024;",
                          "kSharedThreads = 512;"),)),
    "ks1-lb2": (True, (("hll.cu", "__launch_bounds__(kSharedThreads)",
                        "__launch_bounds__(kSharedThreads, 2)"),)),
    "ks1-gp1": (True, (("hll.cu", "kGlobalPairs = 2;", "kGlobalPairs = 1;"),)),
    "ks1-gt512": (True, (("hll.cu", "kThreads = 256;", "kThreads = 512;"),)),
    "ks1-gb16": (True, (("hll.cu", "kGlobalBlocksPerSm = 8;",
                         "kGlobalBlocksPerSm = 16;"),)),
    "ks1-global": (True, (("hll.cu", "kGlobalBelow = 32;",
                           "kGlobalBelow = 1 << 30;"),)),
    "ks1-shared": (True, (("hll.cu", "kGlobalBelow = 32;",
                           "kGlobalBelow = 0;"),)),
    "ks4-st": (True, (("bitmix.cu",
                       "__stcs((longlong2*)(out + 4 * i) + half, c);",
                       "*((longlong2*)(out + 4 * i) + half) = c;"),)),
    **{f"ks4-u{u}": (True, (("bitmix.cu", "constexpr int kPer = kPerThread;",
                             f"constexpr int kPer = {u};"),)) for u in (2, 8)},
}
# --classify's design of K1 radix's probe by lane pairs (the edit k1r-pair):
# a pair of lanes reads each of its 2 kR slot rows with one 16-B load a
# lane (lane 2j the row's low half, 2j + 1 its high half), so that a
# warp's load touches 16 rows, each one 32-B sector, where a lane's own
# two loads touch 32 rows twice; each lane matches its two slots and the
# pair adds the halves' sums by shuffles; every lane stays to the end (a
# lane past the positions takes the last one's read, and no position).
PAIR_K1R = r"""  // the run's probes by lane pairs
  const uint64_t bmask = (1ULL << a.lgnb) - 1;
  const uint64_t base = kMode == kRange ? (uint64_t)a.row0 : 0;
  const uint64_t vmask = (1ULL << a.vbits) - 1;
  const int half = threadIdx.x & 1;
  const uint32_t okp = __shfl_xor_sync(~0u, ok, 1);
  uint64_t h[kR], hp[kR], acc[kR];
  uint32_t found = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    h[r] = splitmix64(km[r]);
    hp[r] = __shfl_xor_sync(~0u, h[r], 1);
    acc[r] = 0;
  }
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const uint32_t foundp = __shfl_xor_sync(~0u, found, 1);
    ulonglong2 part[kR][2];
    uint64_t bks[kR][2];
    uint32_t loaded = 0;
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const bool mine = s == half;
        const uint64_t hh = mine ? h[r] : hp[r];
        const bool want = (((mine ? ok & ~found : okp & ~foundp) >> r) & 1);
        uint64_t b = hh & bmask;
        if (ch) b ^= splitmix64((hh >> a.lgnb) ^ kBSalt) & bmask;
        b -= base;
        bks[r][s] = b;
        if (want && (kMode != kRange || b < (uint64_t)a.rows)) {
          part[r][s] = a.slots[2 * b + half];
          loaded |= 1u << (2 * r + s);
        }
      }
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const bool mine = s == half;
        const uint64_t hh = mine ? h[r] : hp[r];
        const uint64_t e = (ch ? 3ULL << 62 : 1ULL << 63) |
                           ((hh >> a.lgnb) << a.vbits);
        uint64_t pa = 0;
        int pf = 0;
        if (loaded >> (2 * r + s) & 1) {
          const uint64_t w[2] = {part[r][s].x, part[r][s].y};
#pragma unroll
          for (int t = 0; t < 2; ++t)
            if ((w[t] & ~vmask) == e) {
              pf = 1;
              pa += a.is_inline ? (w[t] & vmask)
                                : bks[r][s] * 4 + 2 * half + t;
            }
        }
        pa += __shfl_xor_sync(~0u, pa, 1);
        pf |= __shfl_xor_sync(~0u, pf, 1);
        if (mine && pf) {
          found |= 1u << r;
          acc[r] += pa;
        }
      }
  }
"""


def _cut(first: str, past: str):
    """An edit's old text given by its ends: the text of the edited file
    from ``first`` up to ``past`` (or '' where ``first`` is not in it)."""
    def cut(text: str) -> str:
        i = text.find(first)
        return text[i:text.index(past, i)] if i >= 0 else ""
    return cut


# --classify's staging of K1 radix's codes (the edit k1r-staged): a block
# stages the one byte range of its positions' codes in shared memory by
# 16-B loads from the aligned byte at or below its start (-1 outside the
# tensor), while each thread finds its first position and reads its
# read's length, then a barrier; past kStageBytes the block reads its
# codes where they are.
STAGED_K1R = r"""
constexpr int kStageBytes = 4096;  // staged codes a block, at most

// The codes of a block staged in shared memory from byte ``gs``.
struct Staged {
  const int8_t* s;
  int64_t gs;
  __device__ __forceinline__ int byte(int64_t g) const { return s[g - gs]; }
  __device__ __forceinline__ uint32_t word(int64_t g) const {
    const int o = (int)(g - gs);
    const uint32_t* w = (const uint32_t*)s;
    return __funnelshift_r(w[o >> 2], w[(o >> 2) + 1], 8 * (o & 3));
  }
};

template <int kMode, bool kSpaced, int kFold>
__global__ void __launch_bounds__(kThreads)
    radix_kernel(Args a, bk::Spacing sp) {
  // the staged codes, and room for the word read past the last of them
  __shared__ __align__(16) int8_t s_code[kStageBytes + 16];
  constexpr int kR = kRun<kSpaced>, kTile = kThreads * kR;
  const int tid = threadIdx.x;
  const bk::Spacing* ss = nullptr;
  if constexpr (kSpaced) {
    __shared__ bk::Spacing s_sp;
    bk::stage_spacing(sp, &s_sp, tid);
    ss = &s_sp;
  }
  // the block's positions [i0, i1] and their codes' bytes [g0, g1)
  const int64_t i0 = (int64_t)blockIdx.x * kTile;
  const int64_t i1 = (i0 + kTile < a.n ? i0 + kTile : a.n) - 1;
  int64_t b0, p0, b1, p1;
  divmod(i0, a.P, &b0, &p0);
  divmod(i1, a.P, &b1, &p1);
  const int64_t g0 = b0 * a.ld + p0;
  const int64_t g1 = b1 * a.ld + p1 + a.c;
  const int shift = (int)(((uintptr_t)a.codes + (uintptr_t)g0) & 15);
  const int64_t gs = g0 - shift;  // byte of s_code[0]
  const bool staged = shift + (g1 - g0) <= kStageBytes;
  // this thread's first position and its read's end, while the block's
  // codes arrive
  const int64_t i = i0 + (int64_t)kR * tid;
  int64_t b = 0, p = 0, end = 0;
  if (i < a.n) {
    divmod(p0 + (int64_t)kR * tid, a.P, &b, &p);
    b += b0;
    end = read_length(a, b) - (a.c - 1);
  }
  if (staged) {
    const int nchunk = (int)((shift + (g1 - g0) + 15) >> 4);
    for (int q = tid; q < nchunk; q += kThreads) {
      const int64_t lo = gs + 16 * q;
      union {
        int4 v;
        int8_t b[16];
      } u;
      if (lo >= 0 && lo + 16 <= a.total) {
        u.v = __ldg((const int4*)(a.codes + lo));
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          u.b[e] = lo + e >= 0 && lo + e < a.total ? a.codes[lo + e]
                                                   : (int8_t)-1;
      }
      *(int4*)(s_code + 16 * q) = u.v;
    }
  }
  __syncthreads();
  if (i >= a.n) return;
  if (staged)
    run<kMode, kSpaced, kFold>(a, ss, i, b, p, end, Staged{s_code, gs});
  else
    run<kMode, kSpaced, kFold>(a, ss, i, b, p, end,
                               Codes{a.codes, a.total});
}

"""


# --classify's design steps of K1's radix kernel (csrc/encode_probe_radix.cu),
# edits of a copy of the tree's csrc: another run length of a contiguous
# seed (k1r-r1, -r2, -r4, -r8) or of a spaced one (k1r-s1, -s2, -s4), another
# block size (k1r-t64, -t128, -t256), both rows at once (k1r-both), the
# rows read by lane pairs (k1r-pair, PAIR_K1R), the slot rows read past L1
# (k1r-cg), the codes staged a block in shared memory (k1r-staged,
# STAGED_K1R), and knock-outs
K1R_EDITS = {
    **{f"k1r-r{r}": (True, (("encode_probe_radix.cu",
                             "constexpr int kRunContiguous = ",
                             f"constexpr int kRunContiguous = {r}; // "),))
       for r in (1, 2, 4, 8)},
    **{f"k1r-s{r}": (True, (("encode_probe_radix.cu",
                             "constexpr int kRunSpaced = ",
                             f"constexpr int kRunSpaced = {r}; // "),))
       for r in (1, 2, 4)},
    **{f"k1r-t{t}": (True, (("encode_probe_radix.cu",
                             "constexpr int kThreads = ",
                             f"constexpr int kThreads = {t}; // "),))
       for t in (64, 128, 256)},
    # both candidate rows of every valid lane loaded before any compare
    "k1r-both": (True, (
        ("encode_probe_radix.cu",
         "  ulonglong2 lo[kR], hi[kR];\n  uint32_t loaded = 0, found = 0;",
         "  ulonglong2 lo[kR], hi[kR], lo2[kR], hi2[kR];\n"
         "  uint64_t bk2[kR];\n"
         "  uint32_t loaded = 0, found = 0, loaded2 = 0;"),
        ("encode_probe_radix.cu",
         "      loaded |= 1u << r;\n    }\n  }\n#pragma unroll\n"
         "  for (int r = 0; r < kR; ++r)\n    if ((loaded >> r & 1) &&\n"
         "        match_row(a, lo[r], hi[r],\n"
         "                  (1ULL << 63)",
         "      loaded |= 1u << r;\n    }\n"
         "    bk2[r] = ((h[r] & bmask) ^ (splitmix64((h[r] >> a.lgnb) ^ "
         "kBSalt) & bmask)) - base;\n"
         "    if ((ok >> r & 1) && (kMode != kRange || bk2[r] < "
         "(uint64_t)a.rows)) {\n"
         "      lo2[r] = a.slots[2 * bk2[r]];\n"
         "      hi2[r] = a.slots[2 * bk2[r] + 1];\n"
         "      loaded2 |= 1u << r;\n    }\n  }\n#pragma unroll\n"
         "  for (int r = 0; r < kR; ++r)\n    if ((loaded >> r & 1) &&\n"
         "        match_row(a, lo[r], hi[r],\n"
         "                  (1ULL << 63)"),
        ("encode_probe_radix.cu",
         "  loaded = 0;\n#pragma unroll\n  for (int r = 0; r < kR; ++r) {\n"
         "    if ((ok & ~found) >> r & 1) {",
         "  loaded = loaded2 & ~found;\n#pragma unroll\n"
         "  for (int r = 0; r < kR; ++r) {\n"
         "    bk[r] = bk2[r];\n    lo[r] = lo2[r];\n    hi[r] = hi2[r];\n"
         "  }\n#pragma unroll\n  for (int r = 0; r < 0; ++r) {\n"
         "    if ((ok & ~found) >> r & 1) {"))),
    # knock-outs, timed and not checked: a contiguous seed's fresh fold of
    # one word (k1r-x-fold), no length read (k1r-x-len), one 16-B half of
    # each slot row read (k1r-x-hi), no second rows (k1r-x-row2), no value
    # read (k1r-x-val)
    "k1r-x-fold": (False, (("encode_probe_radix.cu",
                            "  for (int j = 0; j < a.k; j += 4) {",
                            "  for (int j = 0; j < 1; j += 4) {"),)),
    "k1r-x-len": (False, (("encode_probe_radix.cu",
                           "p, read_length(a, b) - (a.c - 1),",
                           "p, a.P,"),
                          ("encode_probe_radix.cu",
                           "if (r > 0 && fresh) end = read_length(a, b) - "
                           "(a.c - 1);",
                           "if (r > 0 && fresh) end = a.P;"))),
    "k1r-x-hi": (False, (("encode_probe_radix.cu",
                          "      hi[r] = a.slots[2 * bk[r] + 1];",
                          "      hi[r] = lo[r];"),
                         ("encode_probe_radix.cu",
                          "        hi[r] = a.slots[2 * bk[r] + 1];",
                          "        hi[r] = lo[r];"))),
    "k1r-x-row2": (False, (("encode_probe_radix.cu",
                            "    if ((ok & ~found) >> r & 1) {",
                            "    if (false) {"),)),
    "k1r-x-val": (False, (("encode_probe_radix.cu",
                           "      val[r] = a.vals[idx];",
                           "      val[r] = (uint64_t)idx;"),)),
    "k1r-pair": (True, (
        ("encode_probe_radix.cu",
         "  if (i >= a.n) return;\n  int64_t b, p;\n"
         "  divmod(i, a.P, &b, &p);",
         "  int64_t b, p;\n  divmod(i < a.n ? i : a.n - 1, a.P, &b, &p);"),
        ("encode_probe_radix.cu", _cut(
            "  // the run's probes together", "  uint64_t val[kR];"),
         PAIR_K1R))),
    "k1r-cg": (True, (("encode_probe_radix.cu",
                       "      lo[r] = a.slots[2 * bk[r]];\n"
                       "      hi[r] = a.slots[2 * bk[r] + 1];",
                       "      lo[r] = __ldcg(a.slots + 2 * bk[r]);\n"
                       "      hi[r] = __ldcg(a.slots + 2 * bk[r] + 1);"),
                      ("encode_probe_radix.cu",
                       "        lo[r] = a.slots[2 * bk[r]];\n"
                       "        hi[r] = a.slots[2 * bk[r] + 1];",
                       "        lo[r] = __ldcg(a.slots + 2 * bk[r]);\n"
                       "        hi[r] = __ldcg(a.slots + 2 * bk[r] + 1);"))),
    "k1r-staged": (True, (
        ("encode_probe_radix.cu",
         "template <int kFold>\n__device__ __forceinline__ uint64_t "
         "fold_fresh(",
         "template <int kFold, class Codes>\n__device__ __forceinline__ "
         "uint64_t fold_fresh("),
        ("encode_probe_radix.cu",
         "template <int kMode, bool kSpaced, int kFold>\n__device__ "
         "__forceinline__ void run(",
         "template <int kMode, bool kSpaced, int kFold, class Codes>\n"
         "__device__ __forceinline__ void run("),
        ("encode_probe_radix.cu", _cut(
            "template <int kMode, bool kSpaced, int kFold>\n__global__",
            "template <int kMode, bool kSpaced, int kFold>\nint launch("),
         STAGED_K1R))),
}
EDITS = {**HASH_EDITS, **ROUTE_EDITS, **KB4_EDITS, **KR1_EDITS,
         **K128_EDITS, **KB1_EDITS, **SKETCH_EDITS, **K1R_EDITS}

# the hash instantiations' blocks a SM: (label, entry point, arguments)
OCCUPANCY = (("KB1 hash W=13", "bk_minimizers_hash_blocks_per_sm",
              (0, 25, 13, 0)),
             ("KB1 spaced hash W=16", "bk_minimizers_hash_blocks_per_sm",
              (1, 25, 16, 0)),
             ("KB1 radix spaced hash W=8", "bk_minimizers_hash_blocks_per_sm",
              (1, 23, 8, 1)),
             ("KB4 hash window W=13",
              "bk_compacted_minimizers_hash_blocks_per_sm", (13, 0)),
             ("KB4 radix hash window W=14",
              "bk_compacted_minimizers_hash_blocks_per_sm", (14, 1)))
# the kernels whose registers and spills --hash prints (ptxas -v), by a
# part of their mangled names (KB4's hash window: the count-and-window
# design's, or the earlier compaction design's)
PTXAS = (("KB1 hash", ("minimizers_kernelILb0ELi2ELb0E",)),
         ("KB1 spaced hash", ("minimizers_kernelILb1ELi2ELb0E",)),
         ("KB1 radix spaced hash", ("minimizers_kernelILb1ELi2ELb1E",)),
         ("KB4 hash window", ("window_kernelILi0ELi1ELi0E",
                              "window_kernelILi1E")),
         ("KB4 radix hash window", ("window_kernelILi1ELi1ELi0E",)),
         ("KB5", ("lookup_scores_kernel",)))


class ParentLib:
    """A parent's library as ``kernels`` calls it, but KB4's scratch is
    asked with room for a score stream: a parent older than the DNA
    Shannon score in KB4's window launch keeps a stream for it, which the
    tree's wrapper no longer asks for (a larger scratch is harmless)."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def bk_compacted_minimizers_gen_scratch(self, B, L, scored):
        return self._lib.bk_compacted_minimizers_gen_scratch(B, L, 1)


def _edit_parts(edit: str):
    """The EDITS names of ``edit`` (several joined by '+')."""
    parts = edit.split("+")
    if not all(p in EDITS for p in parts):
        raise ValueError(f"edit {edit}: one of {', '.join(EDITS)}, or "
                         "several joined by '+'")
    return parts


def keeps_output(edit: str) -> bool:
    return all(EDITS[p][0] for p in _edit_parts(edit))


def edited_copy(csrc: str, tag: str, edit=None) -> str:
    """A copy of ``csrc`` under OUT_DIR/``tag`` with the substitutions of
    each EDITS part of ``edit`` made, and the tree's hash occupancy
    queries (``OCCUPANCY``) appended to a source that lacks them, or put
    in place of a parent's whose arguments differ."""
    out = os.path.join(OUT_DIR, f"src_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for part in _edit_parts(edit) if edit else ():
        taken = 0
        for f, old, new in EDITS[part][1]:
            path = os.path.join(out, f)
            text = open(path).read() if os.path.exists(path) else ""
            if callable(old):
                old = old(text)
            if old and old in text:
                open(path, "w").write(text.replace(old, new))
                taken += 1
        if not taken:
            raise ValueError(f"edit {part}: none of its texts is in {csrc}")
    for f in ("minimizers.cu", "compacted_minimizers.cu"):
        path = os.path.join(out, f)
        text = open(path).read()
        pattern = r'extern "C" int bk_\w+_hash_blocks_per_sm\(.*?\n}\n'
        own = re.search(pattern, open(os.path.join(kernels.CSRC, f)).read(),
                        re.S).group(0)
        theirs = re.search(pattern, text, re.S)
        if theirs is None:
            open(path, "w").write(text + "\n" + own)
        elif theirs.group(0) != own:
            open(path, "w").write(text.replace(theirs.group(0), own))
    return out


def _ptxas(err: str) -> dict:
    """ptxas -v's registers and spill stores of each kernel in ``err``."""
    out, name = {}, None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and name:
            out.setdefault(name, {}).update(stack=int(m.group(1)),
                                            spill_stores=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def build_parent(csrc: str, names, tag: str = "parent", edit=None,
                 info: bool = False) -> ParentLib:
    """The ``names``.cu of ``csrc`` in one library (its files named by
    ``tag``), bound like ``kernels``.  With ``edit`` or ``info``, of an
    ``edited_copy``, with ptxas's registers and spills of the kernels of
    ``PTXAS`` kept in the library's ``ptxas``."""
    os.makedirs(OUT_DIR, exist_ok=True)
    if edit or info:
        csrc = edited_copy(csrc, tag, edit)
    nvcc = kernels._nvcc()
    objs, procs = [], []
    for name in names:
        if not os.path.exists(os.path.join(csrc, f"{name}.cu")):
            continue  # a kernel the parent does not have
        obj = os.path.join(OUT_DIR, f"{tag}_{name}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *kernels.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             *(["-Xptxas", "-v"] if info else []),
             "-c", "-o", obj, os.path.join(csrc, f"{name}.cu")],
            stderr=subprocess.PIPE, text=True))
    regs = {}
    for p in procs:
        _, err = p.communicate(timeout=600)
        if p.returncode:
            raise RuntimeError(f"{tag} kernel build failed:\n{err}")
        regs.update(_ptxas(err))
    lib_path = os.path.join(OUT_DIR, f"lib{tag}.so")
    subprocess.run([nvcc, *kernels.ARCH, "-shared", "-o", lib_path, *objs],
                   check=True, timeout=300)
    lib = ctypes.CDLL(lib_path)
    for name, args in kernels._SIGS.items():
        if hasattr(lib, name):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = args
    for name, nargs in kernels._SCRATCH.items():
        if hasattr(lib, name):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_int64] * nargs
    out = ParentLib(lib)
    out.ptxas_all = regs
    out.ptxas = {label: next((v for k, v in regs.items()
                              if any(p in k for p in parts)), None)
                 for label, parts in PTXAS}
    return out


@contextlib.contextmanager
def using(lib):
    """Route the wrappers' ``kernels.launch`` to ``lib`` for the body."""
    own = kernels.get_lib()
    kernels._lib = lib
    try:
        yield
    finally:
        kernels._lib = own


def on(lib, fn):
    """fn, called with the wrappers routed to ``lib``."""
    def call():
        with using(lib):
            return fn()
    return call


def _state(rng, pool, n, cap, taxa_pool, tree, dev):
    keys = np.sort(rng.choice(pool, n, replace=False))
    taxa = rng.choice(taxa_pool, n).astype(np.uint32)
    st = [np.full(cap, 2**64 - 1, np.uint64), np.ones(cap, np.uint8),
          np.zeros(cap, np.int32), np.zeros(cap, np.uint32),
          np.zeros(cap, np.uint32)]
    for arr, v in zip(st, (keys, 0, tree.compact(taxa, missing_ok=True), taxa,
                           1)):
        arr[:n] = v
    return bd.State.from_numpy(*st, n, dev)


def _phase1_like(seeds, rng):
    """A phase-1 map of the distinct ``seeds`` (one chunk's) and random keys,
    9.8M in all (the ec -k 25 -t map's size: 2^22 buckets), 6 values."""
    return _inline_map(unique_u64(np.concatenate([
        seeds, rng.integers(0, 2**64, 9_815_329 - seeds.size,
                            dtype=np.uint64)])), rng)


def _chunk(seq: bytes, span: int, W: int, dev):
    """The build's chunk of ``seq`` for a seed of span ``span`` and a
    window of W: its first 4M windows' codes and length, on ``dev``."""
    codes = fastx.encode_contig(seq[: (1 << 22) + span - 1 + W - 1], DNA4.lut)
    return (torch.from_numpy(codes[None, :]).to(dev),
            torch.tensor([codes.size], dtype=torch.int32, device=dev))


def hash_cases(seq: bytes, dev, rng):
    """(name, call, timer, entry point, slot rows) of the hash-scored phase
    2's kernels on ``seq``'s build chunk: KB1 -k 21 -S 0x16,1x4 -w 40 -t
    (W = 16) and -k 25 -w 37 -t (W = 13), KB5 on 2^22 k-mers (half stored
    in the latter's map) and KB4 -C -k 25 -w 37 -t (W = 13), then on its
    frame 0 translated the other alphabets' instantiations: KB1 PROTEIN_6
    -k 12 -S 1x11 -w 30 (W = 8) and KB4 PROTEIN20 -k 7 -w 20 (W = 14);
    each map a ``_phase1_like`` map of the chunk's own seeds;
    ``bounds.probe_rows``' slot rows of each."""
    from ..core.alphabet import InputType
    from ..core.spacer import Spacer
    from ..db.table import lookup_scores
    from .bounds import hash_queries, probe_rows

    def own(c, ln, k, canon, pos=None):  # canon None: KB4's -C seeds
        em = enc.minimizers(c, ln, k, 1, bool(canon), "lex", pos)
        smap = _phase1_like(em.values[em.mask].cpu().numpy().view(np.uint64),
                            rng)
        return smap, probe_rows(hash_queries(c, ln, k, canon, pos),
                                smap.arrays(dev))[1]

    pos = tuple(int(p) for p in Spacer(21, 21, "0x16,1x4").positions)
    cases = []
    c, ln = _chunk(seq, 25, 16, dev)
    smap, rows = own(c, ln, 21, False, pos)
    cases.append(("minimizers -k 21 -S 0x16,1x4 -w 40 -t W=16",
                  lambda c=c, ln=ln, smap=smap: enc.minimizers(
                      c, ln, 21, 16, False, "hash", pos, smap),
                  graph_ms, KB1, rows))
    c, ln = _chunk(seq, 25, 13, dev)
    smap, rows = own(c, ln, 25, True)
    cases.append(("minimizers -k 25 -w 37 -t W=13",
                  lambda c=c, ln=ln, smap=smap: enc.minimizers(
                      c, ln, 25, 13, True, "hash", score_map=smap),
                  graph_ms, KB1, rows))
    arr = smap.arrays(dev)
    keys = smap.table.keys_sorted
    q = torch.from_numpy(np.concatenate([
        rng.choice(keys, 1 << 21),
        rng.integers(0, 2**64, 1 << 21, dtype=np.uint64)]).view(np.int64)
    ).to(dev)
    cases.append(("lookup_scores 2^22 k-mers, half stored",
                  lambda: [lookup_scores(q, arr)], graph_ms,
                  "bk_lookup_scores", probe_rows(q, arr)[1]))
    smap, rows = own(c, ln, 25, None)
    cases.append(("compacted_minimizers -C -k 25 -w 37 -t W=13",
                  lambda c=c, ln=ln, smap=smap: enc.compacted_minimizers(
                      c, ln, 25, 13, "hash", smap),
                  graph_ms, KB4, rows))
    # another alphabet: frame 0 of the sequence translated, as chip_smoke.py
    # phase 9j's builds (PROTEIN_6 -k 12 -S 1x11 -w 30, PROTEIN20 -k 7 -w 20)
    for it, k, spacing, w in ((InputType.PROTEIN_6, 12, "1x11", 30),
                              (InputType.PROTEIN20, 7, "", 20)):
        sp = Spacer(k, w, spacing)
        spos = tuple(int(p) for p in sp.positions) if spacing else None
        c, ln = _frame_chunk(seq, it, sp.c, sp.window_kmers, dev)
        em = enc.minimizers(c, ln, k, 1, False, "lex", spos, it=it)
        smap = _phase1_like(em.values[em.mask].cpu().numpy().view(np.uint64),
                            rng)
        rows = probe_rows(hash_queries(c, ln, k, False if spos else None,
                                       spos, it), smap.arrays(dev))[1]
        W = sp.window_kmers
        if spos:
            cases.append((f"minimizers {it.name} -k {k} -S {spacing} -w {w} "
                          f"-t W={W}",
                          lambda c=c, ln=ln, smap=smap, it=it, k=k, W=W,
                          spos=spos: enc.minimizers(c, ln, k, W, False,
                                                    "hash", spos, smap, it),
                          graph_ms, KB1, rows))
        else:
            cases.append((f"compacted_minimizers {it.name} -k {k} -w {w} -t "
                          f"W={W}",
                          lambda c=c, ln=ln, smap=smap, it=it, k=k, W=W:
                          enc.compacted_minimizers(c, ln, k, W, "hash", smap,
                                                   it),
                          graph_ms, KB4, rows))
    return cases


def _frame_chunk(seq: bytes, it, span: int, W: int, dev):
    """The build's chunk of frame 0 of ``seq`` translated, in the codes of
    the input type ``it``, for a seed of span ``span`` and a window of W:
    its first 4M windows' codes (all of them where the frame is shorter)
    and length, on ``dev``."""
    from ..core.alphabet import alphabet_of

    aa = translate(seq, 0)[: (1 << 22) + span - 1 + W - 1]
    codes = np.ascontiguousarray(alphabet_of(it).lut, np.int8)[
        np.frombuffer(aa, np.uint8)]
    return (torch.from_numpy(codes[None, :]).to(dev),
            torch.tensor([codes.size], dtype=torch.int32, device=dev))


def fold_cases(nodes: str, nameid: str, genomes, dev, rng):
    """(name, call, timer, entry point, slot rows) of KB5 on the -k 25 -t
    phase-1 map of ``genomes`` built on the card (``prebuild
    --device-build``'s; NAMEID maps their sequence names to taxids of
    NODES): the folded keys of its -k 25 -w 37 -t phase-2 device build
    (``chip_smoke.py`` phase 9c's), then 2^16 to 2^22 k-mers, half
    stored."""
    from ..core.spacer import Spacer
    from ..db.table import ScoreMap, lookup_scores
    from .bounds import probe_rows

    tree = TaxTree.from_nodes_dmp(nodes)
    p1 = bd.device_taxdepth_map(genomes, tree, nameid, Spacer(25, 25), True,
                                device=dev)
    smap = ScoreMap(p1)
    arr = smap.arrays(dev)
    states, tax, root1 = bd._device_gather(genomes, tree, nameid,
                                           Spacer(25, 37), True, 1 << 22,
                                           dev, "hash", smap)
    st = bd._tree_fold(states, tax, root1)
    folded = st.keys[: int(st.n)].clone()
    del states, st
    cases = [(f"lookup_scores the -k 25 -w 37 -t build's {folded.numel()} "
              f"folded keys, the ec -k 25 -t map (2^{p1.lgnb} rows)",
              lambda: [lookup_scores(folded, arr)], graph_ms,
              "bk_lookup_scores", probe_rows(folded, arr)[1])]
    for lg in (16, 18, 20, 21, 22):
        q = torch.from_numpy(np.concatenate([
            rng.choice(p1.keys_sorted, 1 << (lg - 1)),
            rng.integers(0, 2**64, 1 << (lg - 1), dtype=np.uint64)]).view(
                np.int64)).to(dev)
        cases.append((f"lookup_scores 2^{lg} k-mers, half stored, the ec "
                      "-k 25 -t map", lambda q=q: [lookup_scores(q, arr)],
                      graph_ms, "bk_lookup_scores", probe_rows(q, arr)[1]))
    return cases


def build_cases(genome: str, nodes: str, dev):
    """(name, call, timer[, entry point[, slot rows]]) of KB1 at W = 1 and
    10 and at the seed disciplines' shapes, of KB4, the hash cases
    (``hash_cases``) and KB3."""
    from ..core.spacer import Spacer

    seq = next(iter(fastx.read_fastx(genome)))[1]
    cases = []
    rng = np.random.default_rng(SEED)
    for W in (1, 10):
        c, ln = _chunk(seq, 31, W, dev)
        cases.append((f"minimizers k=31 W={W}",
                      lambda c=c, ln=ln, W=W: enc.minimizers(c, ln, 31, W, True),
                      graph_ms, KB1))
    pos = tuple(int(p) for p in Spacer(21, 21, "0x16,1x4").positions)
    c, ln = _chunk(seq, 25, 1, dev)
    cases.append(("minimizers -k 21 -S 0x16,1x4 W=1",
                  lambda c=c, ln=ln: enc.minimizers(c, ln, 21, 1, False, "lex",
                                                    pos),
                  graph_ms, KB1))
    c, ln = _chunk(seq, 25, 13, dev)
    cases.append(("minimizers -k 25 -w 37 -e W=13",
                  lambda c=c, ln=ln: enc.minimizers(c, ln, 25, 13, True,
                                                    "entropy-file"),
                  graph_ms, KB1))
    cases.append(("compacted_minimizers -C -k 25 -w 37 -e W=13",
                  lambda c=c, ln=ln: enc.compacted_minimizers(
                      c, ln, 25, 13, "entropy-file"),
                  graph_ms, KB4))
    cases += hash_cases(seq, dev, rng)
    c, ln = _chunk(seq, 31, 10, dev)
    cases.append(("compacted_minimizers -C -k 31 -w 40 W=10",
                  lambda c=c, ln=ln: enc.compacted_minimizers(c, ln, 31, 10),
                  graph_ms, KB4))
    tree = TaxTree.from_nodes_dmp(nodes)
    taxa_pool = np.concatenate([tree.tax_ids, [0]]).astype(np.uint32)
    n = 3 << 20
    pool = unique_u64(rng.integers(0, 2**64, (5 << 20) + (5 << 16),
                                   dtype=np.uint64))[: 5 << 20]
    a = _state(rng, pool, n, 1 << 22, taxa_pool, tree, dev)
    b = _state(rng, pool, n, 1 << 22, taxa_pool, tree, dev)
    tax = tree.device_arrays(dev)
    root1 = int(tree.compact(np.array([1], dtype=np.uint32))[0])

    def fold():
        s = bd.merge_fold(a, b, tax, root1, True)
        return [s.keys, s.pad, s.node, s.orig, s.cnt, s.n]

    cases.append(("merge_fold 2^22 + 2^22, 3M valid each, sum_counts", fold,
                  time_ms))
    return cases + api_cases(seq, dev) + sketch_cases(seq, dev)


def _errexp_keys(n: int, dev):
    """errexp's first set of ``n`` keys (cli.py errexp: numpy's integers
    below 2^62 from seed 0), as ``addh`` uploads them."""
    from ..core.bitops import as_keys

    rng = np.random.default_rng(0)
    return as_keys(rng.integers(0, 1 << 62, 2 * n, dtype=np.uint64)[:n], dev)


def sketch_cases(seq: bytes, dev):
    """(name, call, timer, entry point) of KS1-KS4 at chip_smoke.py's phase
    9e shapes on ``seq`` (one genome's first record): its canonical
    31-mers (KB1's emissions) for KS1 (hashed, a new sketch a call: the
    registers' memset and the fill; p = 14 as distmat --hll 14, 16, 17,
    20, 12 and 15, and the first 4, 16 and 64 x 2^p at p = 8, 12 and 14),
    KS2 (m = 4096, -S -s and default, a new sketch a call and a full
    one: the sketch of the same stream, restored before each call) and
    KS4 (nuccount also on the slice at an 8-B offset), KS5 at ndb = 4 and
    the key-range mode on them (KS4's controls); KS1 at errexp's sets
    (2^16 keys at p = 12, 2^12 at p = 8) and at a GenomeChunker chunk
    (the first 2^20 31-mers, p = 16); its k = 31 rolling-hash stream for
    KS3; then KB2 on the k = 31 W = 1 minimizers of its first 4M windows
    (the build's chunk)."""
    from ..core import bitops, hashes
    from ..core.rolling import RollingEncoder
    from ..db.table import shard_owner
    from ..sketch import hll
    from ..sketch.setsketch import CSetSketch
    from ..sketch.shs import sort_count

    codes = torch.from_numpy(fastx.encode_contig(seq, DNA4.lut)[None, :]).to(
        dev)
    ln = torch.tensor([codes.shape[1]], dtype=torch.int32, device=dev)
    em = enc.minimizers(codes, ln, 31, 1, True)
    kmers = em.values[0][em.mask[0]]
    vals, invalid = RollingEncoder(31).hashes(codes)
    hv, hok = vals[0], ~invalid[0]
    span = (1 << 22) + 30
    em4 = enc.minimizers(codes[:, :span],
                         torch.tensor([min(span, codes.shape[1])],
                                      dtype=torch.int32, device=dev), 31, 1,
                         True)
    k4, m4 = em4.values[0], em4.mask[0]
    pad = (kmers & 7 == 0).to(torch.uint8)
    lo, hi = 1 << 61, 3 << 61

    def fill(keys, p):
        regs = torch.zeros(1 << p, dtype=torch.int32, device=dev)

        def call():
            regs.zero_()
            hll.hll_fill(keys, regs, p, True)
            return [regs]
        return call

    def sketch(save):
        s = CSetSketch(4096, save, save, device=dev)
        s.update(kmers)
        return [s.regs] + ([s._ids, s._idcounts] if save else [])

    def full(save):
        s = CSetSketch(4096, save, save, device=dev)
        s.update(kmers)
        parts = [s.regs] + ([s._ids, s._idcounts] if save else [])
        state = [p.clone() for p in parts]

        def call():
            for p, q in zip(parts, state):
                p.copy_(q)
            s.update(kmers)
            return [p.clone() for p in parts]
        return call

    ks1 = [(f"hll_fill p={p} wang_hash", fill(kmers, p), graph_ms,
            "bk_hll_fill") for p in (14, 16, 17, 20, 12, 15)]
    # n = 4, 16 and 64 x 2^p: the two paths' crossover (kGlobalBelow)
    ks1 += [(f"hll_fill 2^{b} keys p={p} wang_hash",
             fill(kmers[: 1 << b].clone(), p), graph_ms, "bk_hll_fill")
            for p, b in ((8, 10), (8, 14), (12, 14), (12, 18), (14, 16),
                         (14, 18), (14, 20))]
    ks1 += [
        ("hll_fill errexp 2^16 keys p=12 wang_hash",
         fill(_errexp_keys(1 << 16, dev), 12), graph_ms, "bk_hll_fill"),
        ("hll_fill errexp 2^12 keys p=8 wang_hash",
         fill(_errexp_keys(1 << 12, dev), 8), graph_ms, "bk_hll_fill"),
        ("hll_fill GenomeChunker 2^20 keys p=16 wang_hash",
         fill(kmers[: 1 << 20].clone(), 16), graph_ms, "bk_hll_fill"),
    ]
    return ks1 + [
        ("csetsketch_update m=4096 -S -s", lambda: sketch(True), time_ms,
         "bk_csetsketch_update"),
        ("csetsketch_update m=4096 -S -s, full sketch", full(True), time_ms,
         "bk_csetsketch_update"),
        ("csetsketch_update m=4096", lambda: sketch(False), time_ms,
         "bk_csetsketch_update"),
        ("csetsketch_update m=4096, full sketch", full(False), time_ms,
         "bk_csetsketch_update"),
        ("sort_count k=31 hash stream", lambda: sort_count(hv, hok),
         time_ms, "bk_sort_count"),
        ("sort_unique k=31 W=1 4M windows", lambda: bd.sort_unique(k4, m4),
         time_ms, "bk_sort_unique"),
        ("bitmix wang_hash", lambda: [hashes.wang_hash(kmers)], graph_ms,
         "bk_bitmix"),
        ("shard_owner ndb=4", lambda: [shard_owner(kmers, 4)], graph_ms,
         "bk_shard_owner"),
        ("key_range", lambda: [bd.key_range(kmers, pad, lo, hi, False)],
         graph_ms, "bk_key_range"),
        ("nuccount k=31", lambda: [bitops.nuccount(kmers, 31)], graph_ms,
         "bk_nuccount"),
        ("nuccount k=31, 8-B offset", lambda: [bitops.nuccount(kmers[1:], 31)],
         graph_ms, "bk_nuccount"),
    ]


def hll_yardstick(seq: bytes, dev, say=print) -> dict:
    """The register raise alone through torch, as a yardstick of KS1 (not
    its library call: it leaves out the hash, the index and rho): the
    registers' memset and ``scatter_reduce_(amax)`` of K-12's canonical
    31-mers' precomputed index and rho, at p = 14 and 16, graph replay."""
    from ..core.bitops import shr
    from ..core.hashes import wang_hash
    from ..sketch.hll import _bitlen

    codes = torch.from_numpy(fastx.encode_contig(seq, DNA4.lut)[None, :]).to(
        dev)
    ln = torch.tensor([codes.shape[1]], dtype=torch.int32, device=dev)
    em = enc.minimizers(codes, ln, 31, 1, True)
    h = wang_hash(em.values[0][em.mask[0]])
    out = {}
    for p in (14, 16):
        q = 64 - p
        idx, w = shr(h, q), h << p
        rho = torch.where(w == 0, q + 1, 65 - _bitlen(w)).to(torch.int32)
        regs = torch.zeros(1 << p, dtype=torch.int32, device=dev)

        def call(regs=regs, idx=idx, rho=rho):
            regs.zero_()
            regs.scatter_reduce_(0, idx, rho, reduce="amax")

        out[f"p={p}"] = [graph_ms(call, ITERS) for _ in range(2)]
    say(f"# yardstick (not a library call of KS1): memset + scatter_reduce_ "
        f"amax of {h.numel()} precomputed (index, rho), graph replay, ms: "
        f"{out}")
    return out


def api_cases(seq: bytes, dev):
    """(name, call, timer, entry point) of the Python API's instantiations
    of KB1 and KB4 and of KR1 on ``seq``'s first 4M bases (a row) or its
    forward frame 0 as protein."""
    from ..core.alphabet import InputType, alphabet_of
    from ..core.encode import position_validity
    from ..core.encode128 import pack_kmers128
    from ..core.rolling import KR1_TILE, RollingEncoder
    from ..core.spacer import Spacer
    from .synthetic import translate

    def row(s, it=InputType.DNA):
        codes = fastx.encode_contig(s, alphabet_of(it).lut)
        return (torch.from_numpy(codes[None, :]).to(dev),
                torch.tensor([codes.size], dtype=torch.int32, device=dev))

    dna = row(seq[: 1 << 22])
    prot = {it: row(translate(seq, 0), it) for it in (
        InputType.PROTEIN20, InputType.PROTEIN_14, InputType.PROTEIN_6,
        InputType.PROTEIN, InputType.PROTEIN_3BIT)}
    pos21 = tuple(int(p) for p in Spacer(21, 21, "0x16,1x4").positions)
    pos12 = tuple(int(p) for p in Spacer(12, 12, "1x11").positions)
    p20, p14, p6 = (prot[t] for t in (InputType.PROTEIN20,
                                      InputType.PROTEIN_14,
                                      InputType.PROTEIN_6))
    cases = [
        ("minimizers -k 21 -S 0x16,1x4 -w 40 entropy W=16",
         lambda: enc.minimizers(*dna, 21, 16, False, "entropy", pos21),
         graph_ms, KB1),
        ("compacted_minimizers -k 31 -w 40 entropy (canonical) W=10",
         lambda: enc.compacted_minimizers(*dna, 31, 10, "entropy",
                                          canon=True), graph_ms, KB4),
        ("compacted_minimizers -k 13 -w 29 -C entropy W=17",
         lambda: enc.compacted_minimizers(*dna, 13, 17, "entropy"),
         graph_ms, KB4),
        ("minimizers PROTEIN20 k=7 W=1",
         lambda: enc.minimizers(*p20, 7, 1, False, it=InputType.PROTEIN20),
         graph_ms, KB1),
        *((f"minimizers {it.name} k={k} W=1",
           lambda it=it, k=k: enc.minimizers(*prot[it], k, 1, False, it=it),
           graph_ms, KB1)
          for it, k in ((InputType.PROTEIN20, 14), (InputType.PROTEIN, 8),
                        (InputType.PROTEIN_3BIT, 22))),
        ("minimizers PROTEIN_6 -k 12 -S 1x11 -w 30 entropy W=8",
         lambda: enc.minimizers(*p6, 12, 8, False, "entropy", pos12,
                                it=InputType.PROTEIN_6), graph_ms, KB1),
        ("compacted_minimizers PROTEIN_14 -k 10 -w 24 W=15",
         lambda: enc.compacted_minimizers(*p14, 10, 15,
                                          it=InputType.PROTEIN_14),
         graph_ms, KB4),
        ("compacted_minimizers PROTEIN20 -k 7 -w 20 entropy W=14",
         lambda: enc.compacted_minimizers(*p20, 7, 14, "entropy",
                                          it=InputType.PROTEIN20),
         graph_ms, KB4),
    ]
    for k, canon in ((31, True), (64, True), (200, False),
                     (KR1_TILE + 1, False)):
        renc = RollingEncoder(k, canon)
        cases.append((f"cyclic_hashes k={k}{' canonical' if canon else ''}",
                      lambda renc=renc: renc.hashes(dna[0]), graph_ms,
                      "bk_cyclic_hashes"))
    # kmercnt's chunk (sketch/shs.py MultiKCounter): one row of 2^20 bases
    chunk = dna[0][:, : 1 << 20].contiguous()
    for k in (17, 31):
        renc = RollingEncoder(k, True)
        cases.append((f"cyclic_hashes kmercnt chunk 2^20 bases k={k} "
                      "canonical", lambda renc=renc: renc.hashes(chunk),
                      graph_ms, "bk_cyclic_hashes"))
    # KB4's stream source at chip_smoke.py phase 9f's shape: the record's
    # k = 64 hash stream, w = 100 (W = 37)
    rec = row(seq)
    v, invalid = RollingEncoder(64, False, 100).hashes(rec[0])
    ok = position_validity(rec[1], v.shape[1], 64) & ~invalid
    cases.append((f"compacted_stream k=64 hash stream {v.shape[1]} values "
                  "W=37", lambda: enc.compacted_stream(v, ok, 37), graph_ms,
                  "bk_compacted_stream"))
    # K128's pack and canonical pack at chip_smoke.py phase 9f's shapes:
    # the whole record at k = 33, 40, 55 and 64
    for k in (33, 40, 55, 64):
        for canon in (False, True):
            cases.append((f"pack_kmers128{' canonical' if canon else ''} "
                          f"k={k} {rec[0].shape[1]} bases",
                          lambda k=k, canon=canon: pack_kmers128(
                              rec[0], k, canon), graph_ms,
                          "bk_pack_kmers128"))
    return cases


def _inline_map(keys, rng):
    """A map of the sorted distinct ``keys`` with 6 distinct values (its
    probe image on a device: ``.arrays(dev)``)."""
    from ..db.table import KmerTable, ScoreMap

    v = rng.integers(0, 6, keys.size).astype(np.uint64)
    return ScoreMap(KmerTable(keys, ((v + np.uint64(100)) << np.uint64(32)) | v))


def own_table(a1, rng, dev):
    """A table of the canonical k-mers of the batch of ``a1`` and 9M random
    keys (2^22 buckets, as the ec table), 6 values: every probe hits."""
    from ..classify import pipeline as pl

    pc, nm, ln, lproc, k, canon = a1[:6]
    codes = pl.unpack_2bit(pc.cpu(), None if nm is None else nm.cpu())
    em = enc.minimizers_plain(codes[:, :lproc], ln.cpu(), k, 1, canon)
    own = em.values[em.mask].numpy().view(np.uint64)
    return _inline_map(unique_u64(np.concatenate([
        own, rng.integers(0, 2**64, 9_000_000, dtype=np.uint64)])),
        rng).arrays(dev)


def probe_mix_cases(a1, arr, rng, dev):
    """(name, call, timer) of K1 where the probes hit: the batch of ``a1``
    against ``arr`` (``own_table``), and ``chip_smoke.py``'s scale-probe
    shape at 2^24 keys (2^23 reads of 32 bases, one k = 32 k-mer each,
    half of them stored)."""
    from ..classify import pipeline as pl

    pc, nm, ln, lproc, k, canon, _, want_idx = a1
    n, Q = 1 << 24, 1 << 23
    keys = unique_u64(rng.integers(0, 2**64, n + n // 64, dtype=np.uint64))[:n]
    scale = _inline_map(keys, rng).arrays(dev)
    q = np.concatenate([keys[rng.integers(0, n, Q // 2)],
                        rng.integers(0, 2**64, Q // 2, dtype=np.uint64)])
    shifts = np.uint64(2) * (np.uint64(31) - np.arange(32, dtype=np.uint64))
    codes = ((q[:, None] >> shifts) & np.uint64(3)).astype(np.uint32)
    words = (codes.reshape(Q, 2, 16) << (np.arange(16, dtype=np.uint32) * 2)
             ).sum(-1, dtype=np.uint32)
    spc = torch.from_numpy(words.view(np.int32)).to(dev)
    sln = torch.full((Q,), 32, dtype=torch.int32, device=dev)
    return [
        ("encode_probe, the same batch on a table of its own k-mers (hits)",
         lambda: pl.encode_probe(pc, nm, ln, lproc, k, canon, arr, want_idx),
         graph_ms),
        (f"encode_probe, the scale shape: 2^24 keys, {Q} queries, half "
         "stored", lambda: pl.encode_probe(spc, None, sln, 32, 32, False,
                                           scale, False), graph_ms),
    ]


def resolve_cases(clf, a1, own, genome: str, dev, say=print):
    """(name, call, timer) of K2 where the ec batch does not reach: every
    position hit (K1's output of the batch of ``a1`` on ``own``, a table
    of its own k-mers), the deep tree, and long reads (P > 1024)."""
    from ..classify import pipeline as pl
    from ..classify import resolve as rs

    hit, _, cidx, _ = pl.encode_probe(*a1[:6], own, True)
    rng = np.random.default_rng(SEED + 2)
    tree = deep_tree(rng)
    dc, dh = deep_rows(rng, tree)
    dtax = tree.device_arrays(dev)
    dn = int(np.unique(dc[dh]).size)
    dc, dh = torch.from_numpy(dc).to(dev), torch.from_numpy(dh).to(dev)
    prep = _mask_only(clf)._prepare_batch(long_reads(genome, DNA4.lut, rng))
    pc, nm, ln = (None if t is None else t.to(dev)
                  for t in (prep.pcodes, prep.nmask, prep.lengths))
    lh, _, lc, _ = pl.encode_probe(pc, nm, ln, prep.lproc, clf.k, clf.canon,
                                   clf.arr, True)
    for what, c, h, t in (("ec batch, every position hit", cidx, hit, clf.tax),
                          ("deep tree", dc, dh, dtax),
                          ("long reads", lc, lh, clf.tax)):
        say(f"# resolve, {what}: {int(h.sum())} hits in {h.shape[0]} rows of "
            f"{h.shape[1]}; {resolve_bound_text(c, h, t)}")
    return [
        (f"resolve, every position hit B={hit.shape[0]}, P={hit.shape[1]}",
         lambda: [rs.resolve(cidx, hit, clf.tax, 6)], graph_ms),
        (f"resolve, deep tree ({tree.tin.size} nodes, {tree.lift.shape[0]} "
         f"lift levels) B={dh.shape[0]}, P={dh.shape[1]}",
         lambda: [rs.resolve(dc, dh, dtax, dn)], graph_ms),
        (f"resolve, long reads B={lh.shape[0]}, P={lh.shape[1]}",
         lambda: [rs.resolve(lc, lh, clf.tax, clf._n_distinct)], graph_ms),
    ]


def yardstick_ms(dev) -> float:
    """Graph-replayed ms of one elementwise torch pass (``add_``) over an
    int32 matrix the size of K3's full output for 8192 HiSeq reads: what a
    kernel that streams K3's bytes once takes on the card."""
    t = torch.zeros((CLASSIFY_BATCH, 81), dtype=torch.int32, device=dev)
    return graph_ms(lambda: t.add_(1))


def _mask_only(clf):
    """``clf`` with ``_sparse_n_ok`` False: the same arrays, and a batch
    with an in-read N ships the N mask."""
    import copy

    m = copy.copy(clf)
    m._sparse_n_ok = lambda: False
    return m


def sparse_inputs(clf, batch, dev):
    """K1's inputs for ``batch`` in the mask channel and in the sparse
    one: (mask args, sparse args, the sparse list), on ``dev``."""
    out = []
    for prep in (_mask_only(clf)._prepare_batch(batch),
                 clf._prepare_batch(batch)):
        pc, nm, ln = (None if t is None else t.to(dev)
                      for t in (prep.pcodes, prep.nmask, prep.lengths))
        out.append(((pc, nm, ln, prep.lproc, clf.k, clf.canon, clf.arr,
                     True), None if prep.nidx is None else prep.nidx.to(dev)))
    (a1, _), (a1s, nidx) = out
    if nidx is None:
        raise ValueError("the batch does not take the sparse channel")
    return a1, a1s, nidx


def sparse_vs_mask(a1, a1s, nidx, say=print) -> dict:
    """K1's sparse instantiation against its mask instantiation on the
    same batch, in this process: the same output, then graph-replayed in
    turns mask, sparse, sparse, mask."""
    from ..classify import pipeline as pl

    def mask():
        return pl.encode_probe(*a1)

    def sparse():
        return pl.encode_probe(*a1s, nidx=nidx)

    if not all(torch.equal(a, b) for a, b in zip(mask(), sparse())):
        raise AssertionError("K1 sparse and K1 mask differ")
    t = [graph_ms(f, ITERS) for f in (mask, sparse, sparse, mask)]
    say(f"# encode_probe mask {t[0]:.4f} ms, sparse {t[1]:.4f} ms, sparse "
        f"{t[2]:.4f} ms, mask {t[3]:.4f} ms (graph_ms; same output): sparse "
        f"/ mask {(t[1] + t[2]) / (t[0] + t[3]):.4f}")
    return {"mask_ms": [t[0], t[3]], "sparse_ms": [t[1], t[2]]}


def classify_cases(reads: str, nodes: str, nameid: str, genomes, dev):
    """(name, call, timer) of K1, K2 and K3 on one HiSeq-sized batch, each
    fed by the tree's own kernels' outputs, and K1 radix's (``radix_cases``);
    K1's inputs in both N channels (``sparse_inputs``); the radix cases'
    bounds."""
    from ..classify import pipeline as pl
    from ..classify import resolve as rs
    from ..core.spacer import Spacer
    from ..db.build import lca_map
    from ..db.formats import Database

    tree = TaxTree.from_nodes_dmp(nodes)
    table = lca_map(list(genomes), tree, nameid, Spacer(31, 31))
    db = Database(table=table, k=31, w=31, gaps=[0] * 30)
    clf = pl.Classifier(db, tree, emit_all=True, device=dev)
    batch = next(iter(fastx.batch_reads(reads, DNA4.lut,
                                        batch_size=CLASSIFY_BATCH)))
    a1, a1n, nidx = sparse_inputs(clf, batch, dev)
    pc, nm, ln, lproc = a1[:4]
    ds = len(clf._uniq_host)
    hit, valid, cidx, oidx = pl.encode_probe(*a1)
    valid1 = valid.sum(-1, dtype=torch.int32)
    taxon = rs.resolve(cidx, hit, clf.tax, clf._n_distinct)
    shape = f"B={hit.shape[0]}, P={hit.shape[1]}"
    print(f"# resolve, ec batch: {int(hit.sum())} hits in {hit.shape[0]} rows "
          f"of {hit.shape[1]}; {resolve_bound_text(cidx, hit, clf.tax)}")
    rng = np.random.default_rng(SEED + 1)
    own = own_table(a1, rng, dev)
    # K1's spaced instantiation: the same batch against the -k 21 -S
    # 0x16,1x4 database of the genomes, built on the card
    from ..core.spacer import parse_spacing
    from ..db.build_device import device_lca_map

    gaps = parse_spacing("0x16,1x4", 21)
    sdb = Database(table=device_lca_map(list(genomes), tree, nameid,
                                        Spacer(21, 21, gaps), device=dev),
                   k=21, w=21, gaps=gaps)
    sclf = pl.Classifier(sdb, tree, emit_all=True, device=dev)
    a1s = (pc, nm, ln, lproc, 21, False, sclf.arr, True, sclf.positions)
    radix, radix_bounds = radix_cases(nodes, nameid, genomes, dev)
    return [
        (f"encode_probe {shape}", lambda: pl.encode_probe(*a1), graph_ms),
        (f"encode_probe sparse {shape}",
         lambda: pl.encode_probe(*a1n, nidx=nidx), graph_ms,
         "bk_encode_probe_sparse"),
        (f"encode_probe -k 21 -S 0x16,1x4 B={hit.shape[0]}, P={lproc - 24}",
         lambda: pl.encode_probe(*a1s), graph_ms, "bk_encode_probe_spaced"),
        *radix,
        *probe_mix_cases(a1, own, rng, dev),
        (f"resolve {shape}",
         lambda: [rs.resolve(cidx, hit, clf.tax, clf._n_distinct)], graph_ms),
        *resolve_cases(clf, a1, own, genomes[0], dev),
        (f"step_outputs {shape}, maxr={clf.max_runs}",
         lambda: pl.step_outputs(taxon, oidx, hit, valid, valid1,
                                 clf.max_runs, ds), graph_ms),
    ], (a1, a1n, nidx), radix_bounds


def _radix_batch(clf, reads, dev):
    """``reads`` as ``clf`` ships them: (int8 codes, lengths) on ``dev``."""
    lut = np.asarray(clf.lut, np.int8)
    codes = np.full((len(reads), 64), -1, np.int8)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = lut[np.frombuffer(r, np.uint8)]
    batch = fastx.ReadBatch(names=[b""] * len(reads), seqs=reads, codes=codes,
                            lengths=np.array([len(r) for r in reads],
                                             np.int32))
    prep = clf._prepare_batch(batch)
    return prep.pcodes.to(dev), prep.lengths.to(dev)


def radix_cases(nodes: str, nameid: str, genomes, dev, say=print):
    """([(name, call, timer, entry point, slot rows)], {name: bounds}) of
    K1's radix instantiations at phase 9k's shapes: the first 8192 reads of its
    PROTEIN20 read set (``synthetic.protein_reads`` of the GENOMEs'
    forward frames), as ``Classifier(input_type=PROTEIN20)`` ships them,
    against the frames' PROTEIN20 -k 7 database, built on the card, in
    dictionary mode: the whole table, the bucket range of psum (1, 1)'s
    rank, encode only; and the first 8192 reads of its PROTEIN_3BIT set
    against the first two GENOMEs' PROTEIN_3BIT -k 12 -S 1x11 database
    (spaced, shift-or), built on the card as 9k builds it.  Each case's
    two bounds (``bounds``: over the padded grid and over the reads' own
    positions, ``in_read``) are printed and returned; then the launch
    floors at the batch's grid."""
    import tempfile

    from ..classify import pipeline as pl
    from ..core.alphabet import InputType
    from ..core.spacer import Spacer, parse_spacing
    from ..db.formats import Database
    from ..parallel import sharded as sh
    from ..parallel.mesh import make_mesh
    from .bounds import (bound_encode_only, bound_encode_probe,
                         bound_encode_probe_range, bound_text, k1_rows,
                         range_rows, spaced_runs)
    from .synthetic import ALPHABET_READ_SETS, protein_reads, write_frames

    tree = TaxTree.from_nodes_dmp(nodes)
    p20, p3 = InputType.PROTEIN20, InputType.PROTEIN_3BIT
    gaps = parse_spacing("1x11", 12)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(OUT_DIR)) as tmp:
        frames = [write_frames(g, os.path.join(tmp, f"{i}.faa"))
                  for i, g in enumerate(genomes)]
        t20 = bd.device_lca_map(frames, tree, nameid, Spacer(7, 7), True,
                                "lex", p20, device=dev)
        t3 = bd.device_lca_map(frames[:2], tree, nameid,
                               Spacer(12, 0, gaps), True, "lex", p3,
                               device=dev)
        n, seed, _, _ = ALPHABET_READ_SETS["PROTEIN20 single"]
        r20 = protein_reads(frames, n, seed)[:CLASSIFY_BATCH]
        n, seed, _, ng = ALPHABET_READ_SETS["PROTEIN_3BIT single"]
        r3 = protein_reads(frames[:ng], n, seed)[:CLASSIFY_BATCH]
    db20 = Database(table=t20, k=7, w=7, gaps=[0] * 6)
    c20 = pl.Classifier(db20, tree, input_type=p20, device=dev)
    c3 = pl.Classifier(Database(table=t3, k=12, w=23, gaps=list(gaps)),
                       tree, input_type=p3, device=dev)
    psum = sh.ShardedClassifier(db20, tree, make_mesh({"dp": 1, "db": 1},
                                                      [dev]),
                                input_type=p20, route="psum")
    cd, ld = _radix_batch(c20, r20, dev)
    sd, sl = _radix_batch(c3, r3, dev)
    want_idx = c20._uniq_host is not None
    pos = c3.positions
    shape = f"B={cd.shape[0]}, P={cd.shape[1] - 6}"
    kmers, valid = pl.encode_only_radix(cd, ld, 7, False, p20)
    rolled = dict(rolled=True)
    spaced = dict(runs=spaced_runs(pos))
    cases, bounds = [], {}

    def probe(arr):
        return lambda: pl.encode_probe_radix(cd, ld, 7, False, p20, arr,
                                             want_idx)

    def sprobe():
        return pl.encode_probe_radix(sd, sl, 12, False, p3, c3.arr,
                                     c3._uniq_host is not None, pos)

    def only():
        return pl.encode_only_radix(cd, ld, 7, False, p20)

    rarr = psum._arr[0]
    for name, call, entry, bnd in (
            (f"encode_probe_radix PROTEIN20 -k 7 {shape}", probe(c20.arr),
             "bk_encode_probe_radix",
             lambda out, **kw: bound_encode_probe(
                 (cd, ld), c20.arr.vals, out, **rolled, **kw)),
            (f"encode_probe_radix_range PROTEIN20 -k 7 psum (1, 1) {shape}",
             probe(rarr), "bk_encode_probe_radix_range",
             lambda out, **kw: bound_encode_probe_range(
                 (cd, ld), rarr.vals, out, kmers[valid], rarr, **rolled,
                 **kw)),
            (f"encode_only_radix PROTEIN20 -k 7 {shape}", only,
             "bk_encode_only_radix",
             lambda out, **kw: bound_encode_only((cd, ld), out, **rolled,
                                                 **kw)),
            (f"encode_probe_radix PROTEIN_3BIT -k 12 -S 1x11 "
             f"B={sd.shape[0]}, P={sd.shape[1] - 22}", sprobe,
             "bk_encode_probe_radix",
             lambda out, **kw: bound_encode_probe(
                 (sd, sl), c3.arr.vals, out, **spaced, **kw))):
        out = call()
        c = 23 if "-S" in name else 7
        bounds[name] = (bnd(out), bnd(out, inread=c))
        rows = (0 if "encode_only" in name else
                range_rows(kmers[valid], rarr) if "range" in name else
                k1_rows(out))
        say(f"# {name}: {int(out[1].sum())} valid positions, {rows} slot "
            f"rows; padded grid {bound_text(bounds[name][0])}; reads' own "
            f"positions {bound_text(bounds[name][1])}")
        cases.append((name, call, graph_ms, entry, rows or None))
    from .gather_bench import empty_launch

    n = cd.shape[0] * (cd.shape[1] - 6)
    floor = {f"empty, {b} blocks of 256": graph_ms(
        lambda b=b: empty_launch(b, False, dev), ITERS)
        for b in (1, -(-n // 1024), -(-n // 256))}
    say(f"# launch floors at the radix grid ({n} positions; graph replay, "
        f"ms a launch): {floor}")
    return cases, bounds


def radix_shares(res, bounds, say=print) -> dict:
    """Each radix case's shares (bound / time) of ``res``, from its
    ``bounds`` (``radix_cases``): over the padded grid and over the reads'
    own positions, for each revision."""
    out = {}
    for name, (grid, own) in bounds.items():
        case = res["cases"].get(name)
        if case is None:
            continue
        out[name] = {label[:-3]: [grid[0] / (sum(t) / 2),
                                  own[0] / (sum(t) / 2)]
                     for label, t in case.items() if label.endswith("_ms")}
        text = ", ".join(f"{lb} {g:.1%}, {o:.1%}"
                         for lb, (g, o) in out[name].items())
        say(f"# {name}: share (padded grid, reads' own positions) {text}")
    return out


def radix_ptxas(libs, say=print) -> dict:
    """ptxas's registers and spill stores of K1's radix kernels in each
    library (the template instantiations of ``radix_kernel``, or of a
    parent's shared ``encode_probe_kernel`` with its radix flag set), and
    the tree's own: each instantiation's registers, local bytes and
    blocks a SM from the card (``bk_encode_probe_radix_attrs``)."""
    out = {}
    for label, lib in libs.items():
        out[label] = {k: v for k, v in lib.ptxas_all.items()
                      if "radix_kernel" in k or re.search(
                          r"encode_probe_kernelILb[01]ELi[0-9]ELb1E", k)}
        say(f"# {label}: ptxas of K1 radix {out[label]}")
    buf = (ctypes.c_int * 6)()
    attrs = {}
    for mode, what in enumerate(("whole", "range", "encode")):
        for spaced in (0, 1):
            for fold, kind in ((1, "shift"), (2, "muladd")):
                err = kernels.get_lib().bk_encode_probe_radix_attrs(
                    mode, spaced, fold, buf)
                if err:
                    raise RuntimeError(f"bk_encode_probe_radix_attrs: {err}")
                attrs[f"{what} {'spaced' if spaced else 'contiguous'} "
                      f"{kind}"] = dict(zip(
                          ("registers", "local_bytes", "shared_bytes",
                           "blocks_per_sm", "run", "threads"),
                          list(buf)))
    out["tree"] = attrs
    say(f"# tree: K1 radix instantiations {attrs}")
    return out


STATE = ("done", "hit", "cidx", "oidx")


def round_io(clf, st, cap) -> dict:
    """One a2a round of ``clf`` from its state ``st`` (updated in place):
    rank 0's queries, the state it started from (cloned) and after, its
    frame, returned frame and pending count; every rank's received frame
    and sub-table."""
    before = [st[0][x].clone() for x in STATE]
    _, got = clf._a2a_round(st, cap, False)
    return dict(kq=st[0]["kq"], done=before[0], state=before, cap=cap,
                after=[st[0][x] for x in STATE], send=got["frame"][0][0],
                slotq=got["frame"][0][1], back=got["back"][0],
                left=got["left"][0], recvs=got["recv"], resp=got["resp"],
                arrs=dict(clf._arr))


def later_rounds(clf, prep, keep: int = 64) -> dict:
    """Two later a2a rounds of the batch ``prep``, each as ``round_io``:
    "cf 0.05 round 2", the second round at capacity factor 0.05 (every
    frame row a query while an owner has more than cap pending); and
    "pads", at ``clf``'s own factor after the first round, with the last
    ``keep`` valid queries of each rank pending again: a frame of nearly
    all U64_MAX rows, as after a batch that overflowed its cap a little."""
    cf = clf.capacity_factor
    clf.capacity_factor = 0.05
    try:
        st, cap = clf._a2a_start(clf._uploads(prep), prep[3])
        clf._a2a_round(st, cap, False)
        out = {"cf 0.05 round 2": round_io(clf, st, cap)}
    finally:
        clf.capacity_factor = cf
    st, cap = clf._a2a_start(clf._uploads(prep), prep[3])
    clf._a2a_round(st, cap, False)
    for r in st.values():
        r["done"][r["valid"].view(-1).nonzero()[-keep:, 0]] = False
    out["pads"] = round_io(clf, st, cap)
    return out


def route_cases(reads: str, nodes: str, nameid: str, genomes, dev,
                say=print):
    """(name, call, timer, entry point, None, fresh) of KD1's frame, probe
    and collect at the first a2a round of an 8192-read batch at (1, 4)
    and at two later rounds (``later_rounds``), and of the frame at 4M
    queries and at ndb = 1024; each case's bound, and each probe's split
    (``bounds.probe_split``), printed.  A collect case's call is the
    collect alone, on a state cloned once (the same bytes every call),
    and ``fresh`` restores that state before a checked call."""
    from ..core.spacer import Spacer
    from ..db.build import lca_map
    from ..db.formats import Database
    from ..parallel import route as rt
    from ..parallel import sharded as sh
    from ..parallel.mesh import make_mesh
    from .bounds import (bound_route_collect, bound_route_frame,
                         bound_route_probe, bound_text, probe_split)

    tree = TaxTree.from_nodes_dmp(nodes)
    table = lca_map(list(genomes), tree, nameid, Spacer(31, 31))
    db = Database(table=table, k=31, w=31, gaps=[0] * 30)
    clf = sh.ShardedClassifier(db, tree, make_mesh({"dp": 1, "db": 4}, [dev]))
    batch = next(iter(fastx.batch_reads(reads, DNA4.lut,
                                        batch_size=CLASSIFY_BATCH)))
    prep = clf._prepare_batch(batch)
    st, cap = clf._a2a_start(clf._uploads(prep), prep[3])
    rounds = {"first round": round_io(clf, st, cap),
              **{f"later round, {k}": v
                 for k, v in later_rounds(clf, prep).items()}}
    r1 = rounds["first round"]
    kq, done = r1["kq"], r1["done"]
    rng = np.random.default_rng(SEED + 3)
    big = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, 4_000_000)).to(dev)
    big_done = torch.zeros(big.numel(), dtype=torch.bool, device=dev)
    big_cap = -(-big.numel() * 105 // 400)
    wide_cap = -(-kq.numel() * 105 // (100 * 1024))
    Q = kq.numel()
    frames = (("", kq, done, 4, cap),
              (" 4M queries", big, big_done, 4, big_cap),
              (" ndb=1024", kq, done, 1024, wide_cap))
    for what, x, d, ndb, c in frames:
        b = bound_route_frame(x, d, rt.route_frame(x, d, ndb, c))
        say(f"# route_frame{what}: {x.numel()} queries, ndb={ndb}, cap={c}; "
            f"{bound_text(b)}")
    cases = [(f"route_frame{what} Q={x.numel()}, ndb={ndb}, cap={c}",
              lambda x=x, d=d, ndb=ndb, c=c: rt.route_frame(x, d, ndb, c),
              graph_ms, "bk_route_frame") for what, x, d, ndb, c in frames]
    cases.append((f"route_frame Q={Q}, ndb=4, cap={cap}, events around "
                  "back-to-back wrapper calls (the host's enqueue shows)",
                  lambda: rt.route_frame(kq, done, 4, cap), time_ms,
                  "bk_route_frame"))
    for tag, r in rounds.items():
        recvs, arrs, back, slotq = r["recvs"], r["arrs"], r["back"], r["slotq"]
        for k in sorted(recvs):
            b = bound_route_probe(recvs[k], arrs[k],
                                  rt.route_probe(recvs[k], arrs[k], False))
            say(f"# route_probe, {tag}, rank {k}: {recvs[k].numel()} keys "
                f"(cap {r['cap']}), {probe_split(recvs[k], arrs[k])}; "
                f"{bound_text(b)}")
        routed = int((slotq < back.numel()).sum())
        mine = [x.clone() for x in r["state"]]
        say(f"# route_collect, {tag}: {slotq.numel()} queries, {routed} "
            f"routed; "
            f"{bound_text(bound_route_collect(slotq, r['state'][0], routed))}")

        def probes(recvs=recvs, arrs=arrs):
            return [rt.route_probe(recvs[k], arrs[k], False)
                    for k in sorted(recvs)]

        def collect(back=back, slotq=slotq, mine=mine):
            return [rt.route_collect(back, slotq, *mine)] + mine

        def fresh(mine=mine, state=r["state"]):
            for m, x in zip(mine, state):
                m.copy_(x)

        cases.append((f"route_probe, {tag}, the 4 ranks in turn "
                      f"{[recvs[k].numel() for k in sorted(recvs)]} keys",
                      probes, graph_ms, "bk_route_probe"))
        if tag == "first round":
            cases.append(("route_probe, first round, rank 0 alone (its "
                          "sub-table's rows stay in L2)",
                          lambda: [rt.route_probe(recvs[0], arrs[0], False)],
                          graph_ms, "bk_route_probe"))
        cases.append((f"route_collect, {tag}, Q={Q}, {routed} routed",
                      collect, graph_ms, "bk_route_collect", None, fresh))
    return cases, rounds


def floors(rounds, dev, say=print) -> dict:
    """Graph-replayed ms of empty launches (``gather_bench.empty_launch``)
    at the probe's and collect's grids of the first round, and of a
    cooperative one at collect's grid with one grid barrier: the floors
    of those launches."""
    from .gather_bench import empty_launch

    r1 = rounds["first round"]
    n = r1["recvs"][0].numel()
    probe_blocks = -(-n // 256)
    collect_blocks = -(-r1["slotq"].numel() // 1024)
    out = {f"empty, {b} blocks": graph_ms(
        lambda b=b: empty_launch(b, False, dev), ITERS)
        for b in (1, collect_blocks, probe_blocks)}
    out[f"cooperative with a grid barrier, {collect_blocks} blocks"] = (
        graph_ms(lambda: empty_launch(collect_blocks, True, dev), ITERS))
    say(f"# launch floors (graph replay, ms a launch): {out}")
    return out


def _device_ms(fn, calls=5):
    """Device milliseconds a call, by kernel name, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if getattr(e, "device_type", None) == DeviceType.CUDA and us > 0:
            out[e.key[:60]] = us / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def run(libs: dict, cases, say=print) -> dict:
    """Check and time each (name, call, timer[, entry point[, slot
    rows[, fresh]]]) of ``cases`` on the tree's kernels (the change)
    against ``libs``: the parent's build, then any edited copies of it
    (``EDITS`` names).  The change's output must equal the parent's, and
    an edit's that keeps the output, each call after ``fresh()`` where a
    case has one (a call that updates its inputs); in turns parent,
    change, each copy, then backwards; with slot rows, each time's row
    rate beside it."""
    res = {"cases": {}, "profile": {}, "skipped": []}
    for name, change, timer, *extra in cases:
        entry, rows, fresh = (list(extra) + [None] * 3)[:3]
        fresh = fresh or (lambda: None)
        if entry and not hasattr(libs["parent"], entry):
            say(f"# {name}: skipped, the parent has no {entry}")
            res["skipped"].append(name)
            continue
        calls = {"parent": on(libs["parent"], change), "change": change,
                 **{e: on(lib, change) for e, lib in libs.items()
                    if e != "parent"}}
        fresh()
        got = [g.clone() for g in change()]
        checked = [label for label in calls if label == "parent" or (
            label != "change" and keeps_output(label))]
        for label in checked:
            fresh()
            if not all(torch.equal(g, w) for g, w in zip(got, calls[label]())):
                raise AssertionError(f"{name}: {label} and change differ")
        order = list(calls)
        times = {label: [] for label in order}
        for label in order + order[::-1]:
            times[label].append(timer(calls[label], ITERS))
        res["cases"][name] = {f"{label}_ms": t for label, t in times.items()}
        res["cases"][name]["timer"] = timer.__name__
        text = ", ".join(f"{label} {t[0]:.4f}, {t[1]:.4f} ms"
                         for label, t in times.items())
        say(f"# {name}: {text} ({timer.__name__}, in turns "
            f"{', '.join(order + order[::-1])}; output of "
            f"{', '.join(checked)} = change's)")
        if rows:
            res["cases"][name]["slot_rows"] = rows
            rate = ", ".join(f"{label} {rows / (sum(t) / 2) / 1e6:.2f}"
                             for label, t in times.items())
            say(f"#   {rows} slot rows (bounds.probe_rows): G rows/s {rate}")
        res["profile"][name] = {label: _device_ms(call)
                                for label, call in calls.items()}
        say(f"#   by kernel, ms a call: {res['profile'][name]}")
    return res


def build_libs(parent_csrc: str, names, edits, change=False,
               say=print, info=False) -> dict:
    """Libraries of ``names``.cu, built together: the parent's, an edited
    copy of the parent's for each of ``edits`` and, with ``change``, the
    tree's; with ``change`` (``--hash``) each with the hash occupancy
    queries, their blocks a SM and ptxas's registers and spills
    printed; with ``info``, ptxas's numbers kept (``build_parent``)."""
    jobs = {"parent": (parent_csrc, None),
            **({"change": (kernels.CSRC, None)} if change else {}),
            **{e: (parent_csrc, e) for e in edits}}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {label: pool.submit(build_parent, csrc, names, label, edit,
                                   change or info)
                for label, (csrc, edit) in jobs.items()}
        libs = {label: f.result() for label, f in futs.items()}
    for label, lib in libs.items():
        if change:
            occ = {what: getattr(lib, fn)(*a) for what, fn, a in OCCUPANCY}
            say(f"# {label}: blocks a SM {occ}; ptxas {lib.ptxas}")
    return libs


USAGE = ("usage: python -m bonsai_tpu_torch.tools.kernel_ab PARENT_CSRC GENOME "
         "NODES [-e EDIT]...\n       python -m bonsai_tpu_torch.tools.kernel_ab "
         "--sketch PARENT_CSRC GENOME [-k NAME] [-e EDIT]...\n       python -m bonsai_tpu_torch.tools.kernel_ab "
         "--api PARENT_CSRC GENOME [-k NAME] [-e EDIT]...\n       python -m bonsai_tpu_torch.tools.kernel_ab "
         "--hash PARENT_CSRC GENOME [EDIT...] [--fold NODES NAMEID GENOME...]\n"
         "       python -m bonsai_tpu_torch.tools.kernel_ab "
         "--classify PARENT_CSRC READS NODES NAMEID GENOME...\n"
         "       python -m bonsai_tpu_torch.tools.kernel_ab --route "
         "PARENT_CSRC READS NODES NAMEID GENOME... [-e EDIT]...\n"
         f"EDIT: one of {', '.join(EDITS)}, or several joined by '+'")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    modes = ("--classify", "--route", "--sketch", "--api", "--hash")
    mode = args[0] if args and args[0] in modes else ""
    if mode:
        args = args[1:]
    edits = [e for a, e in zip(args, args[1:]) if a == "-e"]
    only = [e for a, e in zip(args, args[1:]) if a == "-k"]
    while mode in ("--sketch", "--api") and "-k" in args:
        args = args[:args.index("-k")] + args[args.index("-k") + 2:]
    if mode in ("--classify", "--route", "--api", "--sketch", "") and edits:
        args = args[:args.index("-e")]
    fold = []
    if mode == "--hash" and "--fold" in args:
        fold = args[args.index("--fold") + 1:]
        args = args[:args.index("--fold")]
    for edit in (args[2:] if mode == "--hash" else edits):
        _edit_parts(edit)
    if ((mode in ("--classify", "--route") and len(args) < 5)
            or (mode in ("--sketch", "--api") and len(args) != 2)
            or (mode == "--hash" and (len(args) < 2 or 0 < len(fold) < 3))
            or (not mode and len(args) != 3)):
        print(USAGE, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(f"# {card}; torch {torch.__version__}")
    dev = torch.device("cuda", 0)
    if mode == "--classify":
        cases, k1_in, radix_bounds = classify_cases(*args[1:4], args[4:],
                                                    dev)
        libs = build_libs(args[0], CLASSIFY_SOURCES, edits, info=True)
        res = run(libs, cases)
        res["radix_shares"] = radix_shares(res, radix_bounds)
        res["radix_ptxas"] = radix_ptxas(libs)
        res["sparse_vs_mask"] = sparse_vs_mask(*k1_in)
        res["yardstick_ms"] = yardstick_ms(dev)
        print(f"# yardstick: add_ over an int32 ({CLASSIFY_BATCH}, 81) matrix, "
              f"graph replay: {res['yardstick_ms']:.4f} ms")
    elif mode == "--route":
        cases, rounds = route_cases(*args[1:4], args[4:], dev)
        res = run(build_libs(args[0], ROUTE_SOURCES, edits), cases)
        res["floors"] = floors(rounds, dev)
    elif mode == "--hash":
        # the change is the tree's build of HASH_SOURCES, which holds every
        # entry point these cases call
        # (--fold's build also runs KB2 and KB3)
        libs = build_libs(args[0], HASH_SOURCES + (
            ("sort_unique", "merge_fold") if fold else ()), args[2:],
            change=True)
        kernels._lib = libs.pop("change")
        seq = next(iter(fastx.read_fastx(args[1])))[1]
        rng = np.random.default_rng(SEED)
        cases = hash_cases(seq, dev, rng)
        if fold:
            cases += fold_cases(fold[0], fold[1], fold[2:], dev, rng)
        res = run(libs, cases)
    elif mode:
        seq = next(iter(fastx.read_fastx(args[1])))[1]
        cases = (sketch_cases if mode == "--sketch" else api_cases)(seq, dev)
        if only:
            cases = [c for c in cases if any(o in c[0] for o in only)]
        names = (sorted({SKETCH_SOURCES[c[3]] for c in cases})
                 if mode == "--sketch" else BUILD_SOURCES)
        res = run(build_libs(args[0], names, edits), cases)
        if mode == "--sketch" and any("hll" in c[0] for c in cases):
            res["hll_yardstick_ms"] = hll_yardstick(seq, dev)
    else:
        res = run(build_libs(args[0], BUILD_SOURCES, edits),
                  build_cases(*args[1:], dev))
    res["card"] = card
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
