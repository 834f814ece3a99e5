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
(``synthetic.translate``): KB1 PROTEIN20 k = 7 unwindowed, PROTEIN_6
-k 12 -S 1x11 -w 30 Shannon, KB4 PROTEIN_14 -k 10 -w 24 and PROTEIN20
-k 7 -w 20 Shannon; KR1 at k = 31 and 64 canonical and 200.  Then the
sketch kernels at the shapes of ``chip_smoke.py``'s phase 9e on GENOME's
first record: KS1 (p = 14, wang_hash) and KS4 (wang_hash, nuccount) on
its canonical 31-mers, KS2 (m = 4096, -S -s and default, a new sketch a
call and a full one, the sketch of the same stream) on the same stream,
KS3 on its k = 31 rolling-hash stream, and KB2 on its first 4M windows'
k = 31 W = 1 minimizers (the build's chunk).  KB1, KB4, KB5, KR1, KS1 and
KS4 are timed by replaying a CUDA graph of 100 captured calls between two
events (``gather_bench.graph_ms``), KB3, KB2 and KS3 (whose wrappers read
the distinct count) and KS2 by CUDA events around 100 back-to-back
calls.  A case whose
entry point the parent's library lacks is skipped, and says so.  With
``--sketch`` only these sketch cases and KB2 run, with ``--api`` only the
Python API's cases (KB1, KB4 and KR1 above):

    python -m bonsai_tpu_torch.tools.kernel_ab --sketch PARENT_CSRC GENOME
    python -m bonsai_tpu_torch.tools.kernel_ab --api PARENT_CSRC GENOME

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
-k 21 -S 0x16,1x4 database, built on the card.
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
half stored), each by graph replay with its slot rows
(``bounds.probe_rows``) and G rows/s beside its time.  The change is the
tree's build of their sources, and each library's blocks a SM (the
entry points ``bk_*_hash_blocks_per_sm``, appended to a copy of a source
that lacks them) and ptxas's registers and spills are printed first.
Each EDIT names an edited copy of the parent's sources (``HASH_EDITS``,
several joined by '+'), timed in the same turns: a design experiment
(the probe or the value read taken out, another batch size); an edit
that changes the output is timed but not checked:

    python -m bonsai_tpu_torch.tools.kernel_ab --hash PARENT_CSRC GENOME \\
        [EDIT...]

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
from .synthetic import deep_rows, deep_tree, long_reads

SEED = 20261016
ITERS = 100  # calls a timing: a few ms of device time even at 30 us a call
OUT_DIR = os.path.join(os.path.dirname(kernels.BUILD_DIR), "kernel_ab")
BUILD_SOURCES = ("merge_fold", "minimizers", "compacted_minimizers",
                 "lookup_scores", "rolling", "sort_unique", "hll", "setsketch",
                 "bitmix")
CLASSIFY_SOURCES = ("encode_probe", "resolve", "step_outputs")
ROUTE_SOURCES = ("route",)
HASH_SOURCES = ("minimizers", "compacted_minimizers", "lookup_scores")
CLASSIFY_BATCH = 8192
# KB1's and KB4's one entry point each
KB1, KB4 = "bk_minimizers_gen", "bk_compacted_minimizers_gen"
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
    # the hash instantiations held to 3 blocks a SM (at most 85 registers)
    "lb3": (True, tuple((f, f"__launch_bounds__(kThreads)\n    {kern}(",
                         f"__launch_bounds__(kThreads, 3)\n    {kern}(")
                        for f, kern in (("minimizers.cu", "minimizers_kernel"),
                                        ("compacted_minimizers.cu",
                                         "window_kernel")))),
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
EDITS = {**HASH_EDITS, **ROUTE_EDITS}

# the hash instantiations' blocks a SM: (label, entry point, arguments)
OCCUPANCY = (("KB1 hash W=13", "bk_minimizers_hash_blocks_per_sm",
              (0, 25, 13)),
             ("KB1 spaced hash W=16", "bk_minimizers_hash_blocks_per_sm",
              (1, 25, 16)),
             ("KB4 hash window W=13",
              "bk_compacted_minimizers_hash_blocks_per_sm", (13,)))
# the kernels whose registers and spills --hash prints (ptxas -v), by a
# part of their mangled names
PTXAS = (("KB1 hash", "minimizers_kernelILb0ELi2ELb0E"),
         ("KB1 spaced hash", "minimizers_kernelILb1ELi2ELb0E"),
         ("KB4 hash window", "window_kernelILi1E"),
         ("KB5", "lookup_scores_kernel"))


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
    queries (``OCCUPANCY``) appended to a source that lacks them."""
    out = os.path.join(OUT_DIR, f"src_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for part in _edit_parts(edit) if edit else ():
        taken = 0
        for f, old, new in EDITS[part][1]:
            path = os.path.join(out, f)
            text = open(path).read() if os.path.exists(path) else ""
            if old in text:
                open(path, "w").write(text.replace(old, new))
                taken += 1
        if not taken:
            raise ValueError(f"edit {part}: none of its texts is in {csrc}")
    for f in ("minimizers.cu", "compacted_minimizers.cu"):
        path = os.path.join(out, f)
        text = open(path).read()
        if "_hash_blocks_per_sm" not in text:
            own = open(os.path.join(kernels.CSRC, f)).read()
            query = re.search(r'extern "C" int bk_\w+_hash_blocks_per_sm\(.*?'
                              r'\n}\n', own, re.S)
            open(path, "w").write(text + "\n" + query.group(0))
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
    out.ptxas = {label: next((v for k, v in regs.items() if part in k), None)
                 for label, part in PTXAS}
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
    in the latter's map) and KB4 -C -k 25 -w 37 -t (W = 13), each map a
    ``_phase1_like`` map of the chunk's own seeds; ``bounds.probe_rows``'
    slot rows of each."""
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


def sketch_cases(seq: bytes, dev):
    """(name, call, timer, entry point) of KS1-KS4 at chip_smoke.py's phase
    9e shapes on ``seq`` (one genome's first record): its canonical
    31-mers (KB1's emissions) for KS1 (p = 14, hashed), KS2 (m = 4096, -S
    -s and default, a new sketch a call and a full one: the sketch of the
    same stream, restored before each call) and KS4, its k = 31
    rolling-hash stream for KS3; then KB2 on the k = 31 W = 1 minimizers
    of its first 4M windows (the build's chunk)."""
    from ..core import bitops, hashes
    from ..core.rolling import RollingEncoder
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
    regs = torch.zeros(1 << 14, dtype=torch.int32, device=dev)
    span = (1 << 22) + 30
    em4 = enc.minimizers(codes[:, :span],
                         torch.tensor([min(span, codes.shape[1])],
                                      dtype=torch.int32, device=dev), 31, 1,
                         True)
    k4, m4 = em4.values[0], em4.mask[0]

    def fill():
        regs.zero_()
        hll.hll_fill(kmers, regs, 14, True)
        return [regs]

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

    return [
        ("hll_fill p=14 wang_hash", fill, graph_ms, "bk_hll_fill"),
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
        ("nuccount k=31", lambda: [bitops.nuccount(kmers, 31)], graph_ms,
         "bk_nuccount"),
    ]


def api_cases(seq: bytes, dev):
    """(name, call, timer, entry point) of the Python API's instantiations
    of KB1 and KB4 and of KR1 on ``seq``'s first 4M bases (a row) or its
    forward frame 0 as protein."""
    from ..core.alphabet import InputType, alphabet_of
    from ..core.rolling import RollingEncoder
    from ..core.spacer import Spacer
    from .synthetic import translate

    def row(s, it=InputType.DNA):
        codes = fastx.encode_contig(s, alphabet_of(it).lut)
        return (torch.from_numpy(codes[None, :]).to(dev),
                torch.tensor([codes.size], dtype=torch.int32, device=dev))

    dna = row(seq[: 1 << 22])
    prot = {it: row(translate(seq, 0), it) for it in (
        InputType.PROTEIN20, InputType.PROTEIN_14, InputType.PROTEIN_6)}
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
    for k, canon in ((31, True), (64, True), (200, False)):
        renc = RollingEncoder(k, canon)
        cases.append((f"cyclic_hashes k={k}{' canonical' if canon else ''}",
                      lambda renc=renc: renc.hashes(dna[0]), graph_ms,
                      "bk_cyclic_hashes"))
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
    fed by the tree's own kernels' outputs, and K1's inputs in both N
    channels (``sparse_inputs``)."""
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
    return [
        (f"encode_probe {shape}", lambda: pl.encode_probe(*a1), graph_ms),
        (f"encode_probe sparse {shape}",
         lambda: pl.encode_probe(*a1n, nidx=nidx), graph_ms,
         "bk_encode_probe_sparse"),
        (f"encode_probe -k 21 -S 0x16,1x4 B={hit.shape[0]}, P={lproc - 24}",
         lambda: pl.encode_probe(*a1s), graph_ms, "bk_encode_probe_spaced"),
        *probe_mix_cases(a1, own, rng, dev),
        (f"resolve {shape}",
         lambda: [rs.resolve(cidx, hit, clf.tax, clf._n_distinct)], graph_ms),
        *resolve_cases(clf, a1, own, genomes[0], dev),
        (f"step_outputs {shape}, maxr={clf.max_runs}",
         lambda: pl.step_outputs(taxon, oidx, hit, valid, valid1,
                                 clf.max_runs, ds), graph_ms),
    ], (a1, a1n, nidx)


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
               say=print) -> dict:
    """Libraries of ``names``.cu, built together: the parent's, an edited
    copy of the parent's for each of ``edits`` and, with ``change``, the
    tree's; with ``change`` (``--hash``) each with the hash occupancy
    queries, their blocks a SM and ptxas's registers and spills
    printed."""
    jobs = {"parent": (parent_csrc, None),
            **({"change": (kernels.CSRC, None)} if change else {}),
            **{e: (parent_csrc, e) for e in edits}}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {label: pool.submit(build_parent, csrc, names, label, edit,
                                   change)
                for label, (csrc, edit) in jobs.items()}
        libs = {label: f.result() for label, f in futs.items()}
    for label, lib in libs.items():
        if change:
            occ = {what: getattr(lib, fn)(*a) for what, fn, a in OCCUPANCY}
            say(f"# {label}: blocks a SM {occ}; ptxas {lib.ptxas}")
    return libs


USAGE = ("usage: python -m bonsai_tpu_torch.tools.kernel_ab PARENT_CSRC GENOME "
         "NODES\n       python -m bonsai_tpu_torch.tools.kernel_ab "
         "--sketch|--api PARENT_CSRC GENOME\n       python -m bonsai_tpu_torch.tools.kernel_ab "
         "--hash PARENT_CSRC GENOME [EDIT...]\n       python -m bonsai_tpu_torch.tools.kernel_ab "
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
    if mode == "--route" and edits:
        args = args[:args.index("-e")]
    for edit in (args[2:] if mode == "--hash" else edits):
        _edit_parts(edit)
    if ((mode in ("--classify", "--route") and len(args) < 5)
            or (mode in ("--sketch", "--api") and len(args) != 2)
            or (mode == "--hash" and len(args) < 2)
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
        cases, k1_in = classify_cases(*args[1:4], args[4:], dev)
        res = run({"parent": build_parent(args[0], CLASSIFY_SOURCES)}, cases)
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
        libs = build_libs(args[0], HASH_SOURCES, args[2:], change=True)
        kernels._lib = libs.pop("change")
        seq = next(iter(fastx.read_fastx(args[1])))[1]
        res = run(libs, hash_cases(seq, dev, np.random.default_rng(SEED)))
    elif mode:
        seq = next(iter(fastx.read_fastx(args[1])))[1]
        cases = (sketch_cases if mode == "--sketch" else api_cases)(seq, dev)
        res = run({"parent": build_parent(args[0], BUILD_SOURCES)}, cases)
    else:
        res = run({"parent": build_parent(args[0], BUILD_SOURCES)},
                  build_cases(*args[1:], dev))
    res["card"] = card
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
