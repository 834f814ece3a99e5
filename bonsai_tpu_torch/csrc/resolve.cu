// K2 resolve: per read, the taxon with the heaviest root path over its
// hits, ties to the LCA of the tied set, mapped to the original taxid.
//
// Replaces bonsai_tpu/classify/resolve.py resolve_batch (:57-131) with its
// blockwise (P > 1024) and dedup (P > 256, _resolve_dedup :134-187)
// branches, lca_device (:25-54), and the tax_ids[taxon_c] gather of the
// JAX classify step (classify/pipeline.py:465).  With Euler-interval
// labels the root-path weight of hit p is
//     score(p) = #{hits q : tin[q] <= tin[p] <= tout[q]},
// the tied set's LCA is LCA(argmin tin, argmax tin), and the LCA is
// binary lifting with the 0-identity rules (lca.cuh, shared with KB3
// merge_fold.cu).  Ties in tin (only the nodes of a parent cycle share the
// root's tin) go to the smaller key: the position under the dense and
// blockwise branches' rule, the compact index under the dedup branch's
// (``dedup``, set by the wrapper as resolve_batch chooses its branch).
// The branches give the same scores and tied set, so one kernel serves
// all three.
//
// What bounds it on an H100: the bytes of the read's (cidx, hit) row in
// and one taxon out (~0.001 ms for 8192 HiSeq reads), the tin/tout
// entries of each read's hit taxa and one LCA walk's entries, or the
// whole taxonomy arrays where they are fewer bytes; the compares of the
// d^2 pairs of a read's d distinct hit taxa weigh less (tools/bounds.py).
// What it waits on is latency: a dependent chain of row load, tin/tout
// gather and, for a read whose tied set holds two taxa, 2 x levels + 2
// lift/depth/parent loads, from HBM on a deep taxonomy.  The design keeps every read's chain short and has all
// reads of a batch in flight at once:
//   * rows of W <= 1024 take a warp each, four warps a block: 8192 HiSeq
//     reads fill the card's warp slots in one wave.  The warp reads its
//     row 32 positions a lane-load, four chunks at a time, so that their
//     row loads and then their tin/tout gathers are all in flight before
//     any is used; a ballot per chunk skips the misses, and
//     __match_any_sync folds equal compact indices of a chunk into their
//     first lane with a count (count-weighted scores equal the per-hit
//     sums, as the JAX dedup branch shows).  The chunk leaders go to a
//     per-warp slab in shared memory, in position order; lanes score the
//     leader pairs from it by broadcast reads, and 5 xor shuffles reduce
//     (score, tin-min, its key, tin-max, its key).  A read with no hit
//     writes 0 after its row loads.  One lane walks the LCA, and skips it
//     when the tied set is one taxon (a == b, the common case).
//   * longer rows take a 1024-thread block each: it streams its row in
//     1024-position q-tiles as the JAX blockwise branch does, compacts
//     each tile's chunk leaders by ballots and a block prefix into shared
//     memory, and scores only the p-tile's leaders against them; a p-tile
//     with no hit is skipped.  Shared memory stays at 16 KB for any W.
// By CUDA-graph replay on an H100 80GB HBM3 it takes ~0.0037 ms on 8192
// HiSeq reads against the ec table (a quarter of its bound; the one-block-
// a-read design it replaced took 0.027), ~0.019 ms on a 2^21-node
// taxonomy where every read walks a 6-level LCA (its dependent loads are
// what remain), and ~0.053 ms on 64 reads of ~4000 positions.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lca.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;         // warps (reads) a block, W <= kWarpMaxW
constexpr int kWarpMaxW = 1024;   // widest row a warp takes
constexpr int kBlock = 1024;      // threads a read, W > kWarpMaxW

struct Best {
  int score;  // -1: no hit yet
  int tmin, kmin, tmax, kmax;  // tin extremes and their smallest keys
};

__device__ __forceinline__ Best none() {
  return Best{-1, INT_MAX, INT_MAX, INT_MIN, INT_MAX};
}

__device__ __forceinline__ void take(Best& a, const Best& b) {
  if (b.score > a.score) {
    a = b;
    return;
  }
  if (b.score != a.score || b.score < 0) return;
  if (b.tmin < a.tmin || (b.tmin == a.tmin && b.kmin < a.kmin)) {
    a.tmin = b.tmin;
    a.kmin = b.kmin;
  }
  if (b.tmax > a.tmax || (b.tmax == a.tmax && b.kmax < a.kmax)) {
    a.tmax = b.tmax;
    a.kmax = b.kmax;
  }
}

// take() is commutative and associative, so every lane ends with the
// warp's best
__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    Best o;
    o.score = __shfl_xor_sync(kFull, b.score, m);
    o.tmin = __shfl_xor_sync(kFull, b.tmin, m);
    o.kmin = __shfl_xor_sync(kFull, b.kmin, m);
    o.tmax = __shfl_xor_sync(kFull, b.tmax, m);
    o.kmax = __shfl_xor_sync(kFull, b.kmax, m);
    take(b, o);
  }
  return b;
}

// The resolved taxid of a read from its tied set's tin extremes: their
// LCA, not walked when they are one taxon (lca(a, a) = a, lca(0, 0) = 0).
__device__ __forceinline__ uint32_t resolved(
    int32_t a, int32_t b, const int32_t* __restrict__ depth,
    const int32_t* __restrict__ parent, const int32_t* __restrict__ lift,
    int levels, int32_t n, const uint32_t* __restrict__ tax_ids) {
  const int32_t res =
      a == b ? a : bk::lca_compact(a, b, depth, parent, lift, levels, n);
  return tax_ids[res];
}

__global__ void __launch_bounds__(kWarps * 32) resolve_warp(
    const int32_t* __restrict__ cidx, const bool* __restrict__ hit, int64_t R,
    int W, const int32_t* __restrict__ tin, const int32_t* __restrict__ tout,
    const int32_t* __restrict__ depth, const int32_t* __restrict__ parent,
    const int32_t* __restrict__ lift, int levels, int32_t n,
    const uint32_t* __restrict__ tax_ids, uint32_t* __restrict__ taxon,
    int dedup) {
  extern __shared__ int4 slabs[];  // kWarps x W of (tin, tout, count, cidx)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarps + warp;
  if (r >= R) return;
  int4* slab = slabs + warp * W;
  const int32_t* crow = cidx + r * W;
  const bool* hrow = hit + r * W;
  const unsigned below = (1u << lane) - 1;
  int h = 0;  // chunk leaders so far, the same in every lane
  for (int base = 0; base < W; base += 128) {
    bool hp[4];
    int32_t c[4], ti[4], to[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = base + 32 * u + lane;
      hp[u] = p < W && hrow[p];
      c[u] = p < W ? crow[p] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ti[u] = hp[u] ? tin[c[u]] : 0;
      to[u] = hp[u] ? tout[c[u]] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned hm = __ballot_sync(kFull, hp[u]);
      if (!hm) continue;
      // misses hold -1, which no compact index equals
      const unsigned grp = __match_any_sync(kFull, hp[u] ? c[u] : -1);
      const bool lead = hp[u] && (grp & below) == 0;
      const unsigned lm = __ballot_sync(kFull, lead);
      if (lead)
        slab[h + __popc(lm & below)] =
            make_int4(ti[u], to[u], __popc(grp), c[u]);
      h += __popc(lm);
    }
  }
  if (h == 0) {  // no position of the read hit
    if (lane == 0) taxon[r] = 0u;
    return;
  }
  __syncwarp();
  Best mine = none();
  for (int i = lane; i < h; i += 32) {
    const int4 e = slab[i];
    int score = 0;
    for (int j = 0; j < h; ++j) {
      const int4 q = slab[j];
      score += (q.x <= e.x && e.x <= q.y) ? q.z : 0;
    }
    // the dense rule's key: the leader's rank, which is in position order
    const int key = dedup ? e.w : i;
    take(mine, Best{score, e.x, key, e.x, key});
  }
  const Best best = warp_best(mine);
  if (lane != 0) return;
  taxon[r] = resolved(dedup ? best.kmin : slab[best.kmin].w,
                      dedup ? best.kmax : slab[best.kmax].w, depth, parent,
                      lift, levels, n, tax_ids);
}

__global__ void __launch_bounds__(kBlock) resolve_block(
    const int32_t* __restrict__ cidx, const bool* __restrict__ hit, int64_t W,
    const int32_t* __restrict__ tin, const int32_t* __restrict__ tout,
    const int32_t* __restrict__ depth, const int32_t* __restrict__ parent,
    const int32_t* __restrict__ lift, int levels, int32_t n,
    const uint32_t* __restrict__ tax_ids, uint32_t* __restrict__ taxon,
    int dedup) {
  __shared__ int4 s_q[kBlock];  // a q-tile's leaders: (tin, tout, count)
  __shared__ int s_cnt[kBlock / 32];
  __shared__ Best s_best[kBlock / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int64_t r = blockIdx.x;
  const int32_t* crow = cidx + r * W;
  const bool* hrow = hit + r * W;
  Best mine = none();
  for (int64_t p0 = 0; p0 < W; p0 += kBlock) {
    const int64_t p = p0 + threadIdx.x;
    const bool hp = p < W && hrow[p];
    const int32_t cp = p < W ? crow[p] : 0;
    const int32_t tp = hp ? tin[cp] : 0;
    // a position scores only as the first lane of its taxon in its chunk;
    // every lane takes part in the match, hit or not
    const unsigned pg = __match_any_sync(kFull, hp ? cp : -1);
    const bool lead = hp && (pg & below) == 0;
    if (!__syncthreads_or(lead)) continue;  // a p-tile without a hit
    int score = 0;
    for (int64_t q0 = 0; q0 < W; q0 += kBlock) {
      const int64_t q = q0 + threadIdx.x;
      const bool hq = q < W && hrow[q];
      const int32_t cq = q < W ? crow[q] : 0;
      const int32_t ti = hq ? tin[cq] : 0, to = hq ? tout[cq] : 0;
      const unsigned grp = __match_any_sync(kFull, hq ? cq : -1);
      const bool ql = hq && (grp & below) == 0;
      const unsigned lm = __ballot_sync(kFull, ql);
      if (lane == 0) s_cnt[warp] = __popc(lm);
      __syncthreads();
      int base = 0, nq = 0;
#pragma unroll
      for (int w = 0; w < kBlock / 32; ++w) {
        const int k = s_cnt[w];
        base += w < warp ? k : 0;
        nq += k;
      }
      if (ql) s_q[base + __popc(lm & below)] = make_int4(ti, to, __popc(grp), 0);
      __syncthreads();
      if (lead)
        for (int j = 0; j < nq; ++j) {
          const int4 e = s_q[j];
          score += (e.x <= tp && tp <= e.y) ? e.z : 0;
        }
      __syncthreads();  // s_q and s_cnt are rewritten by the next tile
    }
    if (lead) {
      const int key = dedup ? cp : (int)p;
      take(mine, Best{score, tp, key, tp, key});
    }
  }
  mine = warp_best(mine);
  if (lane == 0) s_best[warp] = mine;
  __syncthreads();
  if (warp != 0) return;
  const Best best = warp_best(s_best[lane]);
  if (lane != 0) return;
  if (best.score < 0) {  // no position of the read hit
    taxon[r] = 0u;
    return;
  }
  taxon[r] = resolved(dedup ? best.kmin : crow[best.kmin],
                      dedup ? best.kmax : crow[best.kmax], depth, parent,
                      lift, levels, n, tax_ids);
}

}  // namespace

extern "C" int bk_resolve(const void* cidx, const void* hit, int64_t R,
                          int64_t W, const void* tin, const void* tout,
                          const void* depth, const void* parent,
                          const void* lift, int levels, int n,
                          const void* tax_ids, void* taxon, int dedup,
                          void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (W <= kWarpMaxW) {
    const size_t smem = (size_t)kWarps * W * sizeof(int4);
    // raised once, to the widest row's slabs (64 KB), so that a launch
    // only passes its size
    static const cudaError_t raised = cudaFuncSetAttribute(
        resolve_warp, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWarps * kWarpMaxW * (int)sizeof(int4));
    if (raised != cudaSuccess) return (int)raised;
    resolve_warp<<<(unsigned)((R + kWarps - 1) / kWarps), kWarps * 32, smem,
                   s>>>(
        (const int32_t*)cidx, (const bool*)hit, R, (int)W, (const int32_t*)tin,
        (const int32_t*)tout, (const int32_t*)depth, (const int32_t*)parent,
        (const int32_t*)lift, levels, n, (const uint32_t*)tax_ids,
        (uint32_t*)taxon, dedup);
  } else {
    resolve_block<<<(unsigned)R, kBlock, 0, s>>>(
        (const int32_t*)cidx, (const bool*)hit, W, (const int32_t*)tin,
        (const int32_t*)tout, (const int32_t*)depth, (const int32_t*)parent,
        (const int32_t*)lift, levels, n, (const uint32_t*)tax_ids,
        (uint32_t*)taxon, dedup);
  }
  return (int)cudaGetLastError();
}
