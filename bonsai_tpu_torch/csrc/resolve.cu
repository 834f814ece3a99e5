// K2 resolve: per read, the taxon with the heaviest root path over its
// hits, ties to the LCA of the tied set, mapped to the original taxid.
//
// Replaces bonsai_tpu/classify/resolve.py resolve_batch (:57-131) with its
// blockwise (P > 1024) and dedup (P > 256, _resolve_dedup :134-187)
// branches, lca_device (:25-54), and the tax_ids[taxon_c] gather of the
// JAX classify step (classify/pipeline.py:465).  With Euler-interval
// labels the root-path weight of hit p is
//     score(p) = #{hits q : tin[q] <= tin[p] <= tout[q]},
// the tied set's LCA is LCA(first argmin tin, first argmax tin), and the
// LCA is binary lifting with the 0-identity rules (lca.cuh, shared with
// KB3 merge_fold.cu).  The dedup branch gives
// the same scores and tied set, so this one kernel serves all three.
//
// What bounds it on an H100: the bytes of the read's (cidx, hit) row in
// and one taxon out, ~0.0009 ms for 8192 HiSeq reads; the compares of the
// hit pairs (h^2 a read of h hits, few for HiSeq reads on the ec table)
// bound it less.  The design: one block per read; each thread owns
// positions p, and the q axis streams through shared memory one
// block-width tile at a time, so any W fits in 1 KB of shared memory;
// each thread keeps its best (score, tin-min, tin-max with their first
// positions), then one block reduction and one thread's LCA.  It compares
// all W^2 pairs whether they hit or not, reduces a 24-byte struct in 7
// __syncthreads steps and walks the LCA in one thread, and takes ~0.027
// ms there (3% of its bound, CUDA-graph replay on an H100 80GB HBM3).

#include <cstdint>
#include <cuda_runtime.h>

#include "lca.cuh"

namespace {

constexpr int kThreads = 128;

struct Best {
  int score;          // -1: no hit yet
  int32_t tmin, tmax;
  int64_t pmin, pmax;  // first position holding tmin / tmax
};

__device__ __forceinline__ void merge(Best& a, const Best& b) {
  if (b.score > a.score) {
    a = b;
  } else if (b.score == a.score && b.score >= 0) {
    if (b.tmin < a.tmin || (b.tmin == a.tmin && b.pmin < a.pmin)) {
      a.tmin = b.tmin;
      a.pmin = b.pmin;
    }
    if (b.tmax > a.tmax || (b.tmax == a.tmax && b.pmax < a.pmax)) {
      a.tmax = b.tmax;
      a.pmax = b.pmax;
    }
  }
}

__global__ void resolve_kernel(
    const int32_t* __restrict__ cidx, const bool* __restrict__ hit, int64_t W,
    const int32_t* __restrict__ tin, const int32_t* __restrict__ tout,
    const int32_t* __restrict__ depth, const int32_t* __restrict__ parent,
    const int32_t* __restrict__ lift, int levels, int32_t n,
    const uint32_t* __restrict__ tax_ids, uint32_t* __restrict__ taxon) {
  __shared__ int32_t s_in[kThreads];
  __shared__ int32_t s_out[kThreads];
  __shared__ Best s_best[kThreads];
  const int64_t r = blockIdx.x;
  const int32_t* crow = cidx + r * W;
  const bool* hrow = hit + r * W;
  const int32_t big = n + 2;

  Best mine{-1, big, -1, 0, 0};
  for (int64_t p0 = 0; p0 < W; p0 += kThreads) {
    const int64_t p = p0 + threadIdx.x;
    const bool hp = p < W && hrow[p];
    const int32_t tp = hp ? tin[crow[p]] : big;
    int score = 0;
    for (int64_t q0 = 0; q0 < W; q0 += kThreads) {
      const int64_t q = q0 + threadIdx.x;
      __syncthreads();
      const bool hq = q < W && hrow[q];
      const int32_t cq = hq ? crow[q] : 0;
      s_in[threadIdx.x] = hq ? tin[cq] : big;
      s_out[threadIdx.x] = hq ? tout[cq] : -2;
      __syncthreads();
      const int nq = (int)(W - q0 < kThreads ? W - q0 : kThreads);
      for (int j = 0; j < nq; ++j)
        score += (s_in[j] <= tp) & (tp <= s_out[j]);
    }
    if (hp) {
      // positions of one thread arrive in increasing order: strict
      // compares keep the first position of each extreme
      if (score > mine.score) {
        mine = Best{score, tp, tp, p, p};
      } else if (score == mine.score) {
        if (tp < mine.tmin) { mine.tmin = tp; mine.pmin = p; }
        if (tp > mine.tmax) { mine.tmax = tp; mine.pmax = p; }
      }
    }
  }
  s_best[threadIdx.x] = mine;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      Best a = s_best[threadIdx.x];
      merge(a, s_best[threadIdx.x + s]);
      s_best[threadIdx.x] = a;
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const Best best = s_best[0];
  if (best.score < 0) {  // no position of the read hit
    taxon[r] = 0u;
    return;
  }
  const int32_t res = bk::lca_compact(crow[best.pmin], crow[best.pmax], depth,
                                      parent, lift, levels, n);
  taxon[r] = tax_ids[res];
}

}  // namespace

extern "C" int bk_resolve(const void* cidx, const void* hit, int64_t R,
                          int64_t W, const void* tin, const void* tout,
                          const void* depth, const void* parent,
                          const void* lift, int levels, int n,
                          const void* tax_ids, void* taxon, void* stream) {
  resolve_kernel<<<(unsigned)R, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cidx, (const bool*)hit, W, (const int32_t*)tin,
      (const int32_t*)tout, (const int32_t*)depth, (const int32_t*)parent,
      (const int32_t*)lift, levels, n, (const uint32_t*)tax_ids,
      (uint32_t*)taxon);
  return (int)cudaGetLastError();
}
