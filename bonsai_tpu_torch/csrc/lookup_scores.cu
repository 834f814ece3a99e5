// KB5 lookup_scores: the score::Hash score of each k-mer, its packed value
// in the phase-1 table, or U64_MAX where phase 1 lacks it.
//
// Replaces the device path of bonsai_tpu/db/table.py ScoreMap.lookup_scores
// (:501) -> KmerTable.probe_device (:350) -> probe_slots_device (:370),
// with the where(found, val, U64_MAX) of :508.
//
// What bounds it on an H100: the slot rows, one random 32-B row per k-mer
// that sits in its first bucket and two per other k-mer, from a phase-1
// image of 128 MiB on the ec corpus (2.6x the 50 MB L2), plus 8 B in and
// 8 B out a k-mer and the values it reads.  The design is the simplest
// that keeps many probes in flight: one thread a k-mer, 256 a block, the
// probe of probe.cuh (two dependent 16-B loads a row, the second row only
// on a miss in the first); the card's resident threads are the memory-level
// parallelism.  Batching a thread's probes to overlap their rows is left
// for a later design.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    lookup_scores_kernel(const uint64_t* __restrict__ kmers, int64_t n,
                         bk::ProbeTable t, uint64_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = bk::hash_score(t, kmers[i]);
}

}  // namespace

// kmers (n,) int64-held u64 -> out (n,) scores; the image as
// db/table.py ProbeArrays.args gives it: slots (nb, 4), lgnb, vbits, vals,
// n_vals, inline.  n >= 1.
extern "C" int bk_lookup_scores(const void* kmers, int64_t n,
                                const void* slots, int lgnb, int vbits,
                                const void* vals, int64_t n_vals,
                                int is_inline, void* out, void* stream) {
  if (n <= 0 || n_vals <= 0) return (int)cudaErrorInvalidValue;
  const bk::ProbeTable t{(const ulonglong2*)slots, (const uint64_t*)vals,
                         n_vals, lgnb, vbits, is_inline};
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  lookup_scores_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>((const uint64_t*)kmers, n, t,
                                                 (uint64_t*)out);
  return (int)cudaGetLastError();
}
