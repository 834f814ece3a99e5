// Device-wide exclusive prefix sum, written for merge_fold.cu's
// compaction offsets, and the scratch carver of the build kernels
// (sort_unique.cu, merge_fold.cu).
//
// Tiles of 4096 elements are scanned by one block each (cub::BlockScan
// over 8 items a thread); the tile totals are scanned the same way,
// recursively, and added back.  Sums are int64 so that no offset wraps
// past 2^31.  The caller passes int64 scratch of scan_scratch_elems(n)
// elements; nothing is allocated here.  Everything sits in an anonymous
// namespace, so each source that includes this header owns its kernels.

#pragma once

#include <cstdint>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace bk {
namespace {

constexpr int kScanThreads = 512;
constexpr int kScanItems = 8;
constexpr int64_t kScanTile = (int64_t)kScanThreads * kScanItems;

template <typename T>
__global__ void scan_tiles(const T* in, int64_t n, int64_t* out,
                           int64_t* tile_sums) {
  using Scan = cub::BlockScan<int64_t, kScanThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int64_t base =
      (int64_t)blockIdx.x * kScanTile + (int64_t)threadIdx.x * kScanItems;
  int64_t v[kScanItems];
#pragma unroll
  for (int j = 0; j < kScanItems; ++j)
    v[j] = base + j < n ? (int64_t)in[base + j] : 0;
  int64_t total;
  Scan(tmp).ExclusiveSum(v, v, total);
  // every thread has read its own items before any writes: in may be out
#pragma unroll
  for (int j = 0; j < kScanItems; ++j)
    if (base + j < n) out[base + j] = v[j];
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

__global__ void add_tile_offsets(int64_t* out, int64_t n,
                                 const int64_t* tile_offs) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] += tile_offs[i / kScanTile];
}

inline int64_t scan_scratch_elems(int64_t n) {
  int64_t s = 1;
  while (n > kScanTile) {
    n = (n + kScanTile - 1) / kScanTile;
    s += n;
  }
  return s;
}

// out[i] = in[0] + ... + in[i-1] for i < n (out may alias in), and the
// sum of all n into *total.
template <typename T>
void exclusive_scan(const T* in, int64_t n, int64_t* out, int64_t* total,
                    int64_t* scratch, cudaStream_t s) {
  if (n <= kScanTile) {
    scan_tiles<T><<<1, kScanThreads, 0, s>>>(in, n, out, total);
    return;
  }
  const int64_t nt = (n + kScanTile - 1) / kScanTile;
  int64_t* sums = scratch;
  scan_tiles<T><<<(unsigned)nt, kScanThreads, 0, s>>>(in, n, out, sums);
  exclusive_scan<int64_t>(sums, nt, sums, total, scratch + nt, s);
  add_tile_offsets<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(out, n, sums);
}

// Carve aligned sub-buffers out of one scratch allocation.
struct Carve {
  char* p;
  int64_t used = 0;
  template <typename T>
  T* take(int64_t count) {
    T* r = p ? (T*)(p + used) : nullptr;
    used += (count * (int64_t)sizeof(T) + 255) / 256 * 256;
    return r;
  }
};

}  // namespace
}  // namespace bk
