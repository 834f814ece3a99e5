// Decoupled look-back over per-tile counts, and the scratch carver, shared
// by the build kernels KB2 (sort_unique.cu) and KB3 (merge_fold.cu); KS3
// (sort_unique.cu) uses the status words with a warp-wide walk.
//
// A tile's status word is 2 flag bits (aggregate, inclusive prefix) and a
// 30-bit count, so one call counts fewer than 2^30 entries.  A word carries
// its whole message and nothing else is published beside it, so it is
// stored with st.release.gpu and read with relaxed loads, kWindow earlier
// tiles at a time, all in flight together: acquire loads would be ordered
// one after another, and the first wave of blocks all reach the look-back
// at once (a walk of one acquire load a round trip was a third of a KB2
// pass's time; an acquire fence after the walk cost 4-7% of a KB2 call on
// an H100).  A tile that finds an earlier word still empty sleeps
// kBackoffNs before it reads again, so that spinning blocks do not crowd
// out the blocks they wait on (without it, one KB2 configuration of 4
// blocks an SM ran 10x slower).  Tile ids must come from an atomic counter,
// not blockIdx, so that every tile a block waits on belongs to a block that
// already runs: the look-back cannot deadlock.  Status words start at 0
// (not published) on every call.  Everything sits in an anonymous
// namespace, so each source that includes this header owns its copy.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bk {
namespace {

constexpr int kWindow = 8;      // status words a look-back step reads
constexpr int kBackoffNs = 50;  // sleep before reading an empty word again
constexpr uint32_t kAggregate = 1u << 30;  // status: this tile's count
constexpr uint32_t kPrefix = 2u << 30;     // status: count of tiles <= this
constexpr uint32_t kCount = kAggregate - 1;
constexpr int64_t kMaxCount = 1 << 30;     // counts of one call stay below

__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Status words: one per tile at status[tile * stride].  A tile publishes
// its own count first, as soon as it knows it (tile 0's is already its
// inclusive prefix) ...
__device__ __forceinline__ void publish(uint32_t* status, int64_t tile,
                                        int64_t stride, uint32_t count) {
  store_release(status + tile * stride,
                (tile == 0 ? kPrefix : kAggregate) | count);
}

// ... then sums the earlier tiles' words back to the first inclusive
// prefix, kWindow words a round trip, reading again from a tile that has
// published nothing yet, and publishes its own inclusive prefix.  Returns
// the count of all earlier tiles.
__device__ __forceinline__ uint32_t look_back(uint32_t* status, int64_t tile,
                                              int64_t stride, uint32_t count) {
  if (tile == 0) return 0;
  uint32_t sum = 0;
  int64_t j = tile - 1;  // the next tile to add; -1 once a prefix is added
  while (j >= 0) {
    uint32_t v[kWindow];
#pragma unroll
    for (int q = 0; q < kWindow; ++q)
      v[q] = j - q >= 0 ? load_relaxed(status + (j - q) * stride) : kPrefix;
    bool stop = false;
#pragma unroll
    for (int q = 0; q < kWindow; ++q)
      if (!stop) {
        if (v[q] == 0) {
          stop = true;  // not published yet: read again from tile j
          __nanosleep(kBackoffNs);
        } else {
          sum += v[q] & kCount;
          --j;
          if (v[q] & kPrefix) stop = true, j = -1;
        }
      }
  }
  store_release(status + tile * stride, kPrefix | (sum + count));
  return sum;
}

// Carve aligned sub-buffers out of one scratch allocation; with a null
// base it only counts the bytes.
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
