// KS1 hll_fill: the HyperLogLog register fill of a batch of 64-bit keys,
// optionally hashed first with wang_hash (HyperLogLog.addh).
//
// Replaces bonsai_tpu/sketch/hll.py HyperLogLog.add_hashes (:37-59) with
// addh's wang_hash (:61-65, core/hashes.py:58): register index h >> q,
// rho = clz(h << p) + 1 (q + 1 where h << p == 0), q = 64 - p, the
// register's max taken with np.maximum.at there.
//
// The registers live on the card as u32 and become u8 when they are
// fetched.  Both paths read the keys as 16-B pairs, a few pairs of a
// thread loaded before any is used (a key before the first 16-B boundary,
// as in a slice x[1:], and an odd last key go to block 0's first
// threads), on a grid sized from the card, not from n:
//   * the shared path (p <= kMaxSharedP, and n >= kGlobalBelow x 2^p):
//     each block of kSharedThreads holds a u32 copy of the registers in
//     shared memory, zeroes it, raises it with the native shared
//     atomicMax (no compare-and-swap), then flushes it by 16-B words: a
//     word's registers are read from the card (L2) where any is nonzero,
//     and raised by atomicMax where the copy's is larger.  As many blocks
//     as the card holds at once (2 a SM up to p = 14, 1 at p = 15), fewer
//     where n < 2^p x that;
//   * the global path (the rest): atomicMax on the card's registers where
//     the rho is larger than the register read, an L2 read a key.
// Measured on an H100 (PERF.md row 21, kernel_ab --sketch and its edits):
// K-12's 4.55M 31-mers at p = 14 take 0.0199 ms (the parent's byte copies
// raised by compare-and-swap, a block a ~2 x 2^p keys: 0.0575).  Blocks of
// 1024 threads spread the flush (0.0345 ms at 256); the global path is
// faster below 32 x 2^p keys and past p = 15 (p = 16: 0.058 ms against
// 0.076 for byte copies); a thread-block cluster splitting one copy, each
// key's raise sent to its register's block through distributed shared
// memory, is slower: the remote atomics cost more than the flushes they
// save (C = 8 at p = 14: 0.0736 ms; kernel_ab -e ks1-c8).
// What bounds it on an H100: the keys' bytes (8 B a key) and its integer
// operations (wang_hash, the index, rho), about equal at K-12's shape.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitmix.cuh"

namespace {

constexpr int kThreads = 256;         // the global path's blocks
constexpr int kGlobalPairs = 2;       // its 16-B key pairs a thread a turn
constexpr int kGlobalBlocksPerSm = 8;
constexpr int kSharedThreads = 1024;  // the shared path's blocks
constexpr int kPairs = 2;             // its 16-B key pairs a thread a turn
constexpr int kMaxSharedP = 15;       // 4 x 2^p B of shared memory a block
constexpr int kGlobalBelow = 32;      // global where n < this x 2^p
constexpr int kMaxDevices = 64;

template <bool kWang>
__device__ __forceinline__ void index_rho(uint64_t key, int p,
                                          uint32_t* idx, uint32_t* rho) {
  const uint64_t h = kWang ? bk::wang_hash(key) : key;
  const int q = 64 - p;
  *idx = (uint32_t)(h >> q);
  const uint64_t w = h << p;
  *rho = w ? (uint32_t)__clzll((long long)w) + 1u : (uint32_t)q + 1u;
}

// f(key) for each of the grid's keys (blocks of kT threads): 16-B pairs
// from the first 16-B boundary, kP of a thread loaded before any is used;
// the key before that boundary and an odd last key by block 0's threads 0
// and 1
template <int kT, int kP, typename F>
__device__ __forceinline__ void for_each_key(const uint64_t* keys, int64_t n,
                                             F&& f) {
  const int64_t head = ((uintptr_t)keys & 15) ? 1 : 0;
  const int64_t pairs = (n - head) / 2;
  const int64_t tail = head + 2 * pairs;
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0 && head) f(keys[0]);
    if (threadIdx.x == 1 && tail < n) f(keys[tail]);
  }
  const ulonglong2* p2 = (const ulonglong2*)(keys + head);
  const int64_t step = (int64_t)gridDim.x * kT * kP;
  for (int64_t base = (int64_t)blockIdx.x * kT * kP + threadIdx.x;
       base < pairs; base += step) {
    ulonglong2 v[kP];
#pragma unroll
    for (int r = 0; r < kP; ++r) {
      const int64_t i = base + (int64_t)r * kT;
      v[r] = i < pairs ? __ldg(p2 + i) : make_ulonglong2(0, 0);
    }
#pragma unroll
    for (int r = 0; r < kP; ++r) {
      if (base + (int64_t)r * kT < pairs) {
        f(v[r].x);
        f(v[r].y);
      }
    }
  }
}

// the card's registers m[0..3] raised to v's lanes where larger, g being
// what they held when read (a register only grows)
__device__ __forceinline__ void raise4(uint32_t* m, uint4 v, uint4 g) {
  if (v.x > g.x) atomicMax(m, v.x);
  if (v.y > g.y) atomicMax(m + 1, v.y);
  if (v.z > g.z) atomicMax(m + 2, v.z);
  if (v.w > g.w) atomicMax(m + 3, v.w);
}

// the block's copy of the 2^p registers, u32 in shared memory: zeroed,
// raised, then flushed into the card's by 16-B words
template <bool kWang>
__global__ void __launch_bounds__(kSharedThreads)
    hll_fill_shared(const uint64_t* __restrict__ keys, int64_t n, int p,
                    uint32_t* __restrict__ regs) {
  extern __shared__ uint4 s4[];
  uint32_t* s = (uint32_t*)s4;
  const int words = 1 << (p - 2);
  for (int i = threadIdx.x; i < words; i += kSharedThreads)
    s4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for_each_key<kSharedThreads, kPairs>(keys, n, [&](uint64_t key) {
    uint32_t idx, rho;
    index_rho<kWang>(key, p, &idx, &rho);
    atomicMax(s + idx, rho);
  });
  __syncthreads();
  const uint4* g4 = (const uint4*)regs;
  for (int i = threadIdx.x; i < words; i += kSharedThreads) {
    const uint4 v = s4[i];
    if (v.x | v.y | v.z | v.w) raise4(regs + 4 * i, v, __ldcg(g4 + i));
  }
}

template <bool kWang>
__global__ void __launch_bounds__(kThreads)
    hll_fill_global(const uint64_t* __restrict__ keys, int64_t n, int p,
                    uint32_t* __restrict__ regs) {
  for_each_key<kThreads, kGlobalPairs>(keys, n, [&](uint64_t key) {
    uint32_t idx, rho;
    index_rho<kWang>(key, p, &idx, &rho);
    if (rho > __ldcg(regs + idx)) atomicMax(regs + idx, rho);
  });
}

int sm_count(int dev) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <bool kWang>
cudaError_t fill_shared(const uint64_t* keys, int64_t n, int p,
                        uint32_t* regs, cudaStream_t s, int dev) {
  // the kernel's shared memory once a device, its blocks in flight once a
  // (device, p): host calls, made before any graph captures a launch
  static bool ready[kMaxDevices];
  static int active[kMaxDevices][kMaxSharedP + 1];
  const auto kernel = hll_fill_shared<kWang>;
  const size_t smem = (size_t)4 << p;
  cudaError_t e;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             4 << kMaxSharedP);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  if (!active[dev][p]) {
    int got = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, kernel,
                                                      kSharedThreads, smem);
    if (e != cudaSuccess) return e;
    if (got < 1) return cudaErrorInvalidConfiguration;
    active[dev][p] = got * sm_count(dev);
  }
  const int64_t copies = (n + (1ll << p) - 1) >> p;  // 2^p keys a copy
  const int64_t blocks = copies < active[dev][p] ? copies : active[dev][p];
  hll_fill_shared<kWang><<<(unsigned)blocks, kSharedThreads, smem, s>>>(
      keys, n, p, regs);
  return cudaGetLastError();
}

template <bool kWang>
cudaError_t fill(const uint64_t* keys, int64_t n, int p, uint32_t* regs,
                 cudaStream_t s) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (p <= kMaxSharedP && n >= ((int64_t)kGlobalBelow << p))
    return fill_shared<kWang>(keys, n, p, regs, s, dev);
  const int64_t per = (int64_t)kThreads * kGlobalPairs * 2;  // a block a turn
  int64_t g = (n + per - 1) / per;
  const int64_t cap = (int64_t)sm_count(dev) * kGlobalBlocksPerSm;
  g = g < cap ? g : cap;
  hll_fill_global<kWang><<<(unsigned)g, kThreads, 0, s>>>(keys, n, p, regs);
  return cudaGetLastError();
}

}  // namespace

// keys (n,) int64-held u64, 8-B aligned -> registers (2^p,) u32, 16-B
// aligned, raised to each key's rho; wang: hash the keys with wang_hash
// first.
extern "C" int bk_hll_fill(const void* keys, int64_t n, int p, int wang,
                           void* regs, void* stream) {
  if (n < 0 || p < 4 || p > 30 || (uintptr_t)keys % 8 || (uintptr_t)regs % 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const uint64_t* k = (const uint64_t*)keys;
  uint32_t* r = (uint32_t*)regs;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(wang ? fill<true>(k, n, p, r, s) : fill<false>(k, n, p, r, s));
}
