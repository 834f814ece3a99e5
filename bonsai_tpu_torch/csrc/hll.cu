// KS1 hll_fill: the HyperLogLog register fill of a batch of 64-bit keys,
// optionally hashed first with wang_hash (HyperLogLog.addh).
//
// Replaces bonsai_tpu/sketch/hll.py HyperLogLog.add_hashes (:37-59) with
// addh's wang_hash (:61-65, core/hashes.py:58): register index h >> q,
// rho = clz(h << p) + 1 (q + 1 where h << p == 0), q = 64 - p, the
// register's max taken with np.maximum.at there.
//
// The registers live on the card as u32 (atomicMax has no byte form) and
// become u8 when they are fetched.  Two paths:
//   * p <= 16: each block keeps its own copy of the registers as bytes in
//     shared memory (at most 64 KiB), four to a 32-bit word, raised with a
//     compare-and-swap only where the new rho is larger, then flushes the
//     nonzero ones into the card's registers with atomicMax where they are
//     larger.  A block takes about 2 x 2^p keys, so the flush costs about
//     what the fill does;
//   * p > 16 (up to 30): atomicMax on the card's registers where the rho
//     is larger than the register read.
// What bounds it on an H100: the keys' bytes (8 B a key) and, for large p,
// the registers' 4 B each; the fill is a few integer operations a key.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitmix.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSharedP = 16;  // 2^16 byte registers = 64 KiB

template <bool kWang>
__device__ __forceinline__ void index_rho(uint64_t key, int p,
                                          uint32_t* idx, uint32_t* rho) {
  const uint64_t h = kWang ? bk::wang_hash(key) : key;
  const int q = 64 - p;
  *idx = (uint32_t)(h >> q);
  const uint64_t w = h << p;
  *rho = w ? (uint32_t)__clzll((long long)w) + 1u : (uint32_t)q + 1u;
}

template <bool kWang>
__global__ void __launch_bounds__(kThreads)
    hll_fill_shared(const uint64_t* __restrict__ keys, int64_t n, int p,
                    uint32_t* __restrict__ regs) {
  extern __shared__ uint32_t s[];  // 2^p byte registers, 4 a word
  const int m = 1 << p;
  const int words = (m + 3) / 4;
  for (int i = threadIdx.x; i < words; i += kThreads) s[i] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    uint32_t idx, rho;
    index_rho<kWang>(keys[i], p, &idx, &rho);
    uint32_t* word = s + (idx >> 2);
    const int sh = 8 * (idx & 3);
    uint32_t old = *(volatile uint32_t*)word;
    while (((old >> sh) & 0xFFu) < rho) {
      const uint32_t nw = (old & ~(0xFFu << sh)) | (rho << sh);
      const uint32_t prev = atomicCAS(word, old, nw);
      if (prev == old) break;
      old = prev;
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < m; r += kThreads) {
    const uint32_t v = (s[r >> 2] >> (8 * (r & 3))) & 0xFFu;
    if (v && v > __ldcg(regs + r)) atomicMax(regs + r, v);
  }
}

template <bool kWang>
__global__ void __launch_bounds__(kThreads)
    hll_fill_global(const uint64_t* __restrict__ keys, int64_t n, int p,
                    uint32_t* __restrict__ regs) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    uint32_t idx, rho;
    index_rho<kWang>(keys[i], p, &idx, &rho);
    if (rho > __ldcg(regs + idx)) atomicMax(regs + idx, rho);
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <bool kWang>
cudaError_t fill(const uint64_t* keys, int64_t n, int p, uint32_t* regs,
                 cudaStream_t s) {
  const int64_t sms = sm_count();
  if (p > kMaxSharedP) {
    int64_t g = (n + kThreads - 1) / kThreads;
    g = g < sms * 16 ? g : sms * 16;
    hll_fill_global<kWang><<<(unsigned)g, kThreads, 0, s>>>(keys, n, p, regs);
    return cudaGetLastError();
  }
  static bool raised = false;  // the 64 KiB of p = 16, once
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        hll_fill_shared<kWang>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        1 << kMaxSharedP);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const int64_t m = 1ll << p;
  int64_t g = (n + 2 * m - 1) / (2 * m);  // ~2 x 2^p keys a block
  g = g < 1 ? 1 : (g > sms * 4 ? sms * 4 : g);
  const size_t smem = (size_t)((m + 3) / 4) * 4;
  hll_fill_shared<kWang><<<(unsigned)g, kThreads, smem, s>>>(keys, n, p,
                                                             regs);
  return cudaGetLastError();
}

}  // namespace

// keys (n,) int64-held u64 -> registers (2^p,) u32 raised to each key's
// rho; wang: hash the keys with wang_hash first.
extern "C" int bk_hll_fill(const void* keys, int64_t n, int p, int wang,
                           void* regs, void* stream) {
  if (n < 0 || p < 4 || p > 30) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const uint64_t* k = (const uint64_t*)keys;
  uint32_t* r = (uint32_t*)regs;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(wang ? fill<true>(k, n, p, r, s) : fill<false>(k, n, p, r, s));
}
