// KB1 minimizers: contiguous DNA k-mers of a batch of rows, canonical or
// not, and for windows of W > 1 k-mers the lex minimizer of each window.
//
// Replaces the device path of bonsai_tpu/core/encoder.py
// BatchEncoder.emissions on its unwindowed branch (:141-153) and its
// canonical windowed lex branch (:174-184), with what they call:
// encode._pack_contig_fast (:66), apply_mask (:163), position_validity
// (:141), bitops.canonical (:52), hashes.frev64 (:39) and
// minimize.sliding_min / positional_minimizers (:41,65).  Per slot j of
// row b, with n_push = max(len - (k - 1), 0):
//   W = 1: value = canonical or raw k-mer at j (an N reads as code 0),
//          emitted = j < n_push and the window holds no N;
//   W > 1: every position pushes ck = N window ? 0 : canonical k-mer,
//          scored frev64(ck); value = ck of the unsigned (score, ck)
//          minimum over positions [j, j + W - 1], emitted = j + W <= n_push.
// The first base sits in the k-mer's high bits; all compares are unsigned
// over 64 bits; a value is never a sentinel (the emitted flag says it).
//
// What bounds it on an H100: the output (9 B a slot) and the codes (1 B
// a base); the work is k shift-ors and, with W > 1, W compares a slot.
// The design: one block of 256 threads owns 256 consecutive slots of a
// row; it stages the tile's codes plus the (k - 1) + (W - 1) halo in
// shared memory, builds each position's k-mer, canonical form and score
// once into shared memory, and each thread then scans its window there.
// So every base is read from device memory once per tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

constexpr uint64_t kM2 = 0x3333333333333333ull;
constexpr uint64_t kM4 = 0x0F0F0F0F0F0F0F0Full;
constexpr uint64_t kM8 = 0x00FF00FF00FF00FFull;
constexpr uint64_t kM16 = 0x0000FFFF0000FFFFull;

__device__ __forceinline__ uint64_t canonical(uint64_t x, int k) {
  uint64_t r = x;
  r = ((r >> 2) & kM2) | ((r & kM2) << 2);
  r = ((r >> 4) & kM4) | ((r & kM4) << 4);
  r = ((r >> 8) & kM8) | ((r & kM8) << 8);
  r = ((r >> 16) & kM16) | ((r & kM16) << 16);
  r = (r >> 32) | (r << 32);
  r = (~r) >> (64 - 2 * k);  // k = 32: shift 0
  return r < x ? r : x;
}

__device__ __forceinline__ uint64_t frev64(uint64_t x) {
  x = (x ^ 0x533F8C2151B20F97ull) * 0x9A98567ED20C127Dull;
  x = (x << 31) | (x >> 33);
  return x ^ 0x691A9D706391077Aull;
}

__global__ void minimizers_kernel(const int8_t* __restrict__ codes,
                                  const int32_t* __restrict__ lengths,
                                  int64_t L, int k, int W, int canon,
                                  int64_t E, int64_t* __restrict__ keys,
                                  bool* __restrict__ emitted) {
  extern __shared__ uint64_t smem[];
  const int npos = kThreads + W - 1;
  uint64_t* s_val = smem;
  uint64_t* s_score = smem + npos;
  uint8_t* s_bad = (uint8_t*)(smem + 2 * npos);
  int8_t* s_code = (int8_t*)(s_bad + npos);
  const int64_t row = blockIdx.y;
  const int64_t j0 = (int64_t)blockIdx.x * kThreads;
  const int8_t* crow = codes + row * L;

  for (int t = threadIdx.x; t < npos + k - 1; t += kThreads) {
    const int64_t c = j0 + t;
    s_code[t] = c < L ? crow[c] : (int8_t)-1;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < npos; t += kThreads) {
    uint64_t x = 0;
    bool bad = false;
    for (int q = 0; q < k; ++q) {
      const int8_t c = s_code[t + q];
      bad |= c < 0;
      x = (x << 2) | (uint64_t)(c < 0 ? 0 : c);
    }
    uint64_t v = canon ? canonical(x, k) : x;
    if (W > 1) {
      v = bad ? 0 : v;
      s_score[t] = frev64(v);
    }
    s_val[t] = v;
    s_bad[t] = bad;
  }
  __syncthreads();
  const int64_t j = j0 + threadIdx.x;
  if (j >= E) return;
  const int64_t n_push = max((int64_t)lengths[row] - (k - 1), (int64_t)0);
  uint64_t best_v = s_val[threadIdx.x];
  bool emit;
  if (W == 1) {
    emit = j < n_push && !s_bad[threadIdx.x];
  } else {
    uint64_t best_s = s_score[threadIdx.x];
    for (int q = 1; q < W; ++q) {
      const uint64_t s = s_score[threadIdx.x + q];
      const uint64_t v = s_val[threadIdx.x + q];
      if (s < best_s || (s == best_s && v < best_v)) {
        best_s = s;
        best_v = v;
      }
    }
    emit = j + W <= n_push;
  }
  keys[row * E + j] = (int64_t)best_v;
  emitted[row * E + j] = emit;
}

}  // namespace

// codes (B, L) int8, lengths (B,) int32 -> keys (B, E) int64-held u64,
// emitted (B, E) bool, E = L - k - W + 2 > 0; 1 <= k <= 32, W > 1 only
// with canon.
extern "C" int bk_minimizers(const void* codes, const void* lengths,
                             int64_t B, int64_t L, int k, int W, int canon,
                             void* keys, void* emitted, void* stream) {
  const int64_t E = L - k - W + 2;
  const int npos = kThreads + W - 1;
  const size_t smem = (size_t)npos * 17 + npos + k;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        minimizers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((E + kThreads - 1) / kThreads), (unsigned)B);
  minimizers_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const int32_t*)lengths, L, k, W, canon, E,
      (int64_t*)keys, (bool*)emitted);
  return (int)cudaGetLastError();
}
