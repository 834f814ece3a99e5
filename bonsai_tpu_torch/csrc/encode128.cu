// K128 encode128: 128-bit k-mers for 32 < k <= 64 as (hi, lo) u64 lanes,
// hi holding the k_hi = k - 32 leftmost bases.  Two entry points:
//   bk_pack_kmers128: (B, L) int8 codes -> hi, lo (B, P) and invalid (B, P),
//     P = L - k + 1, optionally the canonical pair in the same pass;
//   bk_rc128: the reverse complement or the canonical pair of given pairs.
//
// Replaces bonsai_tpu/core/encode128.py pack_kmers128 (:25),
// reverse_complement128 (:72) and canonical128 (:92): jnp loops of k
// shifted slices and lane-wise bit reversals that XLA lowers to paired
// 32-bit VPU ops.  The JAX functions define the values, on any input:
//   * a code below 0 packs as 0 and makes its windows invalid; hi is the
//     or of codes j < k_hi shifted by 2(k_hi - 1 - j), lo that of the
//     others shifted by 2(k - 1 - j), each lane's bits past 63 dropped
//     (a code past 3 spills into its neighbours' bits and hi is not
//     masked);
//   * rc: rlo = rc64(lo, 32), rhi = rc64(hi, k_hi) with rc64 the
//     bit-parallel reverse complement of a lane's low n bases
//     (kmerutil.h:83-90); hi' = (rlo >> (64 - 2 k_hi)) & mask(k_hi),
//     lo' = (rlo << 2 k_hi) | rhi, and at k_hi = 32, where the shift is
//     64 (undefined in C++; 0 in numpy, jnp and torch), lo' = rhi;
//   * canonical: the pair or its rc, whichever is less as an unsigned
//     128-bit (hi, lo) value (canonical_representation, kmerutil.h:91-96).
//
// What bounds it on an H100: bytes.  Pack reads 1 B of codes a position
// and writes 17 B (two lanes and a flag); rc and canonical read and write
// 16 B a pair.  Pack's design: a block of 256 threads owns kTile = 4096
// positions of a row and stages their codes with the k - 1 halo in
// shared memory by 16-B vector loads; each thread rolls the 128-bit
// k-mer across its kRun = 16 positions, as KB1 rolls its k-mers
// (lo = lo << 2 | c, hi = (hi << 2 | lo >> 62) & mask(k_hi)), after k - 1
// codes of warm-up, and tracks the last ambiguous code and the last code
// past 3 in its run: a window that holds a code past 3 is packed again
// from its k staged codes as the JAX function packs it, so that every
// int8 input gives its values (DNA codes never take that branch).  The
// canonical pair is the rc formula above, a few dozen integer operations.
// The lanes go out through shared memory (rows padded by one word in 16,
// so the threads' runs fall in distinct banks) with coalesced stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                // positions a thread owns
constexpr int kTile = kThreads * kRun;  // positions a block owns
constexpr int kCodeBytes = kTile + 64 + 32;  // codes, halo, alignment

__device__ __host__ __forceinline__ int sx(int p) { return p + (p >> 4); }
constexpr int kNsx = kTile + (kTile >> 4);  // sx(kTile - 1) + 1

__device__ __forceinline__ uint64_t lane_mask(int k_hi) {
  return k_hi == 32 ? ~0ull : (1ull << (2 * k_hi)) - 1;
}

// bit-parallel reverse complement of the low ``nbases`` (1..32) 2-bit codes
__device__ __forceinline__ uint64_t rc64(uint64_t x, int nbases) {
  x = ~x;
  x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFull) |
      ((x & 0x0000FFFF0000FFFFull) << 16);
  x = (x >> 32) | (x << 32);
  return x >> (64 - 2 * nbases);  // 0..62
}

__device__ __forceinline__ void rc128(uint64_t hi, uint64_t lo, int k_hi,
                                      uint64_t* rhi, uint64_t* rlo) {
  const uint64_t r_lo = rc64(lo, 32);
  const uint64_t r_hi = rc64(hi, k_hi);
  *rhi = (r_lo >> (64 - 2 * k_hi)) & lane_mask(k_hi);
  *rlo = k_hi == 32 ? r_hi : (r_lo << (2 * k_hi)) | r_hi;
}

__device__ __forceinline__ void canonical128(uint64_t* hi, uint64_t* lo,
                                             int k_hi) {
  uint64_t rh, rl;
  rc128(*hi, *lo, k_hi, &rh, &rl);
  if (rh < *hi || (rh == *hi && rl < *lo)) *hi = rh, *lo = rl;
}

// the JAX function's pack of one window from its k staged codes
__device__ __forceinline__ void pack_direct(const int8_t* cp, int k, int k_hi,
                                            uint64_t* hi, uint64_t* lo) {
  uint64_t h = 0, l = 0;
  for (int j = 0; j < k; ++j) {
    const uint64_t c = cp[j] < 0 ? 0 : (uint64_t)cp[j];
    if (j < k_hi)
      h |= c << (2 * (k_hi - 1 - j));
    else
      l |= c << (2 * (k - 1 - j));
  }
  *hi = h;
  *lo = l;
}

__global__ void __launch_bounds__(kThreads)
    pack_kernel(const int8_t* __restrict__ codes, int64_t L, int k,
                int64_t P, int canon, int64_t* __restrict__ out_hi,
                int64_t* __restrict__ out_lo, bool* __restrict__ out_inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_hi = (uint64_t*)smem;
  uint64_t* s_lo = s_hi + kNsx;
  uint16_t* s_inv = (uint16_t*)(s_lo + kNsx);  // kThreads masks of kRun
  int8_t* s_code = (int8_t*)(s_inv + kThreads);
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * kTile;
  const int k_hi = k - 32;

  // stage codes [p0, p0 + kTile + k - 1) of the row, -1 past it
  const int need = kTile + k - 1;
  const int8_t* src = codes + row * L + p0;
  const int64_t avail = min((int64_t)need, L - p0);
  const int shift = (int)((uintptr_t)src & 15);
  const int nchunk = (shift + need + 15) >> 4;
  for (int q = tid; q < nchunk; q += kThreads) {
    const int lo = q * 16 - shift;
    union {
      int4 v;
      int8_t b[16];
    } u;
    if (lo >= 0 && lo + 16 <= avail) {
      u.v = *(const int4*)(src + lo);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        u.b[e] = lo + e >= 0 && lo + e < avail ? src[lo + e] : (int8_t)-1;
    }
    *(int4*)(s_code + q * 16) = u.v;
  }
  __syncthreads();

  // roll this thread's kRun windows
  const uint64_t hmask = lane_mask(k_hi);
  const int r0 = tid * kRun;
  const uint32_t* w32 = (const uint32_t*)s_code;
  int ci = shift + r0;
  uint32_t word = w32[ci >> 2] >> (8 * (ci & 3));
  uint64_t hi = 0, lo = 0;
  int last_n = -1, last_big = -1;
  uint32_t inv = 0;
  for (int i = 0; i < kRun + k - 1; ++i, ++ci) {
    if (i > 0 && (ci & 3) == 0) word = w32[ci >> 2];
    int c = (int8_t)(word & 0xFF);
    word >>= 8;
    if (c < 0) {
      last_n = i;
      c = 0;
    } else if (c > 3) {
      last_big = i;
    }
    hi = ((hi << 2) | (lo >> 62)) & hmask;
    lo = (lo << 2) | (uint64_t)c;
    const int r = i - (k - 1);
    if (r < 0) continue;
    uint64_t h = hi, l = lo;
    if (last_big >= r) pack_direct(s_code + shift + r0 + r, k, k_hi, &h, &l);
    if (canon) canonical128(&h, &l, k_hi);
    s_hi[sx(r0 + r)] = h;
    s_lo[sx(r0 + r)] = l;
    inv |= (uint32_t)(last_n >= r) << r;
  }
  s_inv[tid] = (uint16_t)inv;
  __syncthreads();

  // out, coalesced
  const int npos = (int)min((int64_t)kTile, P - p0);
  const int64_t base = row * P + p0;
  for (int p = tid; p < npos; p += kThreads) {
    out_hi[base + p] = (int64_t)s_hi[sx(p)];
    out_lo[base + p] = (int64_t)s_lo[sx(p)];
    out_inv[base + p] = (s_inv[p / kRun] >> (p % kRun)) & 1;
  }
}

// the rc (mode 0) or canonical (mode 1) pair of each given pair
__global__ void __launch_bounds__(kThreads)
    rc_kernel(const uint64_t* __restrict__ hi, const uint64_t* __restrict__ lo,
              int64_t n, int k_hi, int canon, uint64_t* __restrict__ out_hi,
              uint64_t* __restrict__ out_lo) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    uint64_t h = hi[i], l = lo[i];
    if (canon) {
      canonical128(&h, &l, k_hi);
    } else {
      uint64_t rh, rl;
      rc128(h, l, k_hi, &rh, &rl);
      h = rh, l = rl;
    }
    out_hi[i] = h;
    out_lo[i] = l;
  }
}

int pack_smem() {
  return 2 * kNsx * 8 + kThreads * 2 + kCodeBytes;
}

}  // namespace

// codes (B, L) int8 -> hi, lo (B, P) int64-held u64 and invalid (B, P)
// bool, P = L - k + 1 >= 1, 32 < k <= 64, B <= 65535; ``canon`` gives the
// canonical pair.
extern "C" int bk_pack_kmers128(const void* codes, int64_t B, int64_t L,
                                int k, int canon, void* hi, void* lo,
                                void* invalid, void* stream) {
  const int64_t P = L - k + 1;
  if (B < 0 || B > 65535 || k <= 32 || k > 64 || P < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int smem = pack_smem();
  cudaError_t e = cudaFuncSetAttribute(
      pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (P + kTile - 1) / kTile;
  if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  pack_kernel<<<dim3((unsigned)tiles, (unsigned)B), kThreads, smem,
                (cudaStream_t)stream>>>((const int8_t*)codes, L, k, P, canon,
                                        (int64_t*)hi, (int64_t*)lo,
                                        (bool*)invalid);
  return (int)cudaGetLastError();
}

// hi, lo (n,) int64-held u64 -> out_hi, out_lo (n,): mode 0 the reverse
// complement, 1 the canonical pair; 32 < k <= 64.
extern "C" int bk_rc128(const void* hi, const void* lo, int64_t n, int k,
                        int mode, void* out_hi, void* out_lo, void* stream) {
  if (n < 0 || k <= 32 || k > 64 || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 16;
  rc_kernel<<<(unsigned)(want < cap ? want : cap), kThreads, 0,
              (cudaStream_t)stream>>>((const uint64_t*)hi,
                                      (const uint64_t*)lo, n, k - 32, mode,
                                      (uint64_t*)out_hi, (uint64_t*)out_lo);
  return (int)cudaGetLastError();
}
