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
// 16 B a pair.  Pack's design: a block of 128 threads owns kTile = 2048
// positions of a row and stages their codes with the k - 1 halo in
// shared memory by 16-B vector loads.  Each thread owns kRun = 16
// windows.  It builds its first window bit-parallel from the staged code
// words (first_window: each u32 of 4 codes folds into 8 bits by one
// multiply, and the 16 words of a window are independent), where rolling
// k - 1 codes of warm-up made each thread's 16 outputs wait on up to 79
// dependent steps; then it rolls the 128-bit k-mer across its other 15
// windows (lo = lo << 2 | c, hi = (hi << 2 | lo >> 62) & mask(k_hi)), and
// with ``canon`` the reverse complement beside it
// (rlo = rlo >> 2 | rhi << 62, rhi = rhi >> 2 | (3 - c) << 2(k_hi - 1)),
// where two bit-reversals a window made it the pack's dearest step.  The
// last ambiguous code and the last code past 3 are tracked by index: a
// window that holds a code past 3 is packed again from its k staged codes
// as the JAX function packs it, and takes the rc formula above, so that
// every int8 input gives its values (DNA codes never take that branch;
// the rolled lanes fold each code's low 2 bits, and a code past 3 leaves
// them with it).  A thread writes its 16 invalid flags as one 16-B store
// where its run is whole and aligned; the lanes go out through shared
// memory (rows padded by one word in 16, so the threads' runs fall in
// distinct banks) as 16-B pairs of adjacent positions, a row's first
// position alone where its pairs would start off 16 B.  Every output
// store streams (__stcs: evict-first in L2; nothing in the port reads
// the lanes back at once), which took a quarter off the pack.  The
// staging takes ~36 KB a block: 6 blocks of 128 an SM, where tiles of
// 4096 (~72 KB, 3 blocks of 256) left the last of ~2.9 waves a third
// full.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;           // the pack's threads a block
constexpr int kRun = 16;                // positions a thread owns
constexpr int kTile = kThreads * kRun;  // positions a block owns
constexpr int kRcThreads = 256;         // rc_kernel's threads a block
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

// The codes' low 2 bits of a u32 of 4 staged codes (the first in its
// low byte), an ambiguous code as 0, folded first code high into 8 bits:
// the multiply moves byte j's 2 bits to bit 30 - 2j, clear of every other
// product (no carries), so that the top byte is the fold.
__device__ __forceinline__ uint32_t fold4(uint32_t w) {
  const uint32_t amb = (w >> 7) & 0x01010101u;  // a byte's sign bit
  return ((w & ~(amb * 3u) & 0x03030303u) * 0x40100401u) >> 24;
}

// the u32 of the 4 staged codes from byte ``b`` of s_code
__device__ __forceinline__ uint32_t codes4(const uint32_t* w32, int b) {
  return __funnelshift_r(w32[b >> 2], w32[(b >> 2) + 1], 8 * (b & 3));
}

// The first window's lanes, from the k codes at byte ``b`` of s_code (and
// up to 3 bytes after them, shifted out), and the index of its last
// ambiguous code and of its last code past 3 (or -1).
__device__ __forceinline__ void first_window(const uint32_t* w32, int b,
                                             int k, uint64_t* hi,
                                             uint64_t* lo, int* last_n,
                                             int* last_big) {
  uint64_t a = 0, c = 0;  // codes 0..31 and 32..63, first code high
  int ln = -1, lb = -1;
  const int nw = (k + 3) >> 2;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    if (q < nw) {
      uint32_t w = codes4(w32, b + 4 * q);
      const uint64_t f = fold4(w);
      if (q < 8)
        a |= f << (56 - 8 * q);
      else
        c |= f << (120 - 8 * q);
      const int left = k - 4 * q;  // codes of this word inside the window
      if (left < 4) w &= (1u << (8 * left)) - 1;
      const uint32_t amb = w & 0x80808080u;
      const uint32_t big =
          ((w & 0x7C7C7C7Cu) + 0x7F7F7F7Fu) & ~w & 0x80808080u;
      if (amb) ln = 4 * q + ((31 - __clz(amb)) >> 3);
      if (big) lb = 4 * q + ((31 - __clz(big)) >> 3);
    }
  }
  const int s = 128 - 2 * k;  // 0..62: the codes past k shifted out
  *hi = a >> s;
  *lo = s ? (c >> s) | (a << (64 - s)) : c;
  *last_n = ln;
  *last_big = lb;
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

template <bool kCanon>
__global__ void __launch_bounds__(kThreads)
    pack_kernel(const int8_t* __restrict__ codes, int64_t L, int k,
                int64_t P, int64_t* __restrict__ out_hi,
                int64_t* __restrict__ out_lo, bool* __restrict__ out_inv) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* s_hi = (uint64_t*)smem;
  uint64_t* s_lo = s_hi + kNsx;
  int8_t* s_code = (int8_t*)(s_lo + kNsx);
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

  // this thread's kRun windows: the first built, the others rolled
  const uint64_t hmask = lane_mask(k_hi);
  const int r0 = tid * kRun;
  const uint32_t* w32 = (const uint32_t*)s_code;
  const int b0 = shift + r0;  // byte of the first window's first code
  uint64_t hi, lo, rhi = 0, rlo = 0;
  int last_n, last_big;
  first_window(w32, b0, k, &hi, &lo, &last_n, &last_big);
  if (kCanon) rc128(hi, lo, k_hi, &rhi, &rlo);
  uint32_t in[kRun / 4];  // the codes coming in: k .. k + kRun - 2
#pragma unroll
  for (int q = 0; q < kRun / 4; ++q) in[q] = codes4(w32, b0 + k + 4 * q);
  uint32_t inv = 0, big = 0;  // bit r: window r holds an N, a code past 3
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    if (r > 0) {
      const int c = (int8_t)(in[(r - 1) >> 2] >> (8 * ((r - 1) & 3)));
      if (c < 0) last_n = r + k - 1;
      if (c > 3) last_big = r + k - 1;
      const uint64_t u = c < 0 ? 0 : (uint64_t)(c & 3);
      hi = ((hi << 2) | (lo >> 62)) & hmask;
      lo = (lo << 2) | u;
      if (kCanon) {
        rlo = (rlo >> 2) | (rhi << 62);
        rhi = (rhi >> 2) | ((3 - u) << (2 * k_hi - 2));
      }
    }
    const bool take_rc = kCanon && (rhi < hi || (rhi == hi && rlo < lo));
    s_hi[sx(r0 + r)] = take_rc ? rhi : hi;
    s_lo[sx(r0 + r)] = take_rc ? rlo : lo;
    inv |= (uint32_t)(last_n >= r) << r;
    big |= (uint32_t)(last_big >= r) << r;
  }
  for (; big; big &= big - 1) {  // packed again as the JAX function packs
    const int r = __ffs(big) - 1;
    uint64_t h, l;
    pack_direct(s_code + b0 + r, k, k_hi, &h, &l);
    if (kCanon) canonical128(&h, &l, k_hi);
    s_hi[sx(r0 + r)] = h;
    s_lo[sx(r0 + r)] = l;
  }

  // this thread's invalid flags: 16-B stores where whole and aligned, a
  // nibble of flags spread to 4 bytes by a multiply (no carries)
  const int npos = (int)min((int64_t)kTile, P - p0);
  const int64_t base = row * P + p0;
  bool* erow = out_inv + base + r0;
  if (r0 + kRun <= npos && ((uintptr_t)erow & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kRun / 16; ++q) {
      uint32_t f[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[j] = (((inv >> (16 * q + 4 * j)) & 15) * 0x00204081u) & 0x01010101u;
      __stcs((uint4*)erow + q, make_uint4(f[0], f[1], f[2], f[3]));
    }
  } else {
    for (int r = 0; r < kRun && r0 + r < npos; ++r) erow[r] = (inv >> r) & 1;
  }
  __syncthreads();

  // the lanes: 16-B pairs of adjacent positions, the row's first position
  // alone where the pairs would start off 16 B (both lanes alike)
  int64_t* hrow = out_hi + base;
  int64_t* lrow = out_lo + base;
  const int head = (int)(((uintptr_t)hrow >> 3) & 1);
  if (head && tid == 0) {
    hrow[0] = (int64_t)s_hi[0];
    lrow[0] = (int64_t)s_lo[0];
  }
  for (int p = head + 2 * tid; p < npos; p += 2 * kThreads) {
    const int x = sx(p);
    if (p + 1 < npos) {
      const int y = sx(p + 1);
      __stcs((ulonglong2*)(hrow + p), make_ulonglong2(s_hi[x], s_hi[y]));
      __stcs((ulonglong2*)(lrow + p), make_ulonglong2(s_lo[x], s_lo[y]));
    } else {
      hrow[p] = (int64_t)s_hi[x];
      lrow[p] = (int64_t)s_lo[x];
    }
  }
}

// the rc (mode 0) or canonical (mode 1) pair of each given pair
__global__ void __launch_bounds__(kRcThreads)
    rc_kernel(const uint64_t* __restrict__ hi, const uint64_t* __restrict__ lo,
              int64_t n, int k_hi, int canon, uint64_t* __restrict__ out_hi,
              uint64_t* __restrict__ out_lo) {
  const int64_t stride = (int64_t)gridDim.x * kRcThreads;
  for (int64_t i = (int64_t)blockIdx.x * kRcThreads + threadIdx.x; i < n;
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

int pack_smem() { return 2 * kNsx * 8 + kCodeBytes; }

}  // namespace

// codes (B, L) int8 -> hi, lo (B, P) int64-held u64 and invalid (B, P)
// bool, P = L - k + 1 >= 1, 32 < k <= 64, B <= 65535, hi and lo at one
// offset from 16 B; ``canon`` gives the canonical pair.
extern "C" int bk_pack_kmers128(const void* codes, int64_t B, int64_t L,
                                int k, int canon, void* hi, void* lo,
                                void* invalid, void* stream) {
  const int64_t P = L - k + 1;
  if (B < 0 || B > 65535 || k <= 32 || k > 64 || P < 1 ||
      (((uintptr_t)hi | (uintptr_t)lo) & 7) ||
      (((uintptr_t)hi ^ (uintptr_t)lo) & 15))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int smem = pack_smem();
  const void* f = canon ? (const void*)pack_kernel<true>
                        : (const void*)pack_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (P + kTile - 1) / kTile;
  if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)B);
  const cudaStream_t st = (cudaStream_t)stream;
  if (canon)
    pack_kernel<true><<<grid, kThreads, smem, st>>>(
        (const int8_t*)codes, L, k, P, (int64_t*)hi, (int64_t*)lo,
        (bool*)invalid);
  else
    pack_kernel<false><<<grid, kThreads, smem, st>>>(
        (const int8_t*)codes, L, k, P, (int64_t*)hi, (int64_t*)lo,
        (bool*)invalid);
  return (int)cudaGetLastError();
}

// The blocks of the pack that one SM holds at once, or minus a CUDA error.
extern "C" int bk_pack_kmers128_blocks_per_sm() {
  const int smem = pack_smem();
  cudaError_t e = cudaFuncSetAttribute(
      pack_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pack_kernel<true>,
                                                      kThreads, smem);
  return e == cudaSuccess ? n : -(int)e;
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
  const int64_t want = (n + kRcThreads - 1) / kRcThreads;
  const int64_t cap = (int64_t)sms * 16;
  rc_kernel<<<(unsigned)(want < cap ? want : cap), kRcThreads, 0,
              (cudaStream_t)stream>>>((const uint64_t*)hi,
                                      (const uint64_t*)lo, n, k - 32, mode,
                                      (uint64_t*)out_hi, (uint64_t*)out_lo);
  return (int)cudaGetLastError();
}
