// KS4 bitmix: one elementwise pass over int64-held u64 values, with a mode
// for each of wang_hash, khash_int64_hash, popcount64, the inverse mixes
// frev64_inv and wang_hash_inv, and a left rotate by a parameter r (entry
// bk_rotl), and a nuccount entry that writes the four base counts of a
// packed 2-bit k-mer.  KS5 is its owner mode (entry bk_shard_owner): the
// hash-prefix shard of a key, ((splitmix64(key) >> 32) * ndb) >> 32 as an
// int32, with probe.cuh's splitmix64.
//
// Replaces bonsai_tpu/core/hashes.py wang_hash (:58), khash_int64_hash
// (:75), frev64_inv (:48), wang_hash_inv (:96), lrot and rrot (:123,128;
// both the rotate mode), bonsai_tpu/core/bitops.py popcount64 (:60),
// nuccount (:69) and bonsai_tpu/db/table.py shard_owner (:413): jnp (or
// dual numpy/jnp) elementwise functions that XLA lowers to paired 32-bit
// VPU ops.
//
// What bounds it on an H100: bytes.  A value is read once and 8 B (or
// four 8-B counts, or a 4-B owner) written once; the mixes are a dozen
// integer operations and __popcll one (the inverse of wang_hash two
// dozen).  A shift of a u64 by 64 is undefined in C++, so the rotate by
// r = 0 returns the value as it is.  A thread takes 4 values of a
// grid-stride loop, so loads are coalesced and a block has several in
// flight (nuccount: a lane pair 4 k-mers, a lane a 16-B half of each
// row).  The owner's product wraps mod 2^64 as the u64 one does; below
// ndb = 2^32 it never wraps.
//
// Its key-range mode (entry bk_key_range) is the rank filter of the
// sharded LCA fold (bonsai_tpu/db/build_device.py ShardedLCAFold._fn,
// :581-590): flag = pad == 0 and lo <= key and (key < hi, or key <= hi on
// the last rank), an unsigned compare of int64-held u64 keys; 8 B and 1 B
// in, 1 B out a key, in the same loop.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitmix.cuh"
#include "probe.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

enum Mode {
  kWang = 0, kKhash = 1, kPopcount = 2, kOwner = 3, kFrevInv = 4,
  kWangInv = 5, kRotl = 6
};

// The inverse of frev64 (hashes.py:39-55): xor, rotate right by 31,
// multiply by the inverse of 0x9A98567ED20C127D mod 2^64, xor.
__device__ __forceinline__ uint64_t frev64_inv(uint64_t x) {
  x ^= 0x691A9D706391077Aull;
  x = (x >> 31) | (x << 33);
  x *= 0x7462E4A5CD5B76D5ull;
  return x ^ 0x533F8C2151B20F97ull;
}

// The inverse of wang_hash: irving_inv_hash (hash.h:94-120;
// hashes.py:96-120), wrapping arithmetic on u64.
__device__ __forceinline__ uint64_t wang_hash_inv(uint64_t key) {
  uint64_t tmp = key - (key << 31);
  key = key - (tmp << 31);
  tmp = key ^ (key >> 28);
  key = key ^ (tmp >> 28);
  key *= 14933078535860113213ull;
  tmp = key ^ (key >> 14);
  tmp = key ^ (tmp >> 14);
  tmp = key ^ (tmp >> 14);
  key = key ^ (tmp >> 14);
  key *= 15244667743933553977ull;
  tmp = key ^ (key >> 24);
  key = key ^ (tmp >> 24);
  tmp = ~key;
  tmp = ~(key - (tmp << 21));
  tmp = ~(key - (tmp << 21));
  return ~(key - (tmp << 21));
}

// p: the owner mode's ndb, or the rotate's r (0 <= r < 64)
template <int kMode>
__device__ __forceinline__ uint64_t mix(uint64_t x, uint64_t p) {
  if (kMode == kWang) return bk::wang_hash(x);
  if (kMode == kKhash) return bk::khash_int64_hash(x);
  if (kMode == kOwner) return ((bk::splitmix64(x) >> 32) * p) >> 32;
  if (kMode == kFrevInv) return frev64_inv(x);
  if (kMode == kWangInv) return wang_hash_inv(x);
  if (kMode == kRotl) return p ? (x << p) | (x >> (64 - p)) : x;
  return (uint64_t)__popcll(x);
}

// out[i] = mix(in[i]) as an Out (u64, or the owner's int32)
template <int kMode, typename Out>
__global__ void __launch_bounds__(kThreads)
    bitmix(const uint64_t* __restrict__ in, int64_t n, uint64_t p,
           Out* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads * kPerThread +
                      threadIdx.x;
       base < n; base += stride * kPerThread) {
    uint64_t v[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int64_t i = base + (int64_t)r * kThreads;
      v[r] = i < n ? in[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int64_t i = base + (int64_t)r * kThreads;
      if (i < n) out[i] = (Out)mix<kMode>(v[r], p);
    }
  }
}

// Counts of codes A, C, G, T (0..3) among the k 2-bit codes of each
// k-mer (bitops.nuccount): code c matches where both bits of x ^ cmp[c]
// are set, counted with one popcount a code.  Two lanes a k-mer: the even
// lane counts A and C, the odd one G and T, and each writes its 16-B half
// of the k-mer's 32-B row, so that one warp store covers 512 contiguous
// bytes (16 rows) in whole sectors.  Both lanes load the k-mer (one 128-B
// request a warp); kPer k-mers of a lane pair are loaded before any is
// counted.  The rows are written once and not read again here: streaming
// stores (__stcs), measured 0.2-1.7% faster on an H100 (PERF.md row 18).
__global__ void __launch_bounds__(kThreads)
    nuccount(const uint64_t* __restrict__ in, int64_t n, uint64_t mask,
             int64_t* __restrict__ out) {
  constexpr int kRows = kThreads / 2;  // k-mers a block a step
  constexpr int kPer = kPerThread;     // k-mers a lane pair a turn
  const int half = threadIdx.x & 1;
  const uint64_t c0 = half ? 0x5555555555555555ull : ~0ull;  // G : A
  const uint64_t c1 = half ? 0ull : 0xAAAAAAAAAAAAAAAAull;   // T : C
  const int64_t stride = (int64_t)gridDim.x * kRows * kPer;
  for (int64_t base = (int64_t)blockIdx.x * kRows * kPer +
                      (threadIdx.x >> 1);
       base < n; base += stride) {
    uint64_t v[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int64_t i = base + (int64_t)r * kRows;
      v[r] = i < n ? in[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int64_t i = base + (int64_t)r * kRows;
      if (i < n) {
        const uint64_t x0 = v[r] ^ c0, x1 = v[r] ^ c1;
        const longlong2 c = make_longlong2(
            __popcll(x0 & ((x0 >> 1) & 0x5555555555555555ull) & mask),
            __popcll(x1 & ((x1 >> 1) & 0x5555555555555555ull) & mask));
        __stcs((longlong2*)(out + 4 * i) + half, c);  // 32-B aligned rows
      }
    }
  }
}

// flag[i] = pad[i] == 0 && lo <= keys[i] && (keys[i] < hi || (last &&
// keys[i] <= hi)), unsigned
__global__ void __launch_bounds__(kThreads)
    key_range(const uint64_t* __restrict__ keys,
              const uint8_t* __restrict__ pad, int64_t n, uint64_t lo,
              uint64_t hi, int last, bool* __restrict__ flag) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads * kPerThread +
                      threadIdx.x;
       base < n; base += stride * kPerThread) {
    uint64_t v[kPerThread];
    uint8_t p[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int64_t i = base + (int64_t)r * kThreads;
      v[r] = i < n ? keys[i] : 0;
      p[r] = i < n ? pad[i] : 1;
    }
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int64_t i = base + (int64_t)r * kThreads;
      if (i < n)
        flag[i] = p[r] == 0 && v[r] >= lo &&
                  (v[r] < hi || (last && v[r] <= hi));
    }
  }
}

unsigned grid(int64_t n, int64_t per) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n + kThreads * per - 1) / (kThreads * per);
  const int64_t cap = (int64_t)sms * 16;
  return (unsigned)(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

// in (n,) int64-held u64 -> out (n,) int64: mode 0 wang_hash, 1
// khash_int64_hash (its u32 in the low half), 2 popcount64, 4 frev64_inv,
// 5 wang_hash_inv.
extern "C" int bk_bitmix(const void* in, int64_t n, int mode, void* out,
                         void* stream) {
  if (n < 0 || mode < 0 || mode > kWangInv || mode == kOwner)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned g = grid(n, kPerThread);
  const uint64_t* i = (const uint64_t*)in;
  uint64_t* o = (uint64_t*)out;
  switch (mode) {
    case kWang: bitmix<kWang><<<g, kThreads, 0, s>>>(i, n, 0, o); break;
    case kKhash: bitmix<kKhash><<<g, kThreads, 0, s>>>(i, n, 0, o); break;
    case kPopcount:
      bitmix<kPopcount><<<g, kThreads, 0, s>>>(i, n, 0, o);
      break;
    case kFrevInv:
      bitmix<kFrevInv><<<g, kThreads, 0, s>>>(i, n, 0, o);
      break;
    default: bitmix<kWangInv><<<g, kThreads, 0, s>>>(i, n, 0, o);
  }
  return (int)cudaGetLastError();
}

// The rotate mode (6): in (n,) int64-held u64 rotated left by r, 0 <= r <
// 64 -> out (n,) int64.
extern "C" int bk_rotl(const void* in, int64_t n, int r, void* out,
                       void* stream) {
  if (n < 0 || r < 0 || r > 63) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  bitmix<kRotl><<<grid(n, kPerThread), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, n, (uint64_t)r, (uint64_t*)out);
  return (int)cudaGetLastError();
}

// KS5: keys (n,) int64-held u64 -> out (n,) int32 owners in [0, ndb),
// 1 <= ndb < 2^31.
extern "C" int bk_shard_owner(const void* keys, int64_t n, int64_t ndb,
                              void* out, void* stream) {
  if (n < 0 || ndb < 1 || ndb >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  bitmix<kOwner><<<grid(n, kPerThread), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)keys, n, (uint64_t)ndb, (int32_t*)out);
  return (int)cudaGetLastError();
}

// kmers (n,) int64-held u64, the k-mer's bit mask -> out (n, 4) int64
// counts of A, C, G, T; out 32-B aligned.
extern "C" int bk_nuccount(const void* kmers, int64_t n, uint64_t mask,
                           void* out, void* stream) {
  if (n < 0 || (uintptr_t)out % 16) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  nuccount<<<grid(n, kPerThread / 2), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)kmers, n, mask, (int64_t*)out);
  return (int)cudaGetLastError();
}

// keys (n,) int64-held u64, pad (n,) uint8, the rank's range [lo, hi)
// (hi inclusive with ``last``) -> flag (n,) bool.
extern "C" int bk_key_range(const void* keys, const void* pad, int64_t n,
                            uint64_t lo, uint64_t hi, int last, void* flag,
                            void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  key_range<<<grid(n, kPerThread), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)keys, (const uint8_t*)pad, n, lo, hi, last,
      (bool*)flag);
  return (int)cudaGetLastError();
}
