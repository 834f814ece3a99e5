// KR1 cyclic_hashes: the cyclic rolling hash (buzhash) of every k-window
// of a batch of rows, any k, forward or canonical.
//
// Replaces the device path of bonsai_tpu/core/rolling.py buzhash (:91)
// and buzhash_rc (:116) as RollingEncoder.hashes (:168) runs them: for
// row b and window i < P = L - k + 1, with c_j the codes (an ambiguous
// code, < 0, hashes as 0 on both strands),
//   fwd_i = XOR_{j<k} rotl_{(k-1-j) mod 64}(Tf[c_{i+j}]),
//   rc_i  = XOR_{j<k} rotl_{j mod 64}(Tr[3 - c_{i+j}]),
//   value = fwd, or with Tr the unsigned min(fwd, rc),
//   invalid = the window holds an ambiguous code.
// Codes at or past the table's n entries read 0 on both strands, as in
// the plain version (core/rolling.py).
//
// What bounds it on an H100: the bytes, 1 B of codes a base in and 9 B a
// window out (~42 MB, ~0.0125 ms at 3.35 TB/s for a 4.6M-base row); the
// work is a few 64-bit rotates and xors a window once each hash is
// rolled.  The design: a block of 256 threads owns kTile = 4096 windows
// of a row, each thread kRun = 16 consecutive ones.  k is unbounded, so no
// (k - 1) halo is staged: a thread folds its first window's hashes from
// the codes in global memory (k loads, through L1) and then rolls them,
//   fwd' = rotl1(fwd) ^ rotl_{k mod 64}(Tf[out]) ^ Tf[in],
//   rc'  = rotr1(rc ^ Tr[3 - out] ^ rotl_{k mod 64}(Tr[3 - in])),
// two code loads a window, with the tables in shared memory; a window is
// invalid when the last ambiguous code seen lies inside it.  The values
// and flags go to shared memory and out as coalesced stores.  The k loads
// of a thread's first window make the launch slower for large k (k / 16
// loads a window).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                // windows a thread owns
constexpr int kTile = kThreads * kRun;  // windows a block owns
constexpr int kMaxChars = 256;

__device__ __host__ __forceinline__ int sx(int p) { return p + (p >> 4); }

__device__ __forceinline__ uint64_t rotl(uint64_t x, int r) {
  return r == 0 ? x : (x << r) | (x >> (64 - r));
}

__global__ void __launch_bounds__(kThreads)
    cyclic_kernel(const int8_t* __restrict__ codes, int64_t L, int64_t P,
                  int k, const uint64_t* __restrict__ tf,
                  const uint64_t* __restrict__ tr, int n,
                  int64_t* __restrict__ values, bool* __restrict__ invalid) {
  __shared__ uint64_t s_tf[kMaxChars], s_tr[kMaxChars];
  __shared__ uint64_t s_val[kTile + (kTile >> 4)];  // sx(kTile - 1) + 1
  __shared__ bool s_bad[kTile];
  const int tid = threadIdx.x;
  const bool canon = tr != nullptr;
  for (int c = tid; c < kMaxChars; c += kThreads) {
    s_tf[c] = c < n ? tf[c] : 0;
    s_tr[c] = canon && c < n ? tr[c] : 0;
  }
  __syncthreads();

  const int64_t row = blockIdx.y;
  const int64_t j0 = (int64_t)blockIdx.x * kTile;
  const int8_t* src = codes + row * L;
  const int r0 = tid * kRun;
  const int64_t p0 = j0 + r0;
  const int kr = k & 63;
  // the forward and reverse-complement table entries of code c
  auto fwd_of = [&](int c) { return s_tf[c < 0 ? 0 : c]; };
  auto rc_of = [&](int c) { return s_tr[c < 0 ? 0 : (3 - c) & 0xFF]; };
  if (p0 < P) {
    uint64_t h = 0, hr = 0;
    int64_t last_n = -1;  // index of the last ambiguous code read
    for (int j = 0; j < k; ++j) {
      const int c = __ldg(src + p0 + j);
      if (c < 0) last_n = p0 + j;
      h ^= rotl(fwd_of(c), (k - 1 - j) & 63);
      if (canon) hr ^= rotl(rc_of(c), j & 63);
    }
    const int nrun = (int)min((int64_t)kRun, P - p0);
    for (int r = 0; r < nrun; ++r) {
      const int64_t p = p0 + r;
      const bool lesser = canon && hr < h;
      s_val[sx(r0 + r)] = lesser ? hr : h;
      s_bad[r0 + r] = last_n >= p;
      if (r + 1 < nrun) {
        const int co = __ldg(src + p), ci = __ldg(src + p + k);
        if (ci < 0) last_n = p + k;
        h = rotl(h, 1) ^ rotl(fwd_of(co), kr) ^ fwd_of(ci);
        if (canon) {
          const uint64_t x = hr ^ rc_of(co) ^ rotl(rc_of(ci), kr);
          hr = (x >> 1) | (x << 63);
        }
      }
    }
  }
  __syncthreads();

  const int nslot = (int)min((int64_t)kTile, P - j0);
  int64_t* vrow = values + row * P + j0;
  bool* brow = invalid + row * P + j0;
  for (int s = tid; s < nslot; s += kThreads) {
    vrow[s] = (int64_t)s_val[sx(s)];
    brow[s] = s_bad[s];
  }
}

}  // namespace

// codes (B, L) int8, k >= 1, P = L - k + 1 >= 1, tables of n <= 256
// u64 (table_r null: forward hashes only, else n = 4 and the canonical
// hash) -> values (B, P) int64-held u64, invalid (B, P) bool.
extern "C" int bk_cyclic_hashes(const void* codes, int64_t B, int64_t L,
                                int k, const void* table_f,
                                const void* table_r, int n, void* values,
                                void* invalid, void* stream) {
  const int64_t P = L - k + 1;
  if (B <= 0 || B > 65535 || k < 1 || P < 1 || n < 1 || n > kMaxChars)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((P + kTile - 1) / kTile), (unsigned)B);
  cyclic_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)codes, L, P, k, (const uint64_t*)table_f,
      (const uint64_t*)table_r, n, (int64_t*)values, (bool*)invalid);
  return (int)cudaGetLastError();
}
