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
// window out (~42 MB, ~0.0125 ms at 3.35 TB/s for a 4.6M-base row).
//
// The design: the hash as a prefix XOR, so that a window costs the same
// at any k.  With Q(m) = rotr_{m mod 64}(Tf[c_m]), R(m) = rotl_{m mod
// 64}(Tr[3 - c_m]) and E the exclusive prefix XOR of either,
//   fwd_i = rotl_{(i+k-1) mod 64}(EQ(i+k) ^ EQ(i)),
//   rc_i  = rotr_{i mod 64}(ER(i+k) ^ ER(i)),
// and a window is invalid where the prefix count of ambiguous codes grows
// between i and i + k.  A block of 256 threads owns kTile = 4096 windows
// [j0, j0 + kTile) of a row, a thread kRun = 16 consecutive ones from a.
// It stages the codes of the tile and those at its windows' ends, [j0 + k,
// j0 + k + kTile), in shared memory by 16-B loads of the words that hold
// them (a thread's 16 codes of each read back as five words,
// funnel-shifted).  A thread XORs its 16 codes of each range rotated by
// their offset r in the run (a constant rotate), then rotates the run's
// total once by a (or a + k) mod 64; the runs' totals and ambiguity counts
// are scanned with warp shuffles and the warps' totals behind one
// barrier, and the span [j0, j0 + k) is added to the second range's: the
// first range's codes below j0 + k, summed over the block behind the same
// barrier, and past kTile the k - kTile codes between the two ranges, read
// by the block (k / kTile loads a window).  That gives each thread's first
// window, fwd_a and rc_a, in O(1); it then rolls its 16 windows,
//   fwd' = rotl1(fwd) ^ rotl_{k mod 64}(Tf[out]) ^ Tf[in],
//   rc'  = rotr1(rc ^ Tr[3 - out] ^ rotl_{k mod 64}(Tr[3 - in])),
// two staged codes and two table reads a window (canonical: a 16-B entry
// holds both strands' words; the rotated tables are made once a block, the
// codes turned into table indices four at a time by byte-SIMD compares),
// and the values and flags go out through shared memory as coalesced
// stores.  No scratch, one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 16;                // windows a thread owns
constexpr int kTile = kThreads * kRun;  // windows a block owns
constexpr int kWords = kTile / 16 + 1;  // 16-B words that hold kTile codes
constexpr int kMaxChars = 256;
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> ((64 - r) & 63));  // r in [0, 64): r = 0 gives x
}

__device__ __forceinline__ uint64_t rotr(uint64_t x, int r) {
  return (x >> r) | (x << ((64 - r) & 63));
}

// the XORs of Q and R and the count of ambiguous codes over a span
struct Span {
  uint64_t q, r;
  int n;
  __device__ __forceinline__ void add(const Span& o) {
    q ^= o.q;
    r ^= o.r;
    n += o.n;
  }
};

__device__ __forceinline__ Span shfl_up(const Span& s, int d) {
  return {__shfl_up_sync(kAll, s.q, d), __shfl_up_sync(kAll, s.r, d),
          __shfl_up_sync(kAll, s.n, d)};
}

__device__ __forceinline__ Span shfl_xor(const Span& s, int d) {
  return {__shfl_xor_sync(kAll, s.q, d), __shfl_xor_sync(kAll, s.r, d),
          __shfl_xor_sync(kAll, s.n, d)};
}

// A thread's 16 codes of a range as table indices and ambiguity flags, a
// byte each, made four at a time: forward, a code < 0 reads entry 0 (an
// int8 code is < 128); canonical (DNA), entries 0-3 the codes, 4 a code
// < 0 (Tf[0], Tr[0]), 5 a code past 3 (zeros)
struct Codes {
  uint32_t idx[4], amb[4];
};

template <bool kCanon>
__device__ __forceinline__ Codes prepare(const int4& v) {
  const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                         (uint32_t)v.w};
  Codes c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t neg = __vcmplts4(w[j], 0);  // 0xFF where the code < 0
    if (kCanon) {
      const uint32_t big = __vcmpgts4(w[j], 0x03030303u);
      c.idx[j] = (w[j] & ~(neg | big)) | (neg & 0x04040404u) |
                 (big & 0x05050505u);
    } else {
      c.idx[j] = w[j] & ~neg;
    }
    c.amb[j] = neg & 0x01010101u;
  }
  return c;
}

__device__ __forceinline__ int byte_of(const uint32_t (&w)[4], int r) {
  return (w[r >> 2] >> (8 * (r & 3))) & 0xFF;
}

// the canonical entry of code c (as prepare makes it)
__device__ __forceinline__ int canon_index(int c) {
  return c < 0 ? 4 : c > 3 ? 5 : c;
}

// The block's tables.  Forward: Tf and Tf rotated left by k mod 64 (the
// roll's outgoing code).  Canonical: per entry (Tf, Tr[3 - c]) for the
// scans, (Tf, rotl_k Tr) for the roll's incoming code and (rotl_k Tf, Tr)
// for its outgoing one, a 16-B read each.
template <bool kCanon>
struct Tables {
  const uint64_t* f;      // forward: Tf
  const uint64_t* fk;     // forward: rotl_k Tf
  const ulonglong2* run;  // canonical: (Tf, Tr)
  const ulonglong2* in;   // canonical: (Tf, rotl_k Tr)
  const ulonglong2* out;  // canonical: (rotl_k Tf, Tr)
  // code c at row position m as (Q, R, ambiguous)
  __device__ __forceinline__ Span at(int c, int64_t m) const {
    const int rot = (int)(m & 63);
    if (kCanon) {
      const ulonglong2 e = run[canon_index(c)];
      return {rotr(e.x, rot), rotl(e.y, rot), c < 0};
    }
    return {rotr(f[c < 0 ? 0 : c], rot), 0, c < 0};
  }
  // the 16 codes of a run at positions base + r: their Q and R XORed
  // (each rotated by r, a constant, then the total by base) and counted;
  // in ``part`` the same of its first ``lim`` codes
  __device__ __forceinline__ Span runs(const Codes& c, int64_t base,
                                       int lim, Span* part) const {
    Span s = {0, 0, 0}, p = {0, 0, 0};
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int i = byte_of(c.idx, r);
      uint64_t q, x = 0;
      if (kCanon) {
        const ulonglong2 e = run[i];
        q = rotr(e.x, r);
        x = rotl(e.y, r);
      } else {
        q = rotr(f[i], r);
      }
      s.q ^= q;
      s.r ^= x;
      if (r < lim) p.add({q, x, byte_of(c.amb, r)});
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s.n += __popc(c.amb[j]);
    const int rot = (int)(base & 63);
    s.q = rotr(s.q, rot);
    p.q = rotr(p.q, rot);
    if (kCanon) {
      s.r = rotl(s.r, rot);
      p.r = rotl(p.r, rot);
    }
    *part = p;
    return s;
  }
};

// the inclusive scan of v over the warp's lanes
__device__ __forceinline__ Span warp_inclusive(Span v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Span o = shfl_up(v, d);
    if (lane >= d) v.add(o);
  }
  return v;
}

// v summed over the warp's lanes, in every lane
__device__ __forceinline__ Span warp_total(Span v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v.add(shfl_xor(v, d));
  return v;
}

// the slot of window s of the tile in s_val: each 16-window run rotated
// by its thread, so that a warp's stores and loads meet no bank twice
__device__ __forceinline__ int swz(int s) {
  return (s & ~(kRun - 1)) | ((s + (s >> 4)) & (kRun - 1));
}

// the 16 codes at byte b = off + 16 t of a staged range (the 16-B words
// that hold it, from its start's word): five words, funnel-shifted
__device__ __forceinline__ int4 codes16(const uint32_t* raw, int off,
                                        int t) {
  const int b = off + 16 * t, w0 = b >> 2, sh = 8 * (b & 3);
  uint32_t w[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) w[j] = raw[w0 + j];
  return make_int4((int)__funnelshift_r(w[0], w[1], sh),
                   (int)__funnelshift_r(w[1], w[2], sh),
                   (int)__funnelshift_r(w[2], w[3], sh),
                   (int)__funnelshift_r(w[3], w[4], sh));
}

template <bool kCanon>
__global__ void __launch_bounds__(kThreads)
    cyclic_kernel(const int8_t* __restrict__ codes, int64_t L, int64_t P,
                  int k, const uint64_t* __restrict__ tf,
                  const uint64_t* __restrict__ tr, int n,
                  int64_t* __restrict__ values, bool* __restrict__ invalid) {
  // the tables (Tables): forward 128 entries, canonical 6
  __shared__ uint64_t s_f[kCanon ? 1 : 128], s_fk[kCanon ? 1 : 128];
  __shared__ ulonglong2 s_run[kCanon ? 8 : 1], s_in[kCanon ? 8 : 1],
      s_out[kCanon ? 8 : 1];
  __shared__ uint64_t s_val[kTile];
  // each staged range as the 16-B words that hold it: the codes of [j0,
  // j0 + kTile), then of [j0 + k, j0 + k + kTile); after the scans, the
  // flags
  __shared__ __align__(16) uint32_t s_raw[2][kWords * 4];
  __shared__ Span s_warp[3][kWarps];  // warps' A and B runs, span parts
  __shared__ Span s_mid[kWarps];      // warps' parts of the span past kTile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kr = k & 63;
  if (kCanon && tid < 8) {  // n = 4
    const uint64_t x = tid < 4 ? tf[tid] : tid == 4 ? tf[0] : 0;
    const uint64_t y = tid < 4 ? tr[3 - tid] : tid == 4 ? tr[0] : 0;
    s_run[tid] = make_ulonglong2(x, y);
    s_in[tid] = make_ulonglong2(x, rotl(y, kr));
    s_out[tid] = make_ulonglong2(rotl(x, kr), y);
  } else if (!kCanon && tid < 128) {
    const uint64_t x = tid < n ? tf[tid] : 0;
    s_f[tid] = x;
    s_fk[tid] = rotl(x, kr);
  }
  const int64_t row = blockIdx.y;
  const int64_t j0 = (int64_t)blockIdx.x * kTile;
  const int8_t* src = codes + row * L;
  // 16-B loads of the words that hold each range; a word past the codes
  // reads 0, and codes past the row reach only windows past P
  const int8_t* end = codes + (int64_t)gridDim.y * L;
  int off[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int8_t* first = src + j0 + (g ? k : 0);
    off[g] = (int)((uintptr_t)first & 15);
    const int8_t* w0 = first - off[g];
    for (int w = tid; w < kWords; w += kThreads) {
      const int8_t* p = w0 + 16 * w;
      ((uint4*)s_raw[g])[w] =
          p < end ? __ldg((const uint4*)p) : make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();
  const Tables<kCanon> t{s_f, s_fk, s_run, s_in, s_out};

  // this thread's runs: windows at a = j0 + r0.., their ends at a + k..
  const int r0 = tid * kRun;
  const int64_t a = j0 + r0;
  const Codes ca = prepare<kCanon>(codes16(s_raw[0], off[0], tid));
  const Codes cb = prepare<kCanon>(codes16(s_raw[1], off[1], tid));
  // the runs' totals, and the span [j0, j0 + k) within the first range
  Span part, unused;
  const int lim = max(0, min(kRun, k - r0));
  const Span ra = t.runs(ca, a, lim, &part);
  const Span rb = t.runs(cb, a + k, 0, &unused);
  const Span ia = warp_inclusive(ra), ib = warp_inclusive(rb);
  part = warp_total(part);
  if (lane == 31) {
    s_warp[0][warp] = ia;
    s_warp[1][warp] = ib;
  }
  if (lane == 0) s_warp[2][warp] = part;
  __syncthreads();
  // E(a) and E(a + k) less E(j0 + k): the earlier warps' and lanes' runs
  Span ea = {ia.q ^ ra.q, ia.r ^ ra.r, ia.n - ra.n};
  Span eb = {ib.q ^ rb.q, ib.r ^ rb.r, ib.n - rb.n};
  Span span = {0, 0, 0};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      ea.add(s_warp[0][w]);
      eb.add(s_warp[1][w]);
    }
    span.add(s_warp[2][w]);
  }
  if (k > kTile) {  // the codes between the staged ranges
    Span mid = {0, 0, 0};
    for (int64_t m = j0 + kTile + tid; m < j0 + k; m += kThreads)
      mid.add(t.at(__ldg(src + m), m));
    mid = warp_total(mid);
    if (lane == 0) s_mid[warp] = mid;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) span.add(s_mid[w]);
  }
  eb.add(span);  // E(a + k)

  // the run's first window from the prefixes, then the roll
  uint64_t h = rotl(ea.q ^ eb.q, (int)((a + k - 1) & 63));
  uint64_t hr = kCanon ? rotr(ea.r ^ eb.r, (int)(a & 63)) : 0;
  int amb = eb.n - ea.n;  // ambiguous codes in the window
  uint32_t bad[4] = {0, 0, 0, 0};  // the flags, a byte each
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    s_val[swz(r0 + r)] = kCanon && hr < h ? hr : h;
    bad[r >> 2] |= (uint32_t)(amb > 0) << (8 * (r & 3));
    const int io = byte_of(ca.idx, r), ii = byte_of(cb.idx, r);
    if (kCanon) {
      const ulonglong2 eo = s_out[io], ei = s_in[ii];
      h = rotl(h, 1) ^ eo.x ^ ei.x;
      hr = rotr(hr ^ eo.y ^ ei.y, 1);
    } else {
      h = rotl(h, 1) ^ s_fk[io] ^ s_f[ii];
    }
    amb += byte_of(cb.amb, r) - byte_of(ca.amb, r);
  }
  // every read of s_raw came before a barrier that this store follows
  ((int4*)s_raw[0])[tid] = make_int4((int)bad[0], (int)bad[1], (int)bad[2],
                                     (int)bad[3]);
  __syncthreads();

  const bool* s_bad = (const bool*)s_raw[0];
  const int nslot = (int)min((int64_t)kTile, P - j0);
  int64_t* vrow = values + row * P + j0;
  bool* brow = invalid + row * P + j0;
  for (int s = tid; s < nslot; s += kThreads) {
    vrow[s] = (int64_t)s_val[swz(s)];
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
  const cudaStream_t s = (cudaStream_t)stream;
  if (table_r)
    cyclic_kernel<true><<<grid, kThreads, 0, s>>>(
        (const int8_t*)codes, L, P, k, (const uint64_t*)table_f,
        (const uint64_t*)table_r, n, (int64_t*)values, (bool*)invalid);
  else
    cyclic_kernel<false><<<grid, kThreads, 0, s>>>(
        (const int8_t*)codes, L, P, k, (const uint64_t*)table_f, nullptr, n,
        (int64_t*)values, (bool*)invalid);
  return (int)cudaGetLastError();
}
