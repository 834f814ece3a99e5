// KS2 csetsketch_update: the continuous SetSketch (CSetSketch) update of a
// batch of u64 values, in chunks of 2^16 elements.
//
// Replaces bonsai_tpu/sketch/setsketch.py CSetSketch.update and
// _update_chunk (:79-121) with _arrivals and _mix (:46-61).  Each element
// x (h = mix(x)) runs a rate-m Poisson arrival process: arrival c is
//   z = mix(h + MIX1 * (c + 1)), u = ((z >> 11) + 1) * 2^-53,
//   gap = -log(u) / m, register mix(z + MIX3) % m,
// in rounds of 16 whose times are t + cumsum(gaps) (the cumsum restarts
// each round; t is the previous round's last time), and an arrival counts
// only where its time is below the round's threshold, the registers' max
// at the round's start.  An element stops after a round whose last time
// is at or past the threshold.  One thread runs one element of a chunk.
//
// Registers are f64 and positive (or +inf), so they order as their u64
// bits and the minimum is a 64-bit atomicMin on the bits.
//
// Default mode: the final registers are the minimum over every arrival of
// every element, whatever the moment an element stops, as long as it
// stops only at a time at or past some value at or above the registers'
// max then (the max only falls).  So once the registers' max is finite, a
// chunk runs in one launch against the max at its start (read on the card
// from css_max after the previous chunk: no host sync), each element
// looping over its rounds.  Before that (an untouched register keeps the
// max at +inf) each round is a launch and the host reads how many
// elements live on.
//
// ids (-S) and idcounts (-s) depend on the rounds, so that mode keeps
// them: a round is a launch that takes each register's minimum arrival
// of the round into rmin, a second that writes the element's value where
// its arrival is that minimum (copies of one value tie exactly: their
// arrival streams are the same), and css_finalize, which applies the
// round to each register as the JAX package does: smaller -> register,
// id, count 1; equal with the same id -> count + 1.  The host reads the
// live count after each round.
//
// `log` is CUDA's double log (within 1 ulp of the true value), so a
// register can differ from numpy's in its last bits; ids, idcounts and the
// order of the work are the JAX package's.
// What bounds it on an H100: FP64 work, log and a divide an arrival.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr uint64_t kMix1 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kMix2 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kMix3 = 0x94D049BB133111EBull;
constexpr int kSteps = 16;     // arrivals a round
constexpr int kThreads = 256;
constexpr unsigned long long kNone = ~0ull;  // rmin: no arrival this round

enum Mode { kMin = 0, kRoundMin = 1, kRoundArg = 2 };

__device__ __forceinline__ uint64_t mix(uint64_t z) {
  z = (z ^ (z >> 30)) * kMix2;
  z = (z ^ (z >> 27)) * kMix3;
  return z ^ (z >> 31);
}

__device__ __forceinline__ void arrival(uint64_t h, uint64_t c, uint64_t m,
                                        double* gap, uint64_t* reg) {
  const uint64_t z = mix(h + kMix1 * (c + 1));
  const double u = (__ull2double_rn(z >> 11) + 1.0) * 0x1p-53;
  *gap = -log(u) / __ull2double_rn(m);
  *reg = mix(z + kMix3) % m;
}

// kMin: up to `rounds` rounds (0: until the element stops) into the
// registers' bits (`target`); kRoundMin: one round into rmin, the state
// unchanged; kRoundArg: the same round again, the value of each
// register's minimum into rid, then the state advanced.  Live elements
// are counted into n_alive (kMin and kRoundArg).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    css_round(const uint64_t* __restrict__ v, int64_t n, uint64_t m,
              int rounds, const double* __restrict__ thresh_p,
              double* __restrict__ t, uint64_t* __restrict__ ctr,
              uint8_t* __restrict__ alive, unsigned long long* target,
              uint64_t* __restrict__ rid,
              unsigned long long* __restrict__ n_alive) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || !alive[i]) return;
  const double thresh = *thresh_p;
  const uint64_t x = v[i];
  const uint64_t h = mix(x);
  double tt = t[i];
  uint64_t c = ctr[i];
  bool live = true;
  for (int R = 0; rounds == 0 || R < rounds; ++R) {
    double s = 0.0;
#pragma unroll 4
    for (int j = 0; j < kSteps; ++j) {
      double g;
      uint64_t r;
      arrival(h, c + j, m, &g, &r);
      s = j ? s + g : g;  // np.cumsum: the first sum is the first gap
      const double time = tt + s;
      if (time < thresh) {
        const unsigned long long b =
            (unsigned long long)__double_as_longlong(time);
        if (kMode == kRoundArg) {
          if (b == __ldcg(target + r)) rid[r] = x;
        } else if (b < __ldcg(target + r)) {
          atomicMin(target + r, b);
        }
      }
    }
    tt = tt + s;
    c += kSteps;
    live = tt < thresh;
    if (!live) break;
  }
  if (kMode == kRoundMin) return;
  t[i] = tt;
  ctr[i] = c;
  alive[i] = live;
  if (live) atomicAdd(n_alive, 1ull);
}

// One round of -S / -s applied to each register (_update_chunk :100-115).
__global__ void __launch_bounds__(kThreads)
    css_finalize(uint64_t m, double* __restrict__ regs,
                 uint64_t* __restrict__ ids, uint32_t* __restrict__ idc,
                 unsigned long long* __restrict__ rmin,
                 const uint64_t* __restrict__ rid) {
  const int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (r >= (int64_t)m) return;
  const unsigned long long b = rmin[r];
  if (b == kNone) return;
  rmin[r] = kNone;
  const double rt = __longlong_as_double((long long)b);
  const double cur = regs[r];
  if (rt < cur) {
    regs[r] = rt;
    ids[r] = rid[r];
    if (idc) idc[r] = 1;
  } else if (idc && rt == cur && rid[r] == ids[r]) {
    idc[r] += 1;
  }
}

// The registers' max (one block): the next round's threshold.
__global__ void __launch_bounds__(1024)
    css_max(const double* __restrict__ regs, uint64_t m,
            double* __restrict__ out) {
  __shared__ unsigned long long w[32];
  unsigned long long mx = 0;
  for (uint64_t r = threadIdx.x; r < m; r += 1024) {
    const unsigned long long b =
        (unsigned long long)__double_as_longlong(regs[r]);
    mx = b > mx ? b : mx;
  }
  for (int o = 16; o; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(0xFFFFFFFFu, mx, o);
    mx = y > mx ? y : mx;
  }
  if (threadIdx.x % 32 == 0) w[threadIdx.x / 32] = mx;
  __syncthreads();
  if (threadIdx.x < 32) {
    mx = w[threadIdx.x];
    for (int o = 16; o; o >>= 1) {
      const unsigned long long y = __shfl_xor_sync(0xFFFFFFFFu, mx, o);
      mx = y > mx ? y : mx;
    }
    if (threadIdx.x == 0) *out = __longlong_as_double((long long)mx);
  }
}

struct Buffers {
  double* t;
  uint64_t* ctr;
  uint8_t* alive;
  unsigned long long* rmin;
  uint64_t* rid;
  double* thresh;
  unsigned long long* n_alive;
  int64_t used;
};

Buffers carve(char* p, int64_t chunk, int64_t m) {
  bk::Carve c{p};
  Buffers b;
  b.t = c.take<double>(chunk);
  b.ctr = c.take<uint64_t>(chunk);
  b.alive = c.take<uint8_t>(chunk);
  b.rmin = c.take<unsigned long long>(m);
  b.rid = c.take<uint64_t>(m);
  b.thresh = c.take<double>(1);
  b.n_alive = c.take<unsigned long long>(1);
  b.used = c.used;
  return b;
}

unsigned blocks(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// The scratch of an update of n values in chunks of `chunk`: its arrays
// hold one chunk, at most n elements.
extern "C" int64_t bk_csetsketch_update_scratch(int64_t n, int64_t chunk,
                                                int64_t m) {
  return carve(nullptr, n < chunk ? n : chunk, m).used;
}

// values (n,) int64-held u64 into a sketch of m f64 registers; ids (m,)
// u64 and idcounts (m,) u32 are null unless the sketch keeps them (-S,
// -s).  chunk: elements a chunk (2^16).  scratch: the bytes that
// bk_csetsketch_update_scratch(n, chunk, m) gives.  Syncs the stream once
// a call, and once a round where a round is a launch.
extern "C" int bk_csetsketch_update(const void* values, int64_t n,
                                    int64_t chunk, int64_t m, void* regs,
                                    void* ids, void* idcounts, void* scratch,
                                    void* stream) {
  if (n < 0 || chunk <= 0 || m <= 0 || (idcounts && !ids))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const Buffers b = carve((char*)scratch, n < chunk ? n : chunk, m);
  const uint64_t* v = (const uint64_t*)values;
  double* rg = (double*)regs;
  auto* bits = (unsigned long long*)regs;
  const bool save = ids != nullptr;
  const uint64_t um = (uint64_t)m;
  double thresh = 0.0;
  unsigned long long live = 0;
  cudaError_t e;
#define BK_TRY(x)            \
  if ((e = (x)) != cudaSuccess) return (int)e
  if (save) BK_TRY(cudaMemsetAsync(b.rmin, 0xFF, 8 * m, s));
  css_max<<<1, 1024, 0, s>>>(rg, um, b.thresh);
  BK_TRY(cudaMemcpyAsync(&thresh, b.thresh, 8, cudaMemcpyDeviceToHost, s));
  BK_TRY(cudaStreamSynchronize(s));
  bool saturated = std::isfinite(thresh);
  for (int64_t lo = 0; lo < n; lo += chunk) {
    const int64_t c = n - lo < chunk ? n - lo : chunk;
    const unsigned g = blocks(c);
    BK_TRY(cudaMemsetAsync(b.t, 0, 8 * c, s));
    BK_TRY(cudaMemsetAsync(b.ctr, 0, 8 * c, s));
    BK_TRY(cudaMemsetAsync(b.alive, 1, c, s));
    if (!save && saturated) {  // every element to its stop, no sync
      css_round<kMin><<<g, kThreads, 0, s>>>(v + lo, c, um, 0, b.thresh, b.t,
                                            b.ctr, b.alive, bits, nullptr,
                                            b.n_alive);
      css_max<<<1, 1024, 0, s>>>(rg, um, b.thresh);
      continue;
    }
    do {
      BK_TRY(cudaMemsetAsync(b.n_alive, 0, 8, s));
      if (save) {
        css_round<kRoundMin><<<g, kThreads, 0, s>>>(
            v + lo, c, um, 1, b.thresh, b.t, b.ctr, b.alive, b.rmin, nullptr,
            b.n_alive);
        css_round<kRoundArg><<<g, kThreads, 0, s>>>(
            v + lo, c, um, 1, b.thresh, b.t, b.ctr, b.alive, b.rmin, b.rid,
            b.n_alive);
        css_finalize<<<blocks(m), kThreads, 0, s>>>(
            um, rg, (uint64_t*)ids, (uint32_t*)idcounts, b.rmin, b.rid);
      } else {
        css_round<kMin><<<g, kThreads, 0, s>>>(
            v + lo, c, um, saturated ? 0 : 1, b.thresh, b.t, b.ctr, b.alive,
            bits, nullptr, b.n_alive);
      }
      css_max<<<1, 1024, 0, s>>>(rg, um, b.thresh);
      BK_TRY(cudaMemcpyAsync(&live, b.n_alive, 8, cudaMemcpyDeviceToHost, s));
      BK_TRY(cudaMemcpyAsync(&thresh, b.thresh, 8, cudaMemcpyDeviceToHost, s));
      BK_TRY(cudaStreamSynchronize(s));
      saturated = std::isfinite(thresh);
    } while (live);
  }
#undef BK_TRY
  return (int)cudaGetLastError();
}
