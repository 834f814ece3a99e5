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
// is at or past the threshold.
//
// Registers are f64 and positive (or +inf), so they order as their u64
// bits and the minimum is a 64-bit atomicMin on the bits.
//
// Two facts shape the design.
//  (a) Without ids, the final registers are the minimum over every
//      arrival of every element, whatever the moment an element stops, as
//      long as it stops only at a time at or past some value at or above
//      the registers' max then: every later arrival of that element is at
//      or above every register from then on, since the max only falls.
//  (b) An element's times only rise: t + s with s a running sum of gaps
//      >= 0, and rounding is monotone.  So an element may stop at its
//      first arrival at or past the threshold, in either mode: the JAX
//      round marks it dead (its last time is at or past the threshold)
//      and none of its later arrivals of the round count.
//
// The whole update is one cooperative launch (all blocks resident, so a
// grid-wide barrier is safe) and never waits for the host.
//
// Default mode.  While a register is +inf (a new sketch) the first chunk
// runs round by round as the JAX package does: every element's next 16
// arrivals into the registers (atomicMin), a barrier, the registers' max,
// a barrier.  Once the max is finite, by (a), order no longer matters:
// blocks take tiles of 2048 elements from a counter, in index order, and
// a thread carries each element to its first arrival at or past the
// threshold (b), one arrival an iteration, taking the next element as
// soon as one stops.  The threshold is a device word: every kRefresh
// tiles the block that takes the tile reads the m registers and lowers the
// word to their max.  A read of a register is never below its later
// values, so any such max is a valid threshold from then on; a stale one
// costs arrivals, never a result.
//
// ids (-S) and idcounts (-s) depend on the rounds, so that mode keeps them
// exactly, chunk by chunk, round by round:
//   A. each live element evaluates its round up to its first arrival at
//      or past the threshold (b); an arrival below it lowers the
//      register's round minimum rmin (atomicMin on the bits) and marks
//      the element a candidate; live elements are counted;
//   B. each candidate evaluates the round again, and where an arrival
//      equals its register's rmin it lowers rarg to its element index: of
//      tied arrivals the smallest element wins, as the JAX package's
//      lexsort keeps the first (alive position, step);
//   C. each register's owner thread applies the round as the JAX package
//      does (smaller -> register, id, count 1; equal with the same id ->
//      count + 1), and the grid's max of the registers becomes the next
//      round's threshold.
// C of one round runs beside A of the next (css_ids says why that stays
// exact), so a round costs two grid barriers.  A chunk ends after a round
// that leaves no element live.
//
// `log` is CUDA's double log (within 1 ulp of the true value), so a
// register can differ from numpy's in its last bits; ids, idcounts and the
// order of the work are the JAX package's.
// What bounds it on an H100: in -S mode the barriers (two a round, about
// one round a chunk once the sketch is full); in the default mode the
// integer and FP64 work of about 1.3 arrivals a value.

#include <cmath>
#include <cstdint>
#include <cub/block/block_reduce.cuh>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr uint64_t kMix1 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kMix2 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kMix3 = 0x94D049BB133111EBull;
constexpr int kSteps = 16;       // arrivals a round
constexpr int kThreads = 512;
// resident blocks an SM: -S / -s waits on barriers, which fewer blocks
// pass sooner; the default free run wants the threads (both measured)
constexpr int kIdsBlocksPerSM = 1, kDefaultBlocksPerSM = 2;
constexpr int kPerThread = 4;    // elements a thread takes from a tile
constexpr int64_t kTile = (int64_t)kThreads * kPerThread;
constexpr int kRefresh = 16;     // tiles between threshold refreshes (m 4096)
constexpr unsigned long long kNone = ~0ull;  // rmin: no arrival this round
constexpr uint32_t kNoArg = ~0u;
constexpr unsigned long long kInfBits = 0x7FF0000000000000ull;
constexpr uint8_t kLive = 1, kCand = 2;  // bits of an element's flags

using Reduce = cub::BlockReduce<unsigned long long, kThreads>;

struct MaxOp {
  __device__ __forceinline__ unsigned long long operator()(
      unsigned long long a, unsigned long long b) const {
    return a > b ? a : b;
  }
};

// Zeroed by the host before the launch.
struct Ctl {
  unsigned int bar_count;        // grid barrier: blocks arrived
  unsigned int bar_gen;          // grid barrier: generation
  unsigned int tile;             // free run: next tile
  unsigned int pad;
  unsigned long long thr[3];     // a round's threshold bits, by round % 3
  unsigned long long live[3];    // live elements after a round, by round % 3
  unsigned long long refresh;    // free run: ~ the lowest refreshed max
};

__device__ __forceinline__ uint64_t mix(uint64_t z) {
  z = (z ^ (z >> 30)) * kMix2;
  z = (z ^ (z >> 27)) * kMix3;
  return z ^ (z >> 31);
}

// x % m without a 64-bit divide (Barrett): inv = (2^64 - 1) / m makes
// umulhi(x, inv) at most one below x / m, so one correction is exact.
struct Mod {
  uint64_t m, inv;
  double md;
};

__device__ __forceinline__ Mod make_mod(uint64_t m) {
  return {m, ~0ull / m, __ull2double_rn(m)};
}

__device__ __forceinline__ void arrival(uint64_t h, uint64_t c, const Mod& m,
                                        double* gap, uint64_t* reg) {
  const uint64_t z = mix(h + kMix1 * (c + 1));
  const double u = (__ull2double_rn(z >> 11) + 1.0) * 0x1p-53;
  *gap = -log(u) / m.md;
  const uint64_t x = mix(z + kMix3);
  uint64_t r = x - __umul64hi(x, m.inv) * m.m;
  *reg = r >= m.m ? r - m.m : r;
}

__device__ __forceinline__ unsigned long long bits(double x) {
  return (unsigned long long)__double_as_longlong(x);
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Every block of the (cooperative, all resident) grid waits here for the
// others; their global writes before it are visible after it.
__device__ __forceinline__ void grid_sync(Ctl* ctl) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int gen = load_acquire(&ctl->bar_gen);
    __threadfence();
    if (atomicAdd(&ctl->bar_count, 1u) == gridDim.x - 1) {
      atomicExch(&ctl->bar_count, 0u);
      __threadfence();
      atomicAdd(&ctl->bar_gen, 1u);
    } else {
      while (load_acquire(&ctl->bar_gen) == gen) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// The max of the register bits r = first, first + stride, ... < m over the
// block, in thread 0.
__device__ __forceinline__ unsigned long long block_max(
    const unsigned long long* regs, uint64_t m, int64_t first, int64_t stride,
    typename Reduce::TempStorage& tmp) {
  unsigned long long mx = 0;
  for (int64_t r = first; r < (int64_t)m; r += stride) {
    const unsigned long long b = __ldcg(regs + r);
    mx = b > mx ? b : mx;
  }
  const unsigned long long out = Reduce(tmp).Reduce(mx, MaxOp());
  __syncthreads();  // tmp is free again
  return out;
}

__device__ __forceinline__ unsigned long long block_sum(
    unsigned long long x, typename Reduce::TempStorage& tmp) {
  const unsigned long long out = Reduce(tmp).Sum(x);
  __syncthreads();
  return out;
}

// Default mode once the registers' max is finite: every element, those
// below `carry` from the state of the rounds before, the rest from their
// first arrival.
__device__ void free_run(const uint64_t* __restrict__ v, int64_t n,
                         uint64_t m, unsigned long long* regs,
                         const double* __restrict__ t,
                         const uint64_t* __restrict__ ctr, int64_t carry,
                         unsigned long long thr, Ctl* ctl,
                         typename Reduce::TempStorage& tmp) {
  __shared__ unsigned int s_tile;
  const int tid = threadIdx.x;
  const Mod mod = make_mod(m);
  const int64_t refresh_every =
      kRefresh > (int64_t)(m / 256) ? kRefresh : (int64_t)(m / 256);
  for (;;) {
    if (tid == 0) s_tile = atomicAdd(&ctl->tile, 1u);
    __syncthreads();
    const int64_t tile = s_tile;
    __syncthreads();  // s_tile is read before the next tile overwrites it
    const int64_t base = tile * kTile;
    if (base >= n) return;
    if (tile > 0 && tile % refresh_every == 0) {
      const unsigned long long mx = block_max(regs, m, tid, kThreads, tmp);
      if (tid == 0) atomicMax(&ctl->refresh, ~mx);
    }
    // one arrival an iteration; a thread takes its next element of the
    // tile as soon as the one it holds stops
    int e = 0;
    bool have = false;
    uint64_t h = 0, c = 0;
    double tt = 0.0, s = 0.0, thresh = 0.0;
    int j = 0;
    for (;;) {
      if (!have) {
        const int64_t i = base + (int64_t)e * kThreads + tid;
        if (e++ == kPerThread || i >= n) break;
        tt = i < carry ? t[i] : 0.0;
        c = i < carry ? ctr[i] : 0;
        h = mix(v[i]);
        have = true;
        j = 0;
        const unsigned long long r = ~__ldcg(&ctl->refresh);
        thresh = __longlong_as_double((long long)(r < thr ? r : thr));
      }
      double g;
      uint64_t reg;
      arrival(h, c + j, mod, &g, &reg);
      s = j ? s + g : g;  // np.cumsum: the first sum is the first gap
      const double time = tt + s;
      if (!(time < thresh)) {  // (b): no later arrival counts
        have = false;
        continue;
      }
      const unsigned long long b = bits(time);
      if (b < __ldcg(regs + reg)) atomicMin(regs + reg, b);
      if (++j == kSteps) {
        tt = tt + s;
        c += kSteps;
        j = 0;
        const unsigned long long r = ~__ldcg(&ctl->refresh);
        thresh = __longlong_as_double((long long)(r < thr ? r : thr));
      }
    }
  }
}

// The threshold of the first round: the registers' max.
__device__ __forceinline__ unsigned long long first_threshold(
    const unsigned long long* regs, uint64_t m, Ctl* ctl,
    typename Reduce::TempStorage& tmp) {
  const int64_t gtid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const unsigned long long mx =
      block_max(regs, m, gtid, (int64_t)gridDim.x * kThreads, tmp);
  if (threadIdx.x == 0) atomicMax(&ctl->thr[0], mx);
  grid_sync(ctl);
  return __ldcg(&ctl->thr[0]);
}

// Default mode: rounds while a register is +inf, then the free run.  No
// element stops while the threshold is +inf, so those rounds are all
// chunk 0's, as in the JAX package.
__global__ void __launch_bounds__(kThreads, kDefaultBlocksPerSM)
    css_default(const uint64_t* __restrict__ v, int64_t n, int64_t chunk,
                uint64_t m, unsigned long long* regs, double* __restrict__ t,
                uint64_t* __restrict__ ctr, Ctl* ctl) {
  __shared__ typename Reduce::TempStorage tmp;
  const int64_t gtid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * kThreads;
  unsigned long long thr = first_threshold(regs, m, ctl, tmp);
  const Mod mod = make_mod(m);
  const int64_t cn = n < chunk ? n : chunk;
  int64_t round = 0;
  for (; thr == kInfBits; ++round) {
    for (int64_t i = gtid; i < cn; i += nthreads) {
      const uint64_t h = mix(v[i]);
      const double tt = round ? t[i] : 0.0;
      const uint64_t c = round ? ctr[i] : 0;
      double s = 0.0;
#pragma unroll 4
      for (int j = 0; j < kSteps; ++j) {  // every time is below +inf
        double g;
        uint64_t reg;
        arrival(h, c + j, mod, &g, &reg);
        s = j ? s + g : g;
        const unsigned long long b = bits(tt + s);
        if (b < __ldcg(regs + reg)) atomicMin(regs + reg, b);
      }
      t[i] = tt + s;
      ctr[i] = c + kSteps;
    }
    grid_sync(ctl);
    const unsigned long long mx = block_max(regs, m, gtid, nthreads, tmp);
    if (threadIdx.x == 0) atomicMax(&ctl->thr[(round + 1) % 3], mx);
    if (gtid == 0) ctl->thr[(round + 2) % 3] = 0;  // read two barriers ago
    grid_sync(ctl);
    thr = __ldcg(&ctl->thr[(round + 1) % 3]);
  }
  free_run(v, n, m, regs, t, ctr, round ? cn : 0, thr, ctl, tmp);  // (a)
}

// -S / -s: the rounds of every chunk, two barriers a round.  The apply of
// round r (C) runs beside the first pass of round r + 1 (A), which takes
// round r's threshold: it is at or above round r + 1's, so A's early stop
// and its candidates are a superset, and B and C filter them by the exact
// threshold.  An element A keeps live that the exact threshold ends has
// its times at or past every later threshold, so it adds no candidate and
// stops at its next arrival.  rmin and rarg alternate by round parity.
__global__ void __launch_bounds__(kThreads, kIdsBlocksPerSM)
    css_ids(const uint64_t* __restrict__ v, int64_t n, int64_t chunk,
            uint64_t m, unsigned long long* regs, uint64_t* ids,
            uint32_t* idc, double* __restrict__ t,
            uint64_t* __restrict__ ctr, uint8_t* __restrict__ flags,
            unsigned long long* rmin2, uint32_t* rarg2, Ctl* ctl) {
  __shared__ typename Reduce::TempStorage tmp;
  const int tid = threadIdx.x;
  const int64_t gtid = (int64_t)blockIdx.x * kThreads + tid;
  const int64_t nthreads = (int64_t)gridDim.x * kThreads;
  for (int64_t r = gtid; r < 2 * (int64_t)m; r += nthreads) {
    rmin2[r] = kNone;
    rarg2[r] = kNoArg;
  }
  unsigned long long thr_a = first_threshold(regs, m, ctl, tmp);
  const Mod mod = make_mod(m);
  int64_t lo = 0;         // round r's chunk
  bool fresh = true;
  bool apply = false;     // round r - 1 waits for its apply (C)
  int64_t lo_c = 0;       // round r - 1's chunk and exact threshold
  unsigned long long thr_c = 0;
  for (int64_t round = 0;; ++round) {
    const int slot = (int)(round % 3);
    const int64_t par = round & 1;
    unsigned long long* rmin = rmin2 + par * m;
    uint32_t* rarg = rarg2 + par * m;
    const int64_t cn = n - lo < chunk ? n - lo : chunk;
    const double thresh_a = __longlong_as_double((long long)thr_a);
    // A. round r up to each element's first arrival at thr_a
    unsigned long long live = 0;
    for (int64_t i = gtid; lo < n && i < cn; i += nthreads) {
      if (!fresh && !(flags[i] & kLive)) continue;
      const uint64_t h = mix(v[lo + i]);
      const double tt = fresh ? 0.0 : t[i];
      const uint64_t c = fresh ? 0 : ctr[i];
      double s = 0.0;
      bool stop = false, cand = false;
      for (int j = 0; j < kSteps; ++j) {
        double g;
        uint64_t reg;
        arrival(h, c + j, mod, &g, &reg);
        s = j ? s + g : g;
        const double time = tt + s;
        if (!(time < thresh_a)) {  // (b)
          stop = true;
          break;
        }
        const unsigned long long b = bits(time);
        if (b <= __ldcg(rmin + reg)) {  // it may be the round's minimum
          atomicMin(rmin + reg, b);
          cand = true;
        }
      }
      if (!stop && !cand) {  // a candidate's next state comes in B
        t[i] = tt + s;
        ctr[i] = c + kSteps;
      }
      flags[i] = (stop ? 0 : kLive) | (cand ? kCand : 0);
      live += !stop;
    }
    // C. round r - 1 applied to each register by its owner, and the max
    if (apply) {
      unsigned long long* pmin = rmin2 + (1 - par) * m;
      uint32_t* parg = rarg2 + (1 - par) * m;
      unsigned long long mx = 0;
      for (int64_t r = gtid; r < (int64_t)m; r += nthreads) {
        unsigned long long cur = __ldcg(regs + r);
        const unsigned long long b = pmin[r];
        if (b != kNone) {
          if (b < thr_c) {  // below round r - 1's exact threshold
            const uint64_t x = v[lo_c + parg[r]];
            if (b < cur) {
              regs[r] = cur = b;
              ids[r] = x;
              if (idc) idc[r] = 1;
            } else if (idc && b == cur && x == ids[r]) {
              idc[r] += 1;
            }
          }
          pmin[r] = kNone;
          parg[r] = kNoArg;
        }
        mx = cur > mx ? cur : mx;
      }
      mx = Reduce(tmp).Reduce(mx, MaxOp());
      __syncthreads();
      if (tid == 0) atomicMax(&ctl->thr[slot], mx);
    }
    if (lo >= n) break;  // the last apply is done
    live = block_sum(live, tmp);
    if (tid == 0 && live) atomicAdd(&ctl->live[slot], live);
    if (gtid == 0) {  // slots no block reads until this round is over
      ctl->thr[(round + 1) % 3] = 0;
      ctl->live[(round + 1) % 3] = 0;
    }
    grid_sync(ctl);
    const unsigned long long thr = __ldcg(&ctl->thr[slot]);  // round r's
    const double thresh = __longlong_as_double((long long)thr);
    // B. each register's arrival at its minimum with the smallest element
    for (int64_t i = gtid; i < cn; i += nthreads) {
      const uint8_t f = flags[i];
      if (!(f & kCand)) continue;
      const uint64_t h = mix(v[lo + i]);
      const double tt = fresh ? 0.0 : t[i];
      const uint64_t c = fresh ? 0 : ctr[i];
      double s = 0.0;
      for (int j = 0; j < kSteps; ++j) {
        double g;
        uint64_t reg;
        arrival(h, c + j, mod, &g, &reg);
        s = j ? s + g : g;
        const double time = tt + s;
        if (!(time < thresh_a)) break;
        if (time < thresh && bits(time) == __ldcg(rmin + reg))
          atomicMin(rarg + reg, (uint32_t)i);
      }
      if (f & kLive) {
        t[i] = tt + s;
        ctr[i] = c + kSteps;
      }
      flags[i] = f & kLive;
    }
    const bool done = __ldcg(&ctl->live[slot]) == 0;
    grid_sync(ctl);
    apply = true;
    lo_c = lo;
    thr_c = thr_a = thr;
    fresh = done;
    if (done) lo += chunk;
  }
}

struct Buffers {
  double* t;
  uint64_t* ctr;
  uint8_t* flags;
  unsigned long long* rmin;
  uint32_t* rarg;
  Ctl* ctl;
  int64_t used;
};

Buffers carve(char* p, int64_t chunk, int64_t m) {
  bk::Carve c{p};
  Buffers b;
  b.t = c.take<double>(chunk);
  b.ctr = c.take<uint64_t>(chunk);
  b.flags = c.take<uint8_t>(chunk);
  b.rmin = c.take<unsigned long long>(2 * m);
  b.rarg = c.take<uint32_t>(2 * m);
  b.ctl = c.take<Ctl>(1);
  b.used = c.used;
  return b;
}

// Blocks of the cooperative grid: all resident, at most `most` an SM.
cudaError_t grid_blocks(const void* kern, int most, int* out) {
  int dev, sms, per;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, kThreads,
                                                         0)) != cudaSuccess)
    return e;
  if (per < 1) return cudaErrorLaunchOutOfResources;
  *out = sms * (per < most ? per : most);
  return cudaSuccess;
}

}  // namespace

// The scratch of an update of n values in chunks of `chunk`: its arrays
// hold one chunk, at most n elements.
extern "C" int64_t bk_csetsketch_update_scratch(int64_t n, int64_t chunk,
                                                int64_t m) {
  return carve(nullptr, n < chunk ? n : chunk, m).used;
}

// values (n,) int64-held u64 into a sketch of m f64 registers; ids (m,)
// u64 and idcounts (m,) u32 are null unless the sketch keeps them (-S,
// -s).  chunk: elements a chunk (2^16), < 2^32.  scratch: the bytes that
// bk_csetsketch_update_scratch(n, chunk, m) gives.  A memset and one
// cooperative launch; no wait for the host.
extern "C" int bk_csetsketch_update(const void* values, int64_t n,
                                    int64_t chunk, int64_t m, void* regs,
                                    void* ids, void* idcounts, void* scratch,
                                    void* stream) {
  if (n < 0 || chunk <= 0 || chunk > (int64_t)kNoArg || m <= 0 ||
      (idcounts && !ids))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  Buffers b = carve((char*)scratch, n < chunk ? n : chunk, m);
  cudaError_t e = cudaMemsetAsync(b.ctl, 0, sizeof(Ctl), s);
  if (e != cudaSuccess) return (int)e;
  const uint64_t* v = (const uint64_t*)values;
  uint64_t um = (uint64_t)m;
  auto* bits = (unsigned long long*)regs;
  auto* id = (uint64_t*)ids;
  auto* idc = (uint32_t*)idcounts;
  void* dargs[] = {&v, &n, &chunk, &um, &bits, &b.t, &b.ctr, &b.ctl};
  void* iargs[] = {&v,     &n,      &chunk,   &um,     &bits,
                   &id,    &idc,    &b.t,     &b.ctr,  &b.flags,
                   &b.rmin, &b.rarg, &b.ctl};
  const void* kern = ids ? (const void*)css_ids : (const void*)css_default;
  int blocks;
  if ((e = grid_blocks(kern, ids ? kIdsBlocksPerSM : kDefaultBlocksPerSM,
                       &blocks)) != cudaSuccess)
    return (int)e;
  e = cudaLaunchCooperativeKernel(kern, dim3(blocks), dim3(kThreads),
                                  ids ? iargs : dargs, 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
