// KB2 sort_unique: the sorted distinct emitted keys of one build chunk,
// padded with U64_MAX (pad = 1) to a capacity, and their count n.
//
// Replaces bonsai_tpu/db/build_device.py _dedup_chunk_impl (:192-208): a
// two-key lax.sort of (key, pad), a drop of adjacent duplicates, a second
// sort.  There a real U64_MAX key orders before the pads because pad is a
// second sort key; here the same result comes without a 65-bit key, since
// pads never enter the sort: the first radix pass ranks only the emitted
// keys, and the pads are written after the distinct keys.
//
// What bounds it on an H100: the passes over device memory, and in each
// pass the latency of a tile's steps in order (load, rank, look-back,
// write) more than the bytes.  A least significant digit radix sort of
// 64-bit keys in 8-bit digits moves every key 8 times; at 4M keys a pass
// moves 67 MB, ~20 us at the card's bandwidth, and takes ~60 us, of which
// the look-back is ~10 and the scattered writes ~17.  The design is
// onesweep (Adinets & Merrill, 2022), one read and one write of the keys a
// pass, 12 launches a call:
//   1. memset of the counters and status words;
//   2. digit_hist reads (keys, emitted) once and counts all 8 digit
//      histograms of the emitted keys; its last block scans them into
//      digit bases and decides on the card which passes run: a pass whose
//      digit is the same for every key is the identity and is skipped
//      (the top digit of k <= 28 keys), except pass 0, which also does
//      the compaction.  It records each pass's source buffer, so no pass
//      and no later kernel waits for the host;
//   3. 8 onesweep_pass launches.  A block takes its tile of 4096 keys from
//      an atomic counter, ranks the tile stably by digit in shared memory
//      (each warp ranks its 512 keys in order, 32 at a time: the lanes
//      that share a digit find each other with __match_any_sync, and the
//      highest of them moves the warp's count of that digit), publishes
//      its per-digit counts, finds its global offset per digit by
//      decoupled look-back over the earlier tiles' status words, and
//      writes the tile out in runs of equal digits.  Pass 0 reads
//      (keys, emitted) directly and ranks only the emitted keys;
//   4. dedup_runs flags the first key of each run of equal keys, finds
//      each tile's output offset by the same look-back over flag counts,
//      writes the distinct keys and n, all with coalesced accesses;
//   5. fill_pads sets slots [n, cap) to key U64_MAX, pad 1.
// Tile ids come from a counter, not blockIdx, and the status words, their
// relaxed polling and the back-off are lookback.cuh's (shared with KB3), so
// a chunk holds fewer than 2^30 keys; global offsets are 64-bit.
//
// KS3 sort_count (bk_sort_count) shares steps 1-4 and replaces step 5 with
// a run-length step.  It replaces bonsai_tpu/sketch/shs.py count_hashes
// (:48-57): np.sort, a drop of adjacent duplicates and np.diff of the run
// starts, counts saturated at 0xFFFF.  dedup_runs also writes the sorted
// index of each distinct key, and run_lengths turns two neighbours of
// those into a run's length, a u16 saturated at 0xFFFF.

#include <cstdint>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 16;    // keys a thread holds
constexpr int64_t kTile = (int64_t)kThreads * kPerLane;  // keys per tile
constexpr int kBins = 256;
constexpr int kPasses = 8;      // 8-bit digits of a 64-bit key
constexpr int kMinBlocks = 3;   // resident pass blocks an SM: <= 80 registers
constexpr int kHistTiles = 2;   // tiles a histogram block reads
static_assert(kThreads == kBins, "thread t owns digit t");
static_assert(kPerLane % 2 == 0, "ranks are packed two to a word");

using bk::look_back;
using bk::publish;

// ctrl[p] for pass p >= 1: -1 skipped, else the buffer it reads (0 = a,
// 1 = b) and writes the other; pass 0 reads the input and writes a;
// ctrl[kPasses]: the buffer that holds the sorted keys.
__global__ void __launch_bounds__(kThreads)
    digit_hist(const uint64_t* __restrict__ keys,
               const uint8_t* __restrict__ emitted, int64_t E,
               uint32_t* __restrict__ hist, uint32_t* __restrict__ done,
               int64_t* __restrict__ digit_base, int64_t* __restrict__ m_out,
               int32_t* __restrict__ ctrl) {
  using Scan = cub::BlockScan<int64_t, kThreads>;
  __shared__ uint32_t h[kPasses][kBins];
  __shared__ typename Scan::TempStorage tmp;
  __shared__ bool last;
  const int t = threadIdx.x;
  for (int d = 0; d < kPasses; ++d) h[d][t] = 0;
  __syncthreads();
  for (int it = 0; it < kHistTiles; ++it) {
    const int64_t base = ((int64_t)blockIdx.x * kHistTiles + it) * kTile;
    bool e[kPerLane];
    uint64_t k[kPerLane];
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {  // keys and flags in one round trip
      const int64_t i = base + r * kThreads + t;
      e[r] = i < E && emitted[i];
      k[r] = i < E ? keys[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < kPerLane; ++r)
      if (e[r])
#pragma unroll
        for (int d = 0; d < kPasses; ++d)
          atomicAdd(&h[d][(k[r] >> (8 * d)) & 0xFF], 1u);
  }
  __syncthreads();
  for (int d = 0; d < kPasses; ++d)
    if (h[d][t]) atomicAdd(&hist[d * kBins + t], h[d][t]);
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: digit bases, m, and which passes run
  __threadfence();
  bool trivial[kPasses];
  int64_t m = 0;
  for (int d = 0; d < kPasses; ++d) {
    const int64_t c = __ldcg(&hist[d * kBins + t]);
    int64_t first;
    Scan(tmp).ExclusiveSum(c, first, m);
    digit_base[d * kBins + t] = first;
    trivial[d] = __syncthreads_or(c == m);  // also the barrier for tmp
  }
  if (t == 0) {
    *m_out = m;
    int cur = 0;
    ctrl[0] = 0;
    for (int d = 1; d < kPasses; ++d) {
      ctrl[d] = trivial[d] ? -1 : cur;
      if (!trivial[d]) cur ^= 1;
    }
    ctrl[kPasses] = cur;
  }
}

// One LSD pass over digit `pass`; FIRST: pass 0, which reads the input
// keys and the emitted mask.
template <bool FIRST>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    onesweep_pass(int pass, const uint64_t* __restrict__ keys,
                  const uint8_t* __restrict__ emitted, int64_t E,
                  uint64_t* a, uint64_t* b, const int64_t* __restrict__ m_ptr,
                  const int32_t* __restrict__ ctrl,
                  const int64_t* __restrict__ digit_base,
                  uint32_t* __restrict__ tile_ctr, uint32_t* status) {
  using Scan = cub::BlockScan<int32_t, kThreads>;
  __shared__ uint64_t s_keys[kTile];
  __shared__ int32_t s_cnt[kWarps][kBins];  // per warp: running, then slot
  __shared__ int64_t s_off[kBins];          // out index - tile slot, a digit
  __shared__ typename Scan::TempStorage tmp;
  __shared__ uint32_t s_tile;
  const int src = ctrl[pass];
  if (src < 0) return;  // every key has the same digit: the identity
  const int t = threadIdx.x;
  if (t == 0) s_tile = atomicAdd(tile_ctr, 1u);
  const int w = t / 32, lane = t % 32;
  for (int d = lane; d < kBins; d += 32) s_cnt[w][d] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * kTile;
  const int64_t n = min(kTile, (FIRST ? E : *m_ptr) - base);
  if (n <= 0) return;  // the whole block: no later tile has keys either
  const uint64_t* in = FIRST ? keys : (src ? b : a);
  uint64_t* out = FIRST || src ? a : b;
  const int shift = 8 * pass;
  // 1. each warp ranks its 512 keys in order, 32 at a time
  const int64_t j0 = (int64_t)w * (32 * kPerLane) + lane;
  uint32_t ok = 0;  // bit r: key r is a key of this pass
  uint64_t key[kPerLane];
  uint32_t rank[kPerLane / 2];  // warp-local ranks, two 16-bit halves
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {  // keys and flags in one round trip
    const int64_t j = j0 + r * 32;
    if (j < n && (!FIRST || emitted[base + j])) ok |= 1u << r;
    key[r] = j < n ? in[base + j] : 0;
  }
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const bool o = ok >> r & 1;
    const int d = o ? (int)((key[r] >> shift) & 0xFF) : kBins + lane;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const int leader = 31 - __clz(peers);
    int c = 0;
    if (o && lane == leader) {
      c = s_cnt[w][d];
      s_cnt[w][d] = c + __popc(peers);
    }
    __syncwarp();
    c = __shfl_sync(0xFFFFFFFFu, c, leader) + __popc(peers & below);
    if (r % 2 == 0)
      rank[r / 2] = (uint32_t)c;
    else
      rank[r / 2] |= (uint32_t)c << 16;
  }
  __syncthreads();
  // 2. thread t owns digit t: the tile's count, published at once so that
  //    later tiles can go on, then the warps' slots
  int32_t count = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) count += s_cnt[v][t];
  publish(status + t, tile, kBins, (uint32_t)count);
  int32_t first, kept;
  Scan(tmp).ExclusiveSum(count, first, kept);
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    const int32_t c = s_cnt[v][t];
    s_cnt[v][t] = first;
    first += c;
  }
  __syncthreads();
  // 3. the tile sorted by digit, stably, in shared memory
#pragma unroll
  for (int r = 0; r < kPerLane; ++r)
    if (ok >> r & 1) {
      const int d = (int)((key[r] >> shift) & 0xFF);
      s_keys[s_cnt[w][d] + (rank[r / 2] >> (16 * (r % 2)) & 0xFFFF)] = key[r];
    }
  // 4. the look-back: the count of digit t in all earlier tiles
  const uint32_t before = look_back(status + t, tile, kBins, (uint32_t)count);
  s_off[t] = digit_base[t + pass * kBins] + before - (first - count);
  __syncthreads();
  // 5. out in runs of equal digits
#pragma unroll 4
  for (int p = t; p < kept; p += kThreads) {
    const uint64_t k = s_keys[p];
    out[s_off[(k >> shift) & 0xFF] + p] = k;
  }
}

// Thread t holds keys base + r * kThreads + t, r < kPerLane: loads and
// stores are coalesced.  Distinct keys are written in (r, warp, lane)
// order, which is index order.  STARTS: each distinct key's index in the
// sorted keys goes to starts (sort_count).
template <bool STARTS>
__global__ void __launch_bounds__(kThreads)
    dedup_runs(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
               const int32_t* __restrict__ ctrl,
               const int64_t* __restrict__ m_ptr,
               uint32_t* __restrict__ tile_ctr, uint32_t* status,
               uint64_t* __restrict__ out, int64_t* __restrict__ n_out,
               uint32_t* __restrict__ starts) {
  using Scan = cub::BlockScan<int32_t, kThreads>;
  constexpr int kGroups = kPerLane * kWarps;  // (r, warp) groups of 32
  static_assert(kGroups <= kThreads, "one group count a thread");
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int32_t s_grp[kGroups];  // flags in a group, then its offset
  __shared__ uint32_t s_tile, s_before;
  const int t = threadIdx.x;
  const int w = t / 32, lane = t % 32;
  if (t == 0) s_tile = atomicAdd(tile_ctr, 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t m = *m_ptr;
  const int64_t base = tile * kTile;
  if (base >= m) {
    if (tile == 0 && t == 0) *n_out = 0;  // no emitted key at all
    return;
  }
  const uint64_t* k = ctrl[kPasses] ? b : a;
  uint64_t key[kPerLane];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int64_t i = base + r * kThreads + t;
    key[r] = i < m ? k[i] : 0;
  }
  unsigned bal[kPerLane];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int64_t i = base + r * kThreads + t;
    uint64_t prev = __shfl_up_sync(0xFFFFFFFFu, key[r], 1);
    if (lane == 0 && i > 0 && i < m) prev = k[i - 1];
    const bool f = i < m && (i == 0 || key[r] != prev);
    bal[r] = __ballot_sync(0xFFFFFFFFu, f);
    if (lane == 0) s_grp[r * kWarps + w] = __popc(bal[r]);
  }
  __syncthreads();
  int32_t off, kept;
  Scan(tmp).ExclusiveSum(t < kGroups ? s_grp[t] : 0, off, kept);
  __syncthreads();  // every group count is read before it is overwritten
  if (t < kGroups) s_grp[t] = off;
  if (t == 0) {
    publish(status, tile, 1, (uint32_t)kept);
    s_before = look_back(status, tile, 1, (uint32_t)kept);
  }
  __syncthreads();
  const int64_t before = s_before;
  const unsigned lt = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r)
    if (bal[r] >> lane & 1) {
      const int64_t o = before + s_grp[r * kWarps + w] + __popc(bal[r] & lt);
      out[o] = key[r];
      if (STARTS) starts[o] = (uint32_t)(base + r * kThreads + t);
    }
  if (t == 0 && base + kTile >= m) *n_out = before + kept;
}

// sort_count: the length of run j, from its start and the next run's (or
// the m sorted keys), saturated at 0xFFFF.
__global__ void run_lengths(const uint32_t* __restrict__ starts,
                            const int64_t* __restrict__ n_ptr,
                            const int64_t* __restrict__ m_ptr,
                            uint16_t* __restrict__ counts) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n = *n_ptr;
  if (j >= n) return;
  const int64_t end = j + 1 < n ? (int64_t)starts[j + 1] : *m_ptr;
  const int64_t len = end - (int64_t)starts[j];
  counts[j] = (uint16_t)(len < 0xFFFF ? len : 0xFFFF);
}

// A block of 256 threads covers 2048 slots: thread t the 8 pad bytes from
// 8 t on (one 8-byte store), and the keys 256 e + t, e < 8 (coalesced).
// cap is a multiple of 8 and pad 8-byte aligned.
__global__ void fill_pads(uint64_t* __restrict__ keys,
                          uint8_t* __restrict__ pad,
                          const int64_t* __restrict__ n_ptr, int64_t cap) {
  const int64_t base = (int64_t)blockIdx.x * 2048;
  const int t = threadIdx.x;
  const int64_t n = *n_ptr;
  const int64_t i0 = base + 8 * t;
  if (i0 < cap) {
    uint32_t p[2] = {0, 0};  // the 8 pad bytes, little-endian
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (i0 + e >= n) p[e / 4] |= 1u << (8 * (e % 4));
    *(uint2*)(pad + i0) = make_uint2(p[0], p[1]);
  }
  if (base + 2048 <= n) return;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int64_t i = base + 256 * e + t;
    if (i >= n && i < cap) keys[i] = ~0ull;
  }
}

// Scratch: a region cleared on every call (histograms, the last-block
// counter, a tile counter per kernel, status words), then the digit bases,
// m, the pass control words, the two key buffers and, for sort_count, the
// run starts.
struct Buffers {
  uint32_t* zero;
  int64_t zero_words;
  int64_t* digit_base;
  int64_t* m;
  int32_t* ctrl;
  uint64_t* a;
  uint64_t* b;
  uint32_t* starts;
  int64_t used;
};

int64_t tiles_of(int64_t E) { return (E + kTile - 1) / kTile; }

Buffers carve(char* p, int64_t E, bool starts = false) {
  const int64_t ntiles = tiles_of(E);
  bk::Carve c{p};
  Buffers b;
  b.zero_words = kPasses * kBins + 1 + (kPasses + 1) +
                 ((int64_t)kPasses * kBins + 1) * ntiles;
  b.zero = c.take<uint32_t>(b.zero_words);
  b.digit_base = c.take<int64_t>(kPasses * kBins);
  b.m = c.take<int64_t>(1);
  b.ctrl = c.take<int32_t>(kPasses + 1);
  b.a = c.take<uint64_t>(E);
  b.b = c.take<uint64_t>(E);
  b.starts = starts ? c.take<uint32_t>(E) : nullptr;
  b.used = c.used;
  return b;
}

unsigned blocks(int64_t n, int t = 256) { return (unsigned)((n + t - 1) / t); }

// Steps 1-4 on E > 0 keys: the sorted distinct emitted keys into out,
// their count into n, and with b.starts each one's sorted index.
cudaError_t sort_dedup(const void* keys, const void* emitted, int64_t E,
                       const Buffers& b, uint64_t* out, int64_t* n,
                       cudaStream_t s) {
  const int64_t ntiles = tiles_of(E);
  uint32_t* hist = b.zero;
  uint32_t* done = hist + kPasses * kBins;
  uint32_t* tile_ctr = done + 1;  // one per pass, then dedup_runs'
  uint32_t* status = tile_ctr + kPasses + 1;
  uint32_t* dedup_status = status + (int64_t)kPasses * kBins * ntiles;
  const cudaError_t e = cudaMemsetAsync(b.zero, 0, b.zero_words * 4, s);
  if (e != cudaSuccess) return e;
  const int64_t hist_blocks = (ntiles + kHistTiles - 1) / kHistTiles;
  digit_hist<<<(unsigned)hist_blocks, kThreads, 0, s>>>(
      (const uint64_t*)keys, (const uint8_t*)emitted, E, hist, done,
      b.digit_base, b.m, b.ctrl);
  for (int pass = 0; pass < kPasses; ++pass) {
    auto* kern = pass ? onesweep_pass<false> : onesweep_pass<true>;
    kern<<<(unsigned)ntiles, kThreads, 0, s>>>(
        pass, (const uint64_t*)keys, (const uint8_t*)emitted, E, b.a, b.b,
        b.m, b.ctrl, b.digit_base, tile_ctr + pass,
        status + (int64_t)pass * kBins * ntiles);
  }
  if (b.starts)
    dedup_runs<true><<<(unsigned)ntiles, kThreads, 0, s>>>(
        b.a, b.b, b.ctrl, b.m, tile_ctr + kPasses, dedup_status, out, n,
        b.starts);
  else
    dedup_runs<false><<<(unsigned)ntiles, kThreads, 0, s>>>(
        b.a, b.b, b.ctrl, b.m, tile_ctr + kPasses, dedup_status, out, n,
        nullptr);
  return cudaSuccess;
}

}  // namespace

extern "C" int64_t bk_sort_unique_scratch(int64_t E) {
  return carve(nullptr, E).used;
}

// keys (E,) int64-held u64, emitted (E,) bool -> out_keys (cap,) int64,
// out_pad (cap,) uint8, n_out int64 scalar; cap >= E, E < 2^30, cap a
// multiple of 8.
extern "C" int bk_sort_unique(const void* keys, const void* emitted,
                              int64_t E, int64_t cap, void* out_keys,
                              void* out_pad, void* n_out, void* scratch,
                              void* stream) {
  if (E < 0 || E >= bk::kMaxCount || cap < E || cap % 8 ||
      (uintptr_t)out_pad % 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  uint64_t* ok = (uint64_t*)out_keys;
  int64_t* n = (int64_t*)n_out;
  const cudaError_t e =
      E > 0 ? sort_dedup(keys, emitted, E, carve((char*)scratch, E), ok, n, s)
            : cudaMemsetAsync(n, 0, sizeof(int64_t), s);
  if (e != cudaSuccess) return (int)e;
  fill_pads<<<blocks(cap, 2048), 256, 0, s>>>(ok, (uint8_t*)out_pad, n, cap);
  return (int)cudaGetLastError();
}

extern "C" int64_t bk_sort_count_scratch(int64_t E) {
  return carve(nullptr, E, true).used;
}

// KS3: keys (E,) int64-held u64, emitted (E,) bool -> the n distinct
// emitted keys in unsigned order in out_keys[:n] (E,) int64, each one's
// count of copies saturated at 0xFFFF in out_counts[:n] (E,) u16, n in
// n_out (int64 scalar); E < 2^30.
extern "C" int bk_sort_count(const void* keys, const void* emitted, int64_t E,
                             void* out_keys, void* out_counts, void* n_out,
                             void* scratch, void* stream) {
  if (E < 0 || E >= bk::kMaxCount) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int64_t* n = (int64_t*)n_out;
  if (E == 0) return (int)cudaMemsetAsync(n, 0, sizeof(int64_t), s);
  const Buffers b = carve((char*)scratch, E, true);
  const cudaError_t e =
      sort_dedup(keys, emitted, E, b, (uint64_t*)out_keys, n, s);
  if (e != cudaSuccess) return (int)e;
  run_lengths<<<blocks(E), 256, 0, s>>>(b.starts, n, b.m,
                                        (uint16_t*)out_counts);
  return (int)cudaGetLastError();
}
