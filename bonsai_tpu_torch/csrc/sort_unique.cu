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
// order, which is index order.
__global__ void __launch_bounds__(kThreads)
    dedup_runs(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
               const int32_t* __restrict__ ctrl,
               const int64_t* __restrict__ m_ptr,
               uint32_t* __restrict__ tile_ctr, uint32_t* status,
               uint64_t* __restrict__ out, int64_t* __restrict__ n_out) {
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
    }
  if (t == 0 && base + kTile >= m) *n_out = before + kept;
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
// m, the pass control words and the two key buffers.
struct Buffers {
  uint32_t* zero;
  int64_t zero_words;
  int64_t* digit_base;
  int64_t* m;
  int32_t* ctrl;
  uint64_t* a;
  uint64_t* b;
  int64_t used;
};

int64_t tiles_of(int64_t E) { return (E + kTile - 1) / kTile; }

Buffers carve(char* p, int64_t E) {
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
  b.used = c.used;
  return b;
}

unsigned blocks(int64_t n, int t = 256) { return (unsigned)((n + t - 1) / t); }

// Steps 1-4 on E > 0 keys: the sorted distinct emitted keys into out,
// their count into n.
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
  dedup_runs<<<(unsigned)ntiles, kThreads, 0, s>>>(
      b.a, b.b, b.ctrl, b.m, tile_ctr + kPasses, dedup_status, out, n);
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


// ---------------------------------------------------------------------------
// KS3 sort_count: the sorted distinct emitted keys in unsigned order and
// each one's count of copies saturated at 0xFFFF.  Replaces
// bonsai_tpu/sketch/shs.py count_hashes (:48-57): np.sort, a drop of
// adjacent duplicates and np.diff of the run starts.
//
// Its keys are rolling hashes, close to uniform over 64 bits, so it
// partitions them by their top b bits (2^b buckets averaging at most
// kBucketMean keys, b from E: sort_count_plan in sketch/shs.py is the same
// plan) and finishes each bucket in shared memory.  Three launches and a
// memset; the keys go through device memory twice in and once out, where
// KB2's onesweep moves them 8 times each way:
//   1. sc_hist counts the emitted keys of each bucket (shared-memory
//      counts, added to the device's); its last block scans them into
//      bucket starts;
//   2. sc_scatter moves each emitted key into its bucket's range: a block
//      counts its 8192 keys by bucket in shared memory (a key's rank in
//      its bucket comes from the shared atomicAdd), stages them there by
//      bucket, reserves each bucket's run with one device atomicAdd and
//      writes the runs out in order (from registers, a warp's 32 stores
//      would land in 32 buckets).  The order inside a bucket is not
//      stable: equal keys are interchangeable for a count;
//   3. sc_finish: two blocks of 512 threads an SM take buckets in order
//      from a counter.  A bucket of at most kCap keys whose next 11 bits
//      split it into runs of at most kSmall keys (all but certain for
//      hashes) goes into shared memory by those bits, each run sorted by
//      one thread (insertion), and its runs of equal keys counted there.
//      Any other bucket (skewed keys, a bucket past shared memory) is
//      sorted in place by the block alone: a stable least significant
//      digit radix sort, 8-bit digits through device memory, skipping a
//      digit every key of the bucket shares (keys of one value skip them
//      all); it is right at any size and slower.  Either way the block
//      publishes the bucket's distinct count, finds its output offset by
//      a decoupled look-back over the earlier buckets' status words
//      (lookback.cuh's words, read by a warp), and writes the distinct
//      keys and their u16 counts; the last bucket writes n.
// Buckets differ in their top bits, so no run of equal keys crosses two,
// and bucket order is unsigned order (bit 63 last).
namespace {

constexpr int kScThreads = 512;       // sc_hist and sc_scatter blocks
constexpr int kScPerLane = 16;        // keys a scatter thread holds
constexpr int64_t kScTile = (int64_t)kScThreads * kScPerLane;
constexpr int64_t kScHistKeys = 2 * kScTile;  // keys a histogram block reads
constexpr int kMaxBucketBits = 13;
constexpr int kMaxBuckets = 1 << kMaxBucketBits;
constexpr int64_t kBucketMean = 5120;   // planned keys a bucket at most
constexpr int kFin = 512;              // sc_finish threads
constexpr int kFinPerSM = 2;           // sc_finish blocks an SM
constexpr int kCap = 10240;            // keys of a bucket in shared memory
constexpr int kSubBits = 11;           // the split inside a bucket
constexpr int kSubBins = 1 << kSubBits;
constexpr int kSubPer = kSubBins / kFin;  // sub-buckets a thread sorts
constexpr int kSmall = 32;             // largest run sorted by insertion
constexpr int kRows = kCap / kFin;     // keys a thread holds in the counts
constexpr int kGenPerLane = 4;         // general path: keys a thread a tile
constexpr int kGenWarps = kFin / 32;
constexpr int kGenTile = kFin * kGenPerLane;
// shared memory of sc_finish: the fast path's keys, then its sub-bucket
// offsets and cursors, which its run starts (u16) replace
constexpr int kAuxBytes =
    2 * kSubBins * 4 > kCap * 2 ? 2 * kSubBins * 4 : kCap * 2;
constexpr int kFinSmem = kCap * 8 + kAuxBytes;
static_assert(kSubPer * kFin == kSubBins, "a thread owns kSubPer bins");
static_assert(kRows * kFin == kCap, "kCap keys in kRows rows");
static_assert(kRows * kGenWarps <= kFin, "one row-group count a thread");
static_assert(kMaxBuckets % kScThreads == 0, "whole bins a scan thread");
static_assert(kCap < 65536, "run starts fit in u16");
static_assert(8 * 256 * 4 + kGenWarps * kBins * 4 + kGenTile * 8 +
                  2 * kBins * 4 <= kFinSmem,
              "the general path fits in the fast path's shared memory");

int bucket_bits(int64_t E) {
  int b = 1;
  while (b < kMaxBucketBits && (E >> b) > kBucketMean) ++b;
  return b;
}

__global__ void __launch_bounds__(kScThreads)
    sc_hist(const uint64_t* __restrict__ keys,
            const uint8_t* __restrict__ emitted, int64_t E, int shift, int nb,
            uint32_t* __restrict__ hist, uint32_t* __restrict__ done,
            uint32_t* __restrict__ start, uint32_t* __restrict__ cursor) {
  using Scan = cub::BlockScan<uint32_t, kScThreads>;
  __shared__ uint32_t h[kMaxBuckets];
  __shared__ typename Scan::TempStorage tmp;
  __shared__ bool last;
  const int t = threadIdx.x;
  for (int j = t; j < nb; j += kScThreads) h[j] = 0;
  __syncthreads();
  for (int it = 0; it < 2; ++it) {
    const int64_t base = (int64_t)blockIdx.x * kScHistKeys + it * kScTile;
    bool e[kScPerLane];
    uint64_t k[kScPerLane];
#pragma unroll
    for (int r = 0; r < kScPerLane; ++r) {  // keys and flags in one trip
      const int64_t i = base + r * kScThreads + t;
      e[r] = i < E && emitted[i];
      k[r] = i < E ? keys[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < kScPerLane; ++r)
      if (e[r]) atomicAdd(&h[k[r] >> shift], 1u);
  }
  __syncthreads();
  for (int j = t; j < nb; j += kScThreads)
    if (h[j]) atomicAdd(&hist[j], h[j]);
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: thread t scans buckets [t * per, (t + 1) * per)
  __threadfence();
  const int per = (nb + kScThreads - 1) / kScThreads;
  uint32_t sum = 0;
  for (int q = 0; q < per; ++q) {
    const int j = t * per + q;
    if (j < nb) sum += __ldcg(&hist[j]);
  }
  uint32_t first, total;
  Scan(tmp).ExclusiveSum(sum, first, total);
  for (int q = 0; q < per; ++q) {
    const int j = t * per + q;
    if (j < nb) {
      start[j] = cursor[j] = first;
      first += __ldcg(&hist[j]);
    }
  }
  if (t == 0) start[nb] = total;
}

// Shared memory of sc_scatter: the tile staged by bucket, then a u32 a
// bucket (its count, its offset in the tile, then its run's output index
// less that offset, modulo 2^32).
constexpr int kScatterSmem = (int)kScTile * 8 + kMaxBuckets * 4;
constexpr int kScBinsPer = kMaxBuckets / kScThreads;  // bins a thread scans

__global__ void __launch_bounds__(kScThreads)
    sc_scatter(const uint64_t* __restrict__ keys,
               const uint8_t* __restrict__ emitted, int64_t E, int shift,
               int nb, uint32_t* __restrict__ cursor,
               uint64_t* __restrict__ part) {
  using Scan = cub::BlockScan<uint32_t, kScThreads>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ typename Scan::TempStorage tmp;
  uint64_t* stage = (uint64_t*)smem;
  uint32_t* bin = (uint32_t*)(smem + kScTile * 8);
  const int t = threadIdx.x;
  for (int j = t; j < nb; j += kScThreads) bin[j] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kScTile;
  bool e[kScPerLane];
  uint64_t k[kScPerLane];
  uint32_t rank[kScPerLane];
#pragma unroll
  for (int r = 0; r < kScPerLane; ++r) {
    const int64_t i = base + r * kScThreads + t;
    e[r] = i < E && emitted[i];
    k[r] = i < E ? keys[i] : 0;
  }
#pragma unroll
  for (int r = 0; r < kScPerLane; ++r)
    rank[r] = e[r] ? atomicAdd(&bin[k[r] >> shift], 1u) : 0;
  __syncthreads();
  // thread t owns buckets [t * per, (t + 1) * per): their offsets in the
  // tile, then each one's run reserved in its bucket
  const int per = (nb + kScThreads - 1) / kScThreads;
  uint32_t cnt[kScBinsPer], sum = 0;
#pragma unroll
  for (int q = 0; q < kScBinsPer; ++q) {
    const int j = t * per + q;
    cnt[q] = q < per && j < nb ? bin[j] : 0;
    sum += cnt[q];
  }
  uint32_t first, kept;
  Scan(tmp).ExclusiveSum(sum, first, kept);
#pragma unroll
  for (int q = 0; q < kScBinsPer; ++q)
    if (q < per && t * per + q < nb) {
      bin[t * per + q] = first;
      first += cnt[q];
    }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kScPerLane; ++r)
    if (e[r]) stage[bin[k[r] >> shift] + rank[r]] = k[r];
  __syncthreads();  // every offset is read before it is overwritten
#pragma unroll
  for (int q = 0; q < kScBinsPer; ++q)
    if (cnt[q]) {
      const int j = t * per + q;
      bin[j] = atomicAdd(&cursor[j], cnt[q]) - bin[j];
    }
  __syncthreads();
  // out in runs of one bucket
  for (int p = t; p < (int)kept; p += kScThreads) {
    const uint64_t x = stage[p];
    part[bin[x >> shift] + (uint32_t)p] = x;
  }
}

// The general path's stable pass over one tile of n <= kGenTile keys at
// `in`, by the 8-bit digit at `shift`: key i of digit d goes to
// out[run[d] + (its rank among the tile's keys of digit d)], and run[d]
// grows by the tile's count.  As onesweep_pass, with a running base in
// place of the look-back.
__device__ void gen_tile(const uint64_t* __restrict__ in, int n,
                         uint64_t* __restrict__ out, int shift,
                         int32_t (*s_cnt)[kBins], uint64_t* s_keys,
                         uint32_t* run, int32_t* doff,
                         typename cub::BlockScan<int, kFin>::TempStorage& tmp) {
  using Scan = cub::BlockScan<int, kFin>;
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  for (int d = lane; d < kBins; d += 32) s_cnt[w][d] = 0;
  __syncthreads();
  const int j0 = w * (32 * kGenPerLane) + lane;
  uint32_t ok = 0;
  uint64_t key[kGenPerLane];
  int rank[kGenPerLane];
#pragma unroll
  for (int r = 0; r < kGenPerLane; ++r) {
    const int j = j0 + r * 32;
    if (j < n) ok |= 1u << r;
    key[r] = j < n ? in[j] : 0;
  }
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < kGenPerLane; ++r) {
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
    rank[r] = __shfl_sync(0xFFFFFFFFu, c, leader) + __popc(peers & below);
  }
  __syncthreads();
  int count = 0;
  if (t < kBins)
    for (int v = 0; v < kGenWarps; ++v) count += s_cnt[v][t];
  int first, kept;
  Scan(tmp).ExclusiveSum(count, first, kept);
  if (t < kBins) {
    doff[t] = (int32_t)run[t] - first;
    run[t] += count;
    for (int v = 0; v < kGenWarps; ++v) {
      const int c = s_cnt[v][t];
      s_cnt[v][t] = first;
      first += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kGenPerLane; ++r)
    if (ok >> r & 1) {
      const int d = (int)((key[r] >> shift) & 0xFF);
      s_keys[s_cnt[w][d] + rank[r]] = key[r];
    }
  __syncthreads();
  for (int p = t; p < kept; p += kFin) {
    const uint64_t k = s_keys[p];
    out[doff[(k >> shift) & 0xFF] + p] = k;
  }
  __syncthreads();  // s_cnt, s_keys and doff are free for the next tile
}

// The output offset of bucket j with d distinct keys (published already),
// from the earlier buckets' counts; the last bucket writes n.  A wave of
// blocks publishes its counts at about the same time, so the walk back to
// the last inclusive prefix is long: warp 0 reads 32 status words a round
// trip (lookback.cuh's walk reads 8), and sums them once every word up to
// the nearest prefix is published.
__device__ __forceinline__ uint32_t place(uint32_t* status, int j, int nb,
                                          uint32_t d, int64_t* n_out,
                                          uint32_t* s_before) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint32_t sum = 0;
    for (int hi = j - 1; hi >= 0;) {
      const int q = hi - lane;  // lane 0 reads the nearest word
      const uint32_t v = q >= 0 ? bk::load_relaxed(status + q) : bk::kPrefix;
      const unsigned pre = __ballot_sync(0xFFFFFFFFu, v & bk::kPrefix);
      const unsigned pub = __ballot_sync(0xFFFFFFFFu, v != 0);
      const unsigned need = pre ? (2u << (__ffs(pre) - 1)) - 1 : ~0u;
      if ((pub & need) != need) {  // a word up to the prefix is empty
        __nanosleep(bk::kBackoffNs);
        continue;
      }
      uint32_t c = need >> lane & 1 ? v & bk::kCount : 0;
      for (int o = 16; o; o >>= 1) c += __shfl_xor_sync(0xFFFFFFFFu, c, o);
      sum += c;
      hi = pre ? -1 : hi - 32;
    }
    if (lane == 0) {
      if (j > 0) bk::store_release(status + j, bk::kPrefix | (sum + d));
      *s_before = sum;
      if (j == nb - 1) *n_out = (int64_t)sum + d;
    }
  }
  __syncthreads();
  return *s_before;
}

__global__ void __launch_bounds__(kFin, kFinPerSM)
    sc_finish(uint64_t* __restrict__ part, uint64_t* __restrict__ temp,
              const uint32_t* __restrict__ start, int nb, int shift,
              uint32_t* __restrict__ ticket, uint32_t* status,
              uint64_t* __restrict__ out_keys,
              uint16_t* __restrict__ out_counts,
              int64_t* __restrict__ n_out) {
  using Scan = cub::BlockScan<int, kFin>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ typename Scan::TempStorage tmp;
  __shared__ int s_grp[kFin];
  __shared__ uint32_t s_ticket, s_before;
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const unsigned lt = (1u << lane) - 1;
  uint64_t* s_keys = (uint64_t*)smem;
  uint32_t* s_off = (uint32_t*)(smem + kCap * 8);
  uint32_t* s_cur = s_off + kSubBins;
  uint16_t* s_start = (uint16_t*)(smem + kCap * 8);
  const int sub = shift - kSubBits;
  for (;;) {
    if (t == 0) s_ticket = atomicAdd(ticket, 1u);
    __syncthreads();
    const int j = (int)s_ticket;
    __syncthreads();
    if (j >= nb) return;
    const int64_t lo = start[j];
    const int S = (int)(start[j + 1] - lo);
    const uint64_t* src = part + lo;
    bool fast = S <= kCap;
    if (fast && S > 0) {
      // 1. the bucket's keys, read once into registers, counted by their
      //    next kSubBits bits
      for (int q = t; q < kSubBins; q += kFin) s_cur[q] = 0;
      uint64_t kr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int p = r * kFin + t;
        kr[r] = p < S ? src[p] : 0;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r * kFin + t < S)
          atomicAdd(&s_cur[(kr[r] >> sub) & (kSubBins - 1)], 1u);
      __syncthreads();
      int c[kSubPer], sum = 0;
      bool big = false;
#pragma unroll
      for (int q = 0; q < kSubPer; ++q) {
        c[q] = (int)s_cur[kSubPer * t + q];
        sum += c[q];
        big |= c[q] > kSmall;
      }
      fast = !__syncthreads_or(big);
      if (fast) {
        int first;
        Scan(tmp).ExclusiveSum(sum, first);
#pragma unroll
        for (int q = 0; q < kSubPer; ++q) {
          s_off[kSubPer * t + q] = s_cur[kSubPer * t + q] = (uint32_t)first;
          first += c[q];
        }
        __syncthreads();
        // 2. into shared memory by those bits, each run sorted by a thread
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r * kFin + t < S)
            s_keys[atomicAdd(&s_cur[(kr[r] >> sub) & (kSubBins - 1)], 1u)] =
                kr[r];
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kSubPer; ++q) {
          const int a = (int)s_off[kSubPer * t + q];
          const int b = (int)s_cur[kSubPer * t + q];
          for (int x = a + 1; x < b; ++x) {
            const uint64_t k = s_keys[x];
            int y = x - 1;
            while (y >= a && s_keys[y] > k) {
              s_keys[y + 1] = s_keys[y];
              --y;
            }
            s_keys[y + 1] = k;
          }
        }
        __syncthreads();
      }
    }
    if (fast) {
      // 3. the first key of each run, in (row, warp, lane) order, which is
      //    index order; a run's start goes to s_start[its rank]
      unsigned bal[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int p = r * kFin + t;
        const bool f = p < S && (p == 0 || s_keys[p] != s_keys[p - 1]);
        bal[r] = __ballot_sync(0xFFFFFFFFu, f);
        if (lane == 0) s_grp[r * kGenWarps + w] = __popc(bal[r]);
      }
      __syncthreads();  // the sub-bucket offsets are free: s_start from here
      int off, d;
      Scan(tmp).ExclusiveSum(t < kRows * kGenWarps ? s_grp[t] : 0, off, d);
      if (t == 0) publish(status, j, 1, (uint32_t)d);  // later buckets go on
      __syncthreads();
      if (t < kRows * kGenWarps) s_grp[t] = off;
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (bal[r] >> lane & 1)
          s_start[s_grp[r * kGenWarps + w] + __popc(bal[r] & lt)] =
              (uint16_t)(r * kFin + t);
      const uint32_t before = place(status, j, nb, (uint32_t)d, n_out,
                                   &s_before);  // its barrier orders s_start
      for (int o = t; o < d; o += kFin) {
        const int p = s_start[o];
        const int q = o + 1 < d ? s_start[o + 1] : S;
        out_keys[before + o] = s_keys[p];
        out_counts[before + o] = (uint16_t)(q - p < 0xFFFF ? q - p : 0xFFFF);
      }
      __syncthreads();  // shared memory is free for the next bucket
      continue;
    }
    // the general path: a stable LSD sort of [lo, lo + S) through part and
    // temp, 8-bit digits below the bucket bits, shared digits skipped
    uint32_t* g_hist = (uint32_t*)smem;                      // [8][256]
    auto* g_cnt = (int32_t(*)[kBins])(smem + 8 * kBins * 4);  // [32][256]
    uint64_t* g_keys = (uint64_t*)(smem + 8 * kBins * 4 +
                                   kGenWarps * kBins * 4);    // [kGenTile]
    uint32_t* g_run = (uint32_t*)(g_keys + kGenTile);         // [256]
    int32_t* g_doff = (int32_t*)(g_run + kBins);               // [256]
    const int ndig = (shift + 7) / 8;
    for (int q = t; q < 8 * kBins; q += kFin) g_hist[q] = 0;
    __syncthreads();
    for (int p = t; p < S; p += kFin) {
      const uint64_t k = src[p];
      for (int d = 0; d < ndig; ++d)
        atomicAdd(&g_hist[d * kBins + ((k >> (8 * d)) & 0xFF)], 1u);
    }
    __syncthreads();
    uint64_t* x = part + lo;
    uint64_t* y = temp + lo;
    for (int d = 0; d < ndig; ++d) {
      const uint32_t c = t < kBins ? g_hist[d * kBins + t] : 0;
      if (__syncthreads_or(c == (uint32_t)S)) continue;  // a shared digit
      int first;
      Scan(tmp).ExclusiveSum((int)c, first);
      if (t < kBins) g_run[t] = (uint32_t)first;
      __syncthreads();
      for (int b = 0; b < S; b += kGenTile)
        gen_tile(x + b, S - b < kGenTile ? S - b : kGenTile, y, 8 * d, g_cnt,
                 g_keys, g_run, g_doff, tmp);
      uint64_t* z = x;
      x = y;
      y = z;
    }
    // runs of the sorted keys in x: count, place, then the keys with each
    // run's start in y (as u32), then the counts from the starts
    int d = 0;
    for (int p = t; p < S; p += kFin) d += p == 0 || x[p] != x[p - 1];
    int unused;
    Scan(tmp).ExclusiveSum(d, unused, d);
    if (t == 0) publish(status, j, 1, (uint32_t)d);
    __syncthreads();
    const uint32_t before = place(status, j, nb, (uint32_t)d, n_out,
                                  &s_before);
    uint32_t* st = (uint32_t*)y;
    int run = 0;
    for (int b = 0; b < S; b += kFin) {
      const int p = b + t;
      const uint64_t k = p < S ? x[p] : 0;
      const int f = p < S && (p == 0 || k != x[p - 1]);
      int o, n;
      Scan(tmp).ExclusiveSum(f, o, n);
      __syncthreads();
      if (f) {
        out_keys[before + run + o] = k;
        st[run + o] = (uint32_t)p;
      }
      run += n;
    }
    __syncthreads();
    for (int o = t; o < d; o += kFin) {
      const int q = o + 1 < d ? (int)st[o + 1] : S;
      const int len = q - (int)st[o];
      out_counts[before + o] = (uint16_t)(len < 0xFFFF ? len : 0xFFFF);
    }
    __syncthreads();
  }
}

struct ScBuffers {
  uint32_t* zero;  // cleared on every call: hist, done, ticket, status
  int64_t zero_words;
  uint32_t* hist;
  uint32_t* done;
  uint32_t* ticket;
  uint32_t* status;
  uint32_t* start;
  uint32_t* cursor;
  uint64_t* part;
  uint64_t* temp;
  int64_t used;
};

ScBuffers sc_carve(char* p, int64_t E) {
  const int64_t nb = (int64_t)1 << bucket_bits(E);
  bk::Carve c{p};
  ScBuffers b;
  b.zero_words = 2 * nb + 2;
  b.zero = c.take<uint32_t>(b.zero_words);
  b.hist = b.zero;
  b.done = b.hist + nb;
  b.ticket = b.done + 1;
  b.status = b.ticket + 1;
  b.start = c.take<uint32_t>(nb + 1);
  b.cursor = c.take<uint32_t>(nb);
  b.part = c.take<uint64_t>(E);
  b.temp = c.take<uint64_t>(E);
  b.used = c.used;
  return b;
}

}  // namespace

extern "C" int64_t bk_sort_count_scratch(int64_t E) {
  return sc_carve(nullptr, E).used;
}

// KS3's plan: the bucket bits of E keys (sketch/shs.py sort_count_plan).
extern "C" int64_t bk_sort_count_bits(int64_t E) { return bucket_bits(E); }

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
  const int bits = bucket_bits(E);
  const int nb = 1 << bits, shift = 64 - bits;
  const ScBuffers b = sc_carve((char*)scratch, E);
  cudaError_t e = cudaMemsetAsync(b.zero, 0, b.zero_words * 4, s);
  if (e != cudaSuccess) return (int)e;
  int dev, sms;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(sc_scatter,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kScatterSmem)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(sc_finish,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kFinSmem)) != cudaSuccess)
    return (int)e;
  const auto* k = (const uint64_t*)keys;
  const auto* em = (const uint8_t*)emitted;
  sc_hist<<<blocks(E, (int)kScHistKeys), kScThreads, 0, s>>>(
      k, em, E, shift, nb, b.hist, b.done, b.start, b.cursor);
  sc_scatter<<<blocks(E, (int)kScTile), kScThreads, kScatterSmem, s>>>(
      k, em, E, shift, nb, b.cursor, b.part);
  sc_finish<<<nb < kFinPerSM * sms ? nb : kFinPerSM * sms, kFin, kFinSmem,
              s>>>(
      b.part, b.temp, b.start, nb, shift, b.ticket, b.status,
      (uint64_t*)out_keys, (uint16_t*)out_counts, n);
  return (int)cudaGetLastError();
}
