// KB2 sort_unique: the sorted distinct emitted keys of one build chunk,
// padded with U64_MAX (pad = 1) to a capacity, and their count n.
//
// Replaces bonsai_tpu/db/build_device.py _dedup_chunk_impl (:192-208): a
// two-key lax.sort of (key, pad), a drop of adjacent duplicates, a second
// sort.  There a real U64_MAX key orders before the pads because pad is a
// second sort key; here the same result comes without a 65-bit key:
//   1. compact the emitted keys to the front (exclusive scan + scatter),
//      so pads never enter the sort;
//   2. LSD radix sort of the m compacted keys as unsigned 64-bit, 8 passes
//      of 8-bit digits, each a stable scatter;
//   3. flag the first key of each run of equal keys;
//   4. scan the flags and scatter the firsts into the output;
//   5. set slots [n, cap) to key U64_MAX, pad 1.
// m and n stay on the card: every kernel reads them from device memory,
// and grids are sized by E, so nothing waits for the host.
//
// What bounds it on an H100: device memory traffic of the 8 radix passes
// (a pass reads the m keys twice and writes them once), about 24 B a key
// a pass.  The design: a block of 256 threads owns a tile of 4096 keys.
// A histogram kernel counts the tile's digits in shared memory; one
// device-wide scan over (digit, tile) counts gives every tile its bucket
// offsets.  The scatter kernel then sorts its tile by digit in shared
// memory, stably: each warp ranks its 512 keys in order, 32 at a time, by
// __match_any_sync against a warp-private running count per digit, and
// the warps' counts and a block scan over the digits place every key.
// The tile then leaves as runs of equal digits, so neighbouring threads
// write neighbouring addresses.  Offsets and sizes are 64-bit.

#include <cstdint>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;   // threads per block in the radix passes
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 16;    // keys a lane holds in the scatter
constexpr int64_t kTile = (int64_t)kThreads * kPerLane;  // keys per tile
constexpr int kBins = 256;

__global__ void compact_emitted(const uint64_t* __restrict__ keys,
                                const uint8_t* __restrict__ emitted,
                                const int64_t* __restrict__ off, int64_t E,
                                uint64_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < E && emitted[i]) out[off[i]] = keys[i];
}

__global__ void radix_hist(const uint64_t* __restrict__ keys,
                           const int64_t* __restrict__ m_ptr, int shift,
                           int64_t ntiles, int32_t* __restrict__ counts) {
  __shared__ int32_t c[kBins];
  c[threadIdx.x] = 0;
  __syncthreads();
  const int64_t tile = blockIdx.x;
  const int64_t base = tile * kTile;
  const int64_t end = min(base + kTile, *m_ptr);
  for (int64_t i = base + threadIdx.x; i < end; i += kThreads)
    atomicAdd(&c[(keys[i] >> shift) & 0xFF], 1);
  __syncthreads();
  counts[(int64_t)threadIdx.x * ntiles + tile] = c[threadIdx.x];
}

__global__ void radix_scatter(const uint64_t* __restrict__ in,
                              uint64_t* __restrict__ out,
                              const int64_t* __restrict__ m_ptr, int shift,
                              int64_t ntiles,
                              const int64_t* __restrict__ offs) {
  using Scan = cub::BlockScan<int32_t, kThreads>;
  __shared__ uint64_t s_keys[kTile];
  __shared__ int32_t s_cnt[kWarps][kBins];  // per warp: running, then prefix
  __shared__ int32_t s_base[kBins];         // first slot of a digit in the tile
  __shared__ int64_t s_out[kBins];          // global slot of that first one
  __shared__ typename Scan::TempStorage tmp;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t tile = blockIdx.x;
  const int64_t base = tile * kTile;
  const int64_t n = min(kTile, *m_ptr - base);
  if (n <= 0) return;  // the whole block: n is the same for every thread
  for (int d = lane; d < kBins; d += 32) s_cnt[w][d] = 0;
  s_out[threadIdx.x] = offs[(int64_t)threadIdx.x * ntiles + tile];
  __syncwarp();
  // 1. each warp ranks its 512 keys in order, 32 at a time
  const unsigned below = (1u << lane) - 1;
  uint64_t key[kPerLane];
  int rank[kPerLane];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int64_t j = (int64_t)w * (32 * kPerLane) + r * 32 + lane;
    const bool ok = j < n;
    key[r] = ok ? in[base + j] : 0;
    const int d = ok ? (int)((key[r] >> shift) & 0xFF) : kBins + lane;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    rank[r] = ok ? s_cnt[w][d] + __popc(peers & below) : 0;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) s_cnt[w][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // 2. thread t owns digit t: the warps' prefixes and the tile total
  const int t = threadIdx.x;
  int32_t total = 0;
  for (int v = 0; v < kWarps; ++v) {
    const int32_t c = s_cnt[v][t];
    s_cnt[v][t] = total;
    total += c;
  }
  int32_t first;
  Scan(tmp).ExclusiveSum(total, first);
  s_base[t] = first;
  __syncthreads();
  // 3. the tile sorted by digit, stably, in shared memory
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int64_t j = (int64_t)w * (32 * kPerLane) + r * 32 + lane;
    if (j < n) {
      const int d = (int)((key[r] >> shift) & 0xFF);
      s_keys[s_base[d] + s_cnt[w][d] + rank[r]] = key[r];
    }
  }
  __syncthreads();
  // 4. out in runs of equal digits
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const uint64_t k = s_keys[p];
    const int d = (int)((k >> shift) & 0xFF);
    out[s_out[d] + (p - s_base[d])] = k;
  }
}

__global__ void flag_first(const uint64_t* __restrict__ k,
                           const int64_t* __restrict__ m_ptr, int64_t E,
                           uint8_t* __restrict__ first) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  first[i] = i < *m_ptr && (i == 0 || k[i] != k[i - 1]);
}

__global__ void scatter_first(const uint64_t* __restrict__ k,
                              const uint8_t* __restrict__ first,
                              const int64_t* __restrict__ off, int64_t E,
                              uint64_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < E && first[i]) out[off[i]] = k[i];
}

__global__ void fill_pads(uint64_t* __restrict__ keys,
                          uint8_t* __restrict__ pad,
                          const int64_t* __restrict__ n_ptr, int64_t cap) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  const bool is_pad = i >= *n_ptr;
  if (is_pad) keys[i] = ~0ull;
  pad[i] = is_pad;
}

struct Buffers {
  int64_t* off;
  uint64_t* a;
  uint64_t* b;
  uint8_t* first;
  int32_t* counts;
  int64_t* offs;
  int64_t* m;
  int64_t* total;
  int64_t* scan;
  int64_t used;
};

Buffers carve(char* p, int64_t E) {
  const int64_t ntiles = (E + kTile - 1) / kTile;
  const int64_t nh = (int64_t)kBins * ntiles;
  bk::Carve c{p};
  Buffers b;
  b.off = c.take<int64_t>(E);
  b.a = c.take<uint64_t>(E);
  b.b = c.take<uint64_t>(E);
  b.first = c.take<uint8_t>(E);
  b.counts = c.take<int32_t>(nh);
  b.offs = c.take<int64_t>(nh);
  b.m = c.take<int64_t>(1);
  b.total = c.take<int64_t>(1);
  b.scan = c.take<int64_t>(bk::scan_scratch_elems(E > nh ? E : nh));
  b.used = c.used;
  return b;
}

unsigned blocks(int64_t n, int t = 256) { return (unsigned)((n + t - 1) / t); }

}  // namespace

extern "C" int64_t bk_sort_unique_scratch(int64_t E) {
  return carve(nullptr, E).used;
}

// keys (E,) int64-held u64, emitted (E,) bool -> out_keys (cap,) int64,
// out_pad (cap,) uint8, n_out int64 scalar; cap >= E.
extern "C" int bk_sort_unique(const void* keys, const void* emitted,
                              int64_t E, int64_t cap, void* out_keys,
                              void* out_pad, void* n_out, void* scratch,
                              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Buffers b = carve((char*)scratch, E);
  uint64_t* ok = (uint64_t*)out_keys;
  int64_t* n = (int64_t*)n_out;
  bk::exclusive_scan<uint8_t>((const uint8_t*)emitted, E, b.off, b.m, b.scan,
                              s);
  if (E > 0) {
    compact_emitted<<<blocks(E), 256, 0, s>>>((const uint64_t*)keys,
                                              (const uint8_t*)emitted, b.off,
                                              E, b.a);
    const int64_t ntiles = (E + kTile - 1) / kTile;
    const unsigned grid = (unsigned)ntiles;
    uint64_t* src = b.a;
    uint64_t* dst = b.b;
    for (int shift = 0; shift < 64; shift += 8) {
      radix_hist<<<grid, kThreads, 0, s>>>(src, b.m, shift, ntiles, b.counts);
      bk::exclusive_scan<int32_t>(b.counts, kBins * ntiles, b.offs, b.total,
                                  b.scan, s);
      radix_scatter<<<grid, kThreads, 0, s>>>(src, dst, b.m, shift, ntiles,
                                              b.offs);
      uint64_t* t = src;
      src = dst;
      dst = t;
    }
    flag_first<<<blocks(E), 256, 0, s>>>(src, b.m, E, b.first);
    bk::exclusive_scan<uint8_t>(b.first, E, b.off, n, b.scan, s);
    scatter_first<<<blocks(E), 256, 0, s>>>(src, b.first, b.off, E, ok);
  } else {
    cudaMemsetAsync(n, 0, sizeof(int64_t), s);
  }
  fill_pads<<<blocks(cap), 256, 0, s>>>(ok, (uint8_t*)out_pad, n, cap);
  return (int)cudaGetLastError();
}
