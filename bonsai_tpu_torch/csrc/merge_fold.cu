// KB3 merge_fold: merge two sorted-unique build states and fold the keys
// they share by the reference lca() contract.
//
// Replaces bonsai_tpu/db/build_device.py _merge_states_impl (:145-182),
// _combine_pair (:96-120) and _lca_compact_dev (:61-93).  A state is
// (keys u64, pad u8, node i32, orig u32, cnt u32) of some capacity,
// sorted by (key, pad) with pads (key U64_MAX, pad 1) last, so a real
// U64_MAX key orders before them.  JAX concatenates the two states and
// sorts; here a merge path does the same work with no sort.  The merged
// order is stable (a's entry first on equal (key, pad)); an entry is kept
// unless it is the second of two equal real keys (each state holds a key
// at most once, so a key appears once or twice); the first of a pair takes
// the combine of the two: r = lca(nx, ny), orig = tax_ids[r]; disjoint
// roots -> (root1, 1); a missing taxid -> (0, 0xFFFFFFFF); ox == 0 ->
// (ny, oy); oy == 0 or ox == oy -> (nx, ox), each rule overriding the ones
// before it; counts add when sum_counts (only across genomes: chunks of
// one genome repeat keys).  Slots [n, ca + cb) become pads with zero node,
// orig and cnt.  The LCA is lca.cuh's binary lifting, the one K2 uses.
//
// What bounds it on an H100: the call must read the keys and pad of every
// input slot (9 B), node, orig and cnt of every valid entry (12 B), and
// write all 21 B of every output slot: at 2^22 + 2^22 states with 3M valid
// entries each, ~327 MB, ~0.098 ms at 3.35 TB/s.  It takes ~0.28 ms: as in
// KB2, each tile's steps run in order (tile id, staging loads, merge,
// look-back, value loads, writes), and the ~400 tiles resident on the
// card wait mostly on memory round trips and on earlier tiles' counts;
// a warp-wide look-back, values staged by cp.async, 4 tiles an SM and
// bank-spread shared indices each measured slower (PERF.md).
// The design moves each of the bytes about once, in 3 launches, with
// scratch of O(tiles):
//   1. partition: one merge-path search per tile boundary (tiles of kTile
//      output slots), which gives how many of the first d merged entries
//      come from a; it also clears the tiles' status words and counter;
//   2. fold_tiles: a block takes its tile id from an atomic counter and
//      loads the tile's a range and b range of keys and pad into shared
//      memory with coalesced loads, and the merged entries just before and
//      just after the tile, so that a pair straddling a tile edge is seen
//      from both sides and the output does not depend on the tiling.  Each
//      thread merges its kItems slots in shared memory (a short merge-path
//      search, then a serial merge) and flags the entries it keeps and the
//      pairs; a block scan places each kept entry in the tile, and the
//      tile's output offset comes from a decoupled look-back over the
//      earlier tiles' kept counts (lookback.cuh, as KB2).  Kept entries
//      read node, orig and cnt from their source state (monotone in each
//      source, so the reads coalesce), the first of a pair combines both,
//      and the tile's kept run is written through shared memory with
//      coalesced stores.  The last tile writes n;
//   3. fill_pads writes the pad tail [n, ca + cb).

#include <cstdint>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

#include "lca.cuh"
#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                    // output slots a thread merges
constexpr int kTile = kThreads * kItems;     // output slots a tile
constexpr uint16_t kPost = 0xFFFF;           // source: the entry after the tile
static_assert(kTile < kPost, "a tile's staged index fits 16 bits");

struct State {
  const uint64_t* keys;
  const uint8_t* pad;
  const int32_t* node;
  const uint32_t* orig;
  const uint32_t* cnt;
  int64_t cap;
};

struct Out {
  uint64_t* keys;
  uint8_t* pad;
  int32_t* node;
  uint32_t* orig;
  uint32_t* cnt;
};

struct Tree {
  const int32_t* lift;
  int levels;
  int32_t n;
  const int32_t* depth;
  const int32_t* parent;
  const uint32_t* tax_ids;
  int32_t root1;
};

// (k1, p1) <= (k2, p2), unsigned key first
__device__ __forceinline__ bool le(uint64_t k1, uint8_t p1, uint64_t k2,
                                   uint8_t p2) {
  return k1 < k2 || (k1 == k2 && p1 <= p2);
}

// How many of the first d merged entries come from a.
__device__ int64_t split_of(const State& a, const State& b, int64_t d) {
  int64_t lo = d - b.cap > 0 ? d - b.cap : 0;
  int64_t hi = d < a.cap ? d : a.cap;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int64_t j = d - 1 - mid;
    if (le(a.keys[mid], a.pad[mid], b.keys[j], b.pad[j]))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void partition(State a, State b, int64_t N, int64_t ntiles,
                          int64_t* __restrict__ split,
                          uint32_t* __restrict__ status,
                          uint32_t* __restrict__ tile_ctr) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > ntiles) return;
  split[t] = split_of(a, b, min(t * kTile, N));
  if (t < ntiles) status[t] = 0;
  if (t == 0) *tile_ctr = 0;
}

// The rules above, tested from the last (which overrides the others)
// down, so that the LCA is looked up only where it decides the result.
__device__ __forceinline__ void combine(const Tree& t, int32_t nx,
                                        uint32_t ox, int32_t ny, uint32_t oy,
                                        int32_t& node, uint32_t& orig) {
  if (oy == 0u || ox == oy) {
    node = nx;
    orig = ox;
  } else if (ox == 0u) {  // 0 is the identity
    node = ny;
    orig = oy;
  } else if (nx == 0 || ny == 0) {  // a missing taxid
    node = 0;
    orig = 0xFFFFFFFFu;
  } else {
    const int32_t r =
        bk::lca_compact(nx, ny, t.depth, t.parent, t.lift, t.levels, t.n);
    node = r ? r : t.root1;  // disjoint roots -> 1
    orig = r ? __ldg(t.tax_ids + r) : 1u;
  }
}

// node, orig, cnt of entry x of the two states taken as one array: x < a.cap
// in a, else x - a.cap in b.
__device__ __forceinline__ void values(const State& a, const State& b,
                                       int64_t x, int32_t& node,
                                       uint32_t& orig, uint32_t& cnt) {
  const State& s = x < a.cap ? a : b;
  const int64_t i = x < a.cap ? x : x - a.cap;
  node = s.node[i];
  orig = s.orig[i];
  cnt = s.cnt[i];
}

__global__ void __launch_bounds__(kThreads)
    fold_tiles(State a, State b, int64_t N, const int64_t* __restrict__ split,
               Tree tree, int sum_counts, uint32_t* __restrict__ tile_ctr,
               uint32_t* status, Out o, int64_t* __restrict__ n_out) {
  using Scan = cub::BlockScan<int32_t, kThreads>;
  // phase 1: staged keys and pad (a's range, then b's) and the merged
  // order as staged indices; phase 2, in the same bytes: the kept entries
  constexpr int kPhase1 = kTile * (8 + 1 + 2);
  constexpr int kPhase2 = kTile * (8 + 4 + 4 + 4);
  __shared__ __align__(16) unsigned char smem[kPhase2 > kPhase1 ? kPhase2
                                                                : kPhase1];
  __shared__ typename Scan::TempStorage tmp;
  __shared__ uint32_t s_tile, s_before;
  __shared__ uint64_t s_pre_key, s_post_key;  // pad 1 where there is none
  __shared__ uint8_t s_pre_pad, s_post_pad;
  __shared__ int64_t s_post_src;
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = atomicAdd(tile_ctr, 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t d0 = tile * kTile;
  const int64_t d1 = min(d0 + kTile, N);
  const int64_t a0 = split[tile], a1 = split[tile + 1];
  const int64_t b0 = d0 - a0, b1 = d1 - a1;
  const int na = (int)(a1 - a0), cnt = (int)(d1 - d0), nb = cnt - na;
  uint64_t* s_key = (uint64_t*)smem;
  uint8_t* s_pad = smem + kTile * 8;
  uint16_t* s_idx = (uint16_t*)(smem + kTile * 9);

  // 1. stage the tile's keys and pad, and the entries around it
  for (int j = tid; j < cnt; j += kThreads) {
    if (j < na) {
      s_key[j] = a.keys[a0 + j];
      s_pad[j] = a.pad[a0 + j];
    } else {
      s_key[j] = b.keys[b0 + j - na];
      s_pad[j] = b.pad[b0 + j - na];
    }
  }
  if (tid == 0) {  // merged entry d0 - 1: the later of a[a0-1], b[b0-1]
    uint64_t k = ~0ull;
    uint8_t p = 1;
    if (a0 > 0 && (b0 == 0 || !le(a.keys[a0 - 1], a.pad[a0 - 1],
                                  b.keys[b0 - 1], b.pad[b0 - 1]))) {
      k = a.keys[a0 - 1];
      p = a.pad[a0 - 1];
    } else if (b0 > 0) {
      k = b.keys[b0 - 1];
      p = b.pad[b0 - 1];
    }
    s_pre_key = k;
    s_pre_pad = p;
  }
  if (tid == 32) {  // merged entry d1: the first of a[a1], b[b1]
    uint64_t k = ~0ull;
    uint8_t p = 1;
    int64_t src = -1;
    if (d1 < N) {
      if (a1 < a.cap && (b1 >= b.cap || le(a.keys[a1], a.pad[a1], b.keys[b1],
                                           b.pad[b1]))) {
        k = a.keys[a1];
        p = a.pad[a1];
        src = a1;
      } else {
        k = b.keys[b1];
        p = b.pad[b1];
        src = a.cap + b1;
      }
    }
    s_post_key = k;
    s_post_pad = p;
    s_post_src = src;
  }
  __syncthreads();

  // 2. merge this thread's kItems slots in shared memory
  const uint64_t* sb_key = s_key + na;
  const uint8_t* sb_pad = s_pad + na;
  const int diag = min(tid * kItems, cnt);
  int lo = max(0, diag - nb), hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int j = diag - 1 - mid;
    if (le(s_key[mid], s_pad[mid], sb_key[j], sb_pad[j]))
      lo = mid + 1;
    else
      hi = mid;
  }
  int ia = lo, ib = diag - lo;
  uint64_t key[kItems];
  uint16_t idx[kItems];
  uint32_t real = 0;  // bit r: slot r holds a real key
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int pos = tid * kItems + r;
    key[r] = ~0ull;
    idx[r] = 0;
    if (pos < cnt) {
      const bool ta = ia < na && (ib >= nb || le(s_key[ia], s_pad[ia],
                                                 sb_key[ib], sb_pad[ib]));
      const int x = ta ? ia++ : na + ib++;
      idx[r] = (uint16_t)x;
      key[r] = s_key[x];
      real |= (uint32_t)(s_pad[x] == 0) << r;
      s_idx[pos] = (uint16_t)x;
    }
  }
  __syncthreads();

  // 3. keep flags and pairs, from the neighbouring slots
  uint64_t pk, nk;
  bool pr, nr;
  uint16_t nidx = 0;
  {
    const int pos = tid * kItems - 1;
    if (pos < 0) {
      pk = s_pre_key;
      pr = s_pre_pad == 0;
    } else {
      const int x = pos < cnt ? s_idx[pos] : 0;
      pk = s_key[x];
      pr = pos < cnt && s_pad[x] == 0;
    }
  }
  {
    const int pos = tid * kItems + kItems;
    if (pos < cnt) {
      nidx = s_idx[pos];
      nk = s_key[nidx];
      nr = s_pad[nidx] == 0;
    } else {  // the entry after the tile (none past the last tile)
      nidx = kPost;
      nk = s_post_key;
      nr = pos == cnt && s_post_pad == 0;
    }
  }
  uint32_t keep = 0, pair = 0;
  uint16_t second[kItems];  // staged index (or kPost) of a pair's second
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool me = real >> r & 1;
    const bool prev = r == 0 ? pr && pk == key[0]
                             : (real >> (r - 1) & 1) && key[r - 1] == key[r];
    const bool next = r + 1 < kItems
                          ? (real >> (r + 1) & 1) && key[r + 1] == key[r]
                          : nr && nk == key[r];
    keep |= (uint32_t)(me && !prev) << r;
    pair |= (uint32_t)(me && next) << r;
    second[r] = r + 1 < kItems ? idx[r + 1] : nidx;
  }
  __syncthreads();  // the staged keys are read: phase 2 may overwrite them
  int32_t off, kept;
  Scan(tmp).ExclusiveSum(__popc(keep), off, kept);
  if (tid == 0) {
    bk::publish(status, tile, 1, (uint32_t)kept);
    s_before = bk::look_back(status, tile, 1, (uint32_t)kept);
  }

  // 4. the kept entries' values, combined for pairs, into shared memory
  uint64_t* o_key = (uint64_t*)smem;
  int32_t* o_node = (int32_t*)(smem + kTile * 8);
  uint32_t* o_orig = (uint32_t*)(smem + kTile * 12);
  uint32_t* o_cnt = (uint32_t*)(smem + kTile * 16);
  const int64_t post_src = s_post_src;
  int q = off;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    if (!(keep >> r & 1)) continue;
    const int x = idx[r];
    int32_t node;
    uint32_t orig, c;
    values(a, b, x < na ? a0 + x : a.cap + b0 + (x - na), node, orig, c);
    if (pair >> r & 1) {
      const int y = second[r];
      const int64_t src = y == kPost ? post_src
                          : y < na   ? a0 + y
                                     : a.cap + b0 + (y - na);
      int32_t ny;
      uint32_t oy, cy;
      values(a, b, src, ny, oy, cy);
      combine(tree, node, orig, ny, oy, node, orig);
      if (sum_counts) c += cy;
    }
    o_key[q] = key[r];
    o_node[q] = node;
    o_orig[q] = orig;
    o_cnt[q] = c;
    ++q;
  }
  __syncthreads();

  // 5. the tile's kept run, coalesced
  const int64_t before = s_before;
  for (int j = tid; j < kept; j += kThreads) {
    const int64_t d = before + j;
    o.keys[d] = o_key[j];
    o.pad[d] = 0;
    o.node[d] = o_node[j];
    o.orig[d] = o_orig[j];
    o.cnt[d] = o_cnt[j];
  }
  if (tid == 0 && d1 == N) *n_out = before + kept;
}

// A block covers kTile slots, thread t the slots base + e * kThreads + t.
__global__ void __launch_bounds__(kThreads)
    fill_pads(Out o, const int64_t* __restrict__ n_ptr, int64_t N) {
  const int64_t base = (int64_t)blockIdx.x * kTile;
  const int64_t n = *n_ptr;
  if (base + kTile <= n) return;
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int64_t i = base + e * kThreads + threadIdx.x;
    if (i >= n && i < N) {
      o.keys[i] = ~0ull;
      o.pad[i] = 1;
      o.node[i] = 0;
      o.orig[i] = 0u;
      o.cnt[i] = 0u;
    }
  }
}

// Scratch: the tile splits, the tiles' status words and the tile counter.
struct Buffers {
  int64_t* split;
  uint32_t* status;
  uint32_t* tile_ctr;
  int64_t used;
};

int64_t tiles_of(int64_t N) { return (N + kTile - 1) / kTile; }

Buffers carve(char* p, int64_t N) {
  const int64_t ntiles = tiles_of(N);
  bk::Carve c{p};
  Buffers b;
  b.split = c.take<int64_t>(ntiles + 1);
  b.status = c.take<uint32_t>(ntiles);
  b.tile_ctr = c.take<uint32_t>(1);
  b.used = c.used;
  return b;
}

}  // namespace

extern "C" int64_t bk_merge_fold_scratch(int64_t N) {
  return carve(nullptr, N).used;
}

// Two states (capacities ca, cb) and the tree arrays -> one state of
// capacity ca + cb (out_*) and its valid count n_out (int64 scalar);
// ca + cb < 2^30.
extern "C" int bk_merge_fold(
    const void* ka, const void* pa, const void* na, const void* oa,
    const void* ca_, int64_t ca, const void* kb, const void* pb,
    const void* nb, const void* ob, const void* cb_, int64_t cb,
    const void* lift, int levels, int n_nodes, const void* depth,
    const void* parent, const void* tax_ids, int root1, int sum_counts,
    void* out_k, void* out_p, void* out_n, void* out_o, void* out_c,
    void* n_out, void* scratch, void* stream) {
  const int64_t N = ca + cb;
  if (ca < 0 || cb < 0 || N >= bk::kMaxCount)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Buffers b = carve((char*)scratch, N);
  const State A{(const uint64_t*)ka, (const uint8_t*)pa, (const int32_t*)na,
                (const uint32_t*)oa, (const uint32_t*)ca_, ca};
  const State B{(const uint64_t*)kb, (const uint8_t*)pb, (const int32_t*)nb,
                (const uint32_t*)ob, (const uint32_t*)cb_, cb};
  const Out o{(uint64_t*)out_k, (uint8_t*)out_p, (int32_t*)out_n,
              (uint32_t*)out_o, (uint32_t*)out_c};
  const Tree t{(const int32_t*)lift, levels, n_nodes, (const int32_t*)depth,
               (const int32_t*)parent, (const uint32_t*)tax_ids, root1};
  int64_t* n = (int64_t*)n_out;
  if (N == 0) {
    cudaMemsetAsync(n, 0, sizeof(int64_t), s);
    return (int)cudaGetLastError();
  }
  const int64_t ntiles = tiles_of(N);
  partition<<<(unsigned)((ntiles + 256) / 256), 256, 0, s>>>(
      A, B, N, ntiles, b.split, b.status, b.tile_ctr);
  fold_tiles<<<(unsigned)ntiles, kThreads, 0, s>>>(
      A, B, N, b.split, t, sum_counts, b.tile_ctr, b.status, o, n);
  fill_pads<<<(unsigned)ntiles, kThreads, 0, s>>>(o, n, N);
  return (int)cudaGetLastError();
}
