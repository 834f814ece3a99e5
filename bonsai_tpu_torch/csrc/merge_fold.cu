// KB3 merge_fold: merge two sorted-unique build states and fold the keys
// they share by the reference lca() contract.
//
// Replaces bonsai_tpu/db/build_device.py _merge_states_impl (:145-182),
// _combine_pair (:96-120) and _lca_compact_dev (:61-93).  A state is
// (keys u64, pad u8, node i32, orig u32, cnt u32) of some capacity,
// sorted by (key, pad) with pads (key U64_MAX, pad 1) last, so a real
// U64_MAX key orders before them.  JAX concatenates the two states and
// sorts; here a merge path does the same work with no sort:
//   1. each output slot i finds by binary search on its diagonal how many
//      entries of A precede it (A first on equal (key, pad): stable), and
//      copies its entry into the merged arrays;
//   2. an entry is kept unless it is the second of two equal real keys
//      (each state holds a key at most once, so a key appears once or
//      twice); an exclusive scan of the keep flags gives each kept entry
//      its slot;
//   3. the first of a pair takes the combine of the two: r = lca(nx, ny),
//      orig = tax_ids[r]; disjoint roots -> (root1, 1); a missing taxid
//      -> (0, 0xFFFFFFFF); ox == 0 -> (ny, oy); oy == 0 or ox == oy ->
//      (nx, ox), each rule overriding the ones before it; counts add when
//      sum_counts (only across genomes: chunks of one genome repeat keys);
//   4. slots [n, ca + cb) become pads with zero node, orig and cnt.
// The LCA is lca.cuh's binary lifting, the one K2 uses.
//
// What bounds it on an H100: device memory traffic, about 21 B an entry
// read and written three times, plus log2(ca + cb) dependent reads of the
// diagonal search per slot (served mostly from L2, as neighbouring slots
// search neighbouring ranges).  The design: one thread per output slot in
// every pass; n_valid stays on the card.

#include <cstdint>
#include <cuda_runtime.h>

#include "lca.cuh"
#include "scan.cuh"

namespace {

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

__global__ void merge_path(State a, State b, int64_t N, Out m) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  int64_t lo = i - b.cap > 0 ? i - b.cap : 0;
  int64_t hi = i < a.cap ? i : a.cap;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int64_t j = i - 1 - mid;
    if (le(a.keys[mid], a.pad[mid], b.keys[j], b.pad[j]))
      lo = mid + 1;
    else
      hi = mid;
  }
  const int64_t ia = lo, ib = i - lo;
  const bool take_a = ia < a.cap && (ib >= b.cap || le(a.keys[ia], a.pad[ia],
                                                       b.keys[ib], b.pad[ib]));
  const State& s = take_a ? a : b;
  const int64_t x = take_a ? ia : ib;
  m.keys[i] = s.keys[x];
  m.pad[i] = s.pad[x];
  m.node[i] = s.node[x];
  m.orig[i] = s.orig[x];
  m.cnt[i] = s.cnt[x];
}

__global__ void keep_flags(const uint64_t* __restrict__ keys,
                           const uint8_t* __restrict__ pad, int64_t N,
                           uint8_t* __restrict__ keep) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const bool real = pad[i] == 0;
  const bool second =
      i > 0 && real && pad[i - 1] == 0 && keys[i - 1] == keys[i];
  keep[i] = real && !second;
}

__device__ void combine(const Tree& t, int32_t nx, uint32_t ox, int32_t ny,
                        uint32_t oy, int32_t& node, uint32_t& orig) {
  const int32_t r =
      bk::lca_compact(nx, ny, t.depth, t.parent, t.lift, t.levels, t.n);
  node = r;
  orig = t.tax_ids[r];
  if (r == 0 && nx != 0 && ny != 0) {  // disjoint roots
    node = t.root1;
    orig = 1u;
  }
  if ((nx == 0 && ox != 0u) || (ny == 0 && oy != 0u)) {  // missing taxid
    node = 0;
    orig = 0xFFFFFFFFu;
  }
  if (ox == 0u) {  // 0 is the identity
    node = ny;
    orig = oy;
  }
  if (oy == 0u || ox == oy) {
    node = nx;
    orig = ox;
  }
}

__global__ void combine_scatter(Out m, const uint8_t* __restrict__ keep,
                                const int64_t* __restrict__ off, int64_t N,
                                Tree t, int sum_counts, Out o) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N || !keep[i]) return;
  int32_t node = m.node[i];
  uint32_t orig = m.orig[i];
  uint32_t cnt = m.cnt[i];
  if (i + 1 < N && m.pad[i + 1] == 0 && m.keys[i + 1] == m.keys[i]) {
    combine(t, node, orig, m.node[i + 1], m.orig[i + 1], node, orig);
    if (sum_counts) cnt += m.cnt[i + 1];
  }
  const int64_t d = off[i];
  o.keys[d] = m.keys[i];
  o.pad[d] = 0;
  o.node[d] = node;
  o.orig[d] = orig;
  o.cnt[d] = cnt;
}

__global__ void fill_pads(Out o, const int64_t* __restrict__ n_ptr,
                          int64_t N) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N || i < *n_ptr) return;
  o.keys[i] = ~0ull;
  o.pad[i] = 1;
  o.node[i] = 0;
  o.orig[i] = 0u;
  o.cnt[i] = 0u;
}

struct Buffers {
  Out m;
  uint8_t* keep;
  int64_t* off;
  int64_t* scan;
  int64_t used;
};

Buffers carve(char* p, int64_t N) {
  bk::Carve c{p};
  Buffers b;
  b.m.keys = c.take<uint64_t>(N);
  b.m.pad = c.take<uint8_t>(N);
  b.m.node = c.take<int32_t>(N);
  b.m.orig = c.take<uint32_t>(N);
  b.m.cnt = c.take<uint32_t>(N);
  b.keep = c.take<uint8_t>(N);
  b.off = c.take<int64_t>(N);
  b.scan = c.take<int64_t>(bk::scan_scratch_elems(N));
  b.used = c.used;
  return b;
}

}  // namespace

extern "C" int64_t bk_merge_fold_scratch(int64_t N) {
  return carve(nullptr, N).used;
}

// Two states (capacities ca, cb) and the tree arrays -> one state of
// capacity ca + cb (out_*) and its valid count n_out (int64 scalar).
extern "C" int bk_merge_fold(
    const void* ka, const void* pa, const void* na, const void* oa,
    const void* ca_, int64_t ca, const void* kb, const void* pb,
    const void* nb, const void* ob, const void* cb_, int64_t cb,
    const void* lift, int levels, int n_nodes, const void* depth,
    const void* parent, const void* tax_ids, int root1, int sum_counts,
    void* out_k, void* out_p, void* out_n, void* out_o, void* out_c,
    void* n_out, void* scratch, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t N = ca + cb;
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
  const unsigned grid = (unsigned)((N + 255) / 256);
  merge_path<<<grid, 256, 0, s>>>(A, B, N, b.m);
  keep_flags<<<grid, 256, 0, s>>>(b.m.keys, b.m.pad, N, b.keep);
  bk::exclusive_scan<uint8_t>(b.keep, N, b.off, n, b.scan, s);
  combine_scatter<<<grid, 256, 0, s>>>(b.m, b.keep, b.off, N, t, sum_counts,
                                       o);
  fill_pads<<<grid, 256, 0, s>>>(o, n, N);
  return (int)cudaGetLastError();
}
