// KD1 route: one round of the all_to_all-routed probe of the sharded
// classifier, in three launches around the mesh's two all_to_all
// exchanges (bonsai_tpu_torch/parallel/sharded.py).
//
// Replaces bonsai_tpu/parallel/sharded.py _build_fn_a2a.routed_probe
// (:288-399): shard_owner (db/table.py:413), the owner-keyed sort of the
// pending queries with SENT = U64_MAX sorting last (:296-310), the
// searchsorted segment bounds (:317-320), the (ndb, cap) send frame from
// one (Q, 2) row gather (:321-347), the slotq scatter (:349-354), the
// dual-row probe and the response word (:356-376), the gather of the
// returned frame into res/done (:378-381) and the count of pending
// queries that the while_loop's psum reads (:384-386).
//
//   bk_route_frame:   the owner of each pending query (splitmix64's top
//          32 bits times ndb, probe.cuh), and a STABLE partition of the
//          pending queries by owner: owner o's r-th pending query in
//          index order goes to frame row o * cap + r while r < cap, and
//          slotq[i] is that row (ndb * cap, "nowhere", for a query that
//          is done or past its owner's capacity this round).  Rows past
//          an owner's count hold U64_MAX.  One cooperative launch of
//          resident blocks, nothing else (no memset): a block owns a run
//          of tiles of 1024 queries (4 a thread; a warp reads 32
//          consecutive queries a load; a block's only tile stays in
//          registers, more are read again), ranks each query among its
//          warp's earlier ones of its owner (__match_any_sync; a group's
//          leader adds its size to the warp's count in shared memory,
//          whose old value it passes on), and writes its counts per
//          owner; after a grid barrier a warp sums an owner's column of
//          block counts, before this block and in all (or, where blocks
//          x owners pass kDirect, each warp of the grid scans a column in
//          place and a second barrier follows); the block writes its
//          share of the frame's U64_MAX rows [total_o, cap) and its
//          queries' rows.  The grid barrier is cooperative_groups', so a
//          call leaves no state behind and needs none cleared.
//   bk_route_probe:   each received row probed against this rank's
//          sub-table (probe.cuh), and the response word
//          (val & ~U32 | found << 31 | val & LOW31), or with want_idx
//          (dictionary mode) (sel << 32 | found << 31 | val & LOW31);
//          0 where the key is missing.  Its time is the card's rate of
//          random 32-B slot rows (most received keys miss, and read both
//          of their rows): loading both rows at once, more keys a thread
//          or the U64_MAX rows probed once a block gained nothing there
//          (PERF.md, row 19c), and the second row stays unread where the
//          first holds the key.  Blocks of 128 threads: a later
//          round's small frame reaches more SMs than with 256.
//   bk_route_collect: for each query sent this round, its response from
//          the returned frame: done, hit = found, cidx = the compact
//          index (low 31 bits), oidx = the high word; and the count of
//          queries still pending (one 8-B word, read on the host once a
//          round, as the JAX while_loop's condition reads its psum).  One
//          launch, nothing else (no memset): a thread takes groups of 4
//          queries (16-B loads of slotq, 4-B of done, and 16-B and 4-B
//          stores where all 4 were sent, when the tensors are so
//          aligned); a block adds (1 << 40 | its count of pending
//          queries) to a tally, one atomic a block of 1024 queries, and
//          the block whose add finds every other block in the tally
//          writes the count and resets the tally.
//
// What bounds them on an H100: bytes.  frame reads 8 B and a flag and
// writes 4 B a query and 8 B a frame row; probe reads 8 B, one or two
// random 32-B slot rows and writes 8 B a row; collect reads 4 B of slotq,
// a flag and the response of each query and writes 10 B.  The owners are
// ~20 integer ops a query; the frame's one or two grid barriers sit on
// its critical path.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxOwners = 1024;
constexpr int64_t kMaxQ = 1 << 30;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;                     // queries a thread a tile
constexpr int kTile = kThreads * kRounds;      // queries a frame tile
constexpr int kDirect = 16384;  // blocks x owners a block sums itself
constexpr int64_t kPadRows = 16384;  // frame rows a block pads, at most
constexpr int kProbeThreads = 128;   // a probe block's threads
constexpr int kCollectQ = 4;         // queries a collect thread, 4 a group
constexpr int kGroups = kCollectQ / 4;
constexpr int64_t kCollectBlocks = 4096;  // collect's blocks, at most
constexpr int kTallyShift = 40;      // collect's tally: blocks << 40 | count
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ int owner_of(uint64_t key, uint64_t ndb) {
  return (int)(((bk::splitmix64(key) >> 32) * ndb) >> 32);
}

// A tile's queries in registers: round j of warp w holds query
// tile * kTile + w * 32 * kRounds + j * 32 + lane, its key, its owner (-1
// where it is done or past Q) and its rank among the warp's queries of
// that owner before it.
struct TileQ {
  uint64_t key[kRounds];
  int own[kRounds];
  uint32_t rank[kRounds];
};

// Load a tile's queries, and count them by owner into wcnt[w * ndb + o]
// (warp w's count of owner o): a group of a round's lanes of one owner
// adds its size at its leader, whose atomicAdd returns the count of the
// warp's earlier rounds, and each lane adds its earlier peers.
__device__ __forceinline__ void rank_tile(TileQ& q, const uint64_t* kq,
                                          const bool* done, int64_t Q,
                                          int64_t tile, int ndb,
                                          uint32_t* wcnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int x = threadIdx.x; x < kWarps * ndb; x += kThreads) wcnt[x] = 0;
  const int64_t i0 = tile * kTile + warp * (32 * kRounds) + lane;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int64_t i = i0 + 32 * j;
    q.key[j] = i < Q ? kq[i] : 0;
    q.own[j] = i < Q && !done[i] ? owner_of(q.key[j], (uint64_t)ndb) : -1;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int o = q.own[j];
    const unsigned peers = __match_any_sync(kAll, o);
    const int lead = __ffs(peers) - 1;
    uint32_t before = 0;
    if (o >= 0 && lane == lead)
      before = atomicAdd(&wcnt[warp * ndb + o], (uint32_t)__popc(peers));
    q.rank[j] = __shfl_sync(kAll, before, lead) +
                __popc(peers & ((1u << lane) - 1));
  }
  __syncthreads();
}

// smem: wcnt [kWarps][ndb], base [ndb] (the block's next row of each
// owner), total [ndb]; cnt: [ndb][gridDim.x] counts, an owner's column
// of blocks contiguous, then (column path) each column's exclusive scan,
// with ctot [ndb]
__global__ void __launch_bounds__(kThreads)
    frame_kernel(const uint64_t* __restrict__ kq, const bool* __restrict__ done,
                 int64_t Q, int ndb, int64_t cap, uint64_t* __restrict__ send,
                 int32_t* __restrict__ slotq, uint32_t* cnt, uint32_t* ctot) {
  extern __shared__ uint32_t smem[];
  uint32_t* wcnt = smem;
  uint32_t* base = wcnt + kWarps * ndb;
  uint32_t* total = base + ndb;
  const cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, b = blockIdx.x;
  const int64_t T = (Q + kTile - 1) / kTile;
  const int64_t t0 = T * b / G, t1 = T * (b + 1) / G;  // the block's tiles
  TileQ q;

  // 1. the block's count of each owner -> cnt[o][b]
  for (int o = tid; o < ndb; o += kThreads) base[o] = 0;
  for (int64_t t = t0; t < t1; ++t) {
    rank_tile(q, kq, done, Q, t, ndb, wcnt);
    for (int o = tid; o < ndb; o += kThreads) {
      uint32_t s = 0;
      for (int w = 0; w < kWarps; ++w) s += wcnt[w * ndb + o];
      base[o] += s;
    }
    __syncthreads();  // wcnt is read before the next tile counts
  }
  __syncthreads();
  for (int o = tid; o < ndb; o += kThreads) cnt[(int64_t)o * G + b] = base[o];
  grid.sync();

  // 2. base[o]: the count of owner o in the blocks before this one;
  //    total[o]: in all blocks
  const int n = G * ndb;
  if (n <= kDirect) {  // a warp an owner: its column's sums
    for (int o = warp; o < ndb; o += kWarps) {
      const uint32_t* col = cnt + (int64_t)o * G;
      uint32_t before = 0, all = 0;
#pragma unroll 4
      for (int r = lane; r < G; r += 32) {
        const uint32_t c = __ldcg(col + r);
        all += c;
        before += r < b ? c : 0;
      }
      all = __reduce_add_sync(kAll, all);
      before = __reduce_add_sync(kAll, before);
      if (lane == 0) base[o] = before, total[o] = all;
    }
  } else {
    // a warp of the grid an owner: the column's exclusive scan in place,
    // 32 blocks' counts a step, and its total; then a second barrier
    for (int o = b * kWarps + warp; o < ndb; o += G * kWarps) {
      uint32_t* col = cnt + (int64_t)o * G;
      uint32_t carry = 0;
#pragma unroll 4
      for (int r0 = 0; r0 < G; r0 += 32) {
        const int r = r0 + lane;
        const uint32_t c = r < G ? __ldcg(col + r) : 0;
        uint32_t inc = c;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const uint32_t v = __shfl_up_sync(kAll, inc, d);
          if (lane >= d) inc += v;
        }
        if (r < G) __stcg(col + r, carry + inc - c);
        carry += __shfl_sync(kAll, inc, 31);
      }
      if (lane == 0) __stcg(ctot + o, carry);
    }
    grid.sync();
    for (int o = tid; o < ndb; o += kThreads) {
      base[o] = __ldcg(cnt + (int64_t)o * G + b);
      total[o] = __ldcg(ctot + o);
    }
  }
  __syncthreads();

  // 3. the block's share of the frame's padding: rows [total_o, cap) of
  //    each owner o, in the block's slice of the ndb * cap rows
  const int64_t rows = (int64_t)ndb * cap;
  const int64_t lo = rows * b / G, hi = rows * (b + 1) / G;
  const bool al = ((uintptr_t)send & 15) == 0;
  for (int64_t o = lo / cap; o < ndb && o * cap < hi; ++o) {
    const int64_t p0 = max(lo, o * cap + min((int64_t)total[o], cap));
    const int64_t p1 = min(hi, (o + 1) * cap);
    if (p0 >= p1) continue;
    const int64_t a = al ? min(p1, (p0 + 1) & ~(int64_t)1) : p1;  // 16-B pairs
    for (int64_t p = p0 + tid; p < a; p += kThreads) send[p] = ~0ull;
    const int64_t np = (p1 - a) >> 1;
    ulonglong2* v = (ulonglong2*)(send + a);
    for (int64_t p = tid; p < np; p += kThreads)
      v[p] = make_ulonglong2(~0ull, ~0ull);
    if (tid == 0 && a + 2 * np < p1) send[p1 - 1] = ~0ull;
  }

  // 4. each pending query's row, in index order: the owner's base, the
  //    earlier warps' counts, its rank in its warp
  const int64_t dump = rows;
  for (int64_t t = t0; t < t1; ++t) {
    if (t1 - t0 > 1)  // a block's only tile is still in registers
      rank_tile(q, kq, done, Q, t, ndb, wcnt);
    for (int o = tid; o < ndb; o += kThreads) {
      uint32_t s = base[o];
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t c = wcnt[w * ndb + o];
        wcnt[w * ndb + o] = s;
        s += c;
      }
      base[o] = s;
    }
    __syncthreads();
    const int64_t i0 = t * kTile + warp * (32 * kRounds) + lane;
#pragma unroll
    for (int j = 0; j < kRounds; ++j) {
      const int o = q.own[j];
      const int64_t i = i0 + 32 * j;
      int64_t row = dump;
      if (o >= 0) {
        const int64_t r = (int64_t)wcnt[warp * ndb + o] + q.rank[j];
        if (r < cap) {
          row = o * cap + r;
          send[row] = q.key[j];
        }
      }
      if (i < Q) slotq[i] = (int32_t)row;
    }
    __syncthreads();  // wcnt is counted again for the next tile
  }
}

__global__ void __launch_bounds__(kProbeThreads)
    probe_kernel(const uint64_t* __restrict__ recv, int64_t n,
                 bk::ProbeTable t, int want_idx, uint64_t* __restrict__ resp) {
  const int64_t stride = (int64_t)gridDim.x * kProbeThreads;
  for (int64_t i = (int64_t)blockIdx.x * kProbeThreads + threadIdx.x; i < n;
       i += stride) {
    uint64_t val = 0;
    uint32_t sel = 0;
    const bool found = bk::probe(t, recv[i], &val, &sel);
    uint64_t w = 0;
    if (found)
      w = (want_idx ? (uint64_t)sel << 32 : val & ~0xFFFFFFFFull) |
          (1ull << 31) | (val & 0x7FFFFFFFull);
    resp[i] = w;
  }
}

// One query's update from its response word w: hit, cidx, oidx.
__device__ __forceinline__ void answer(uint64_t w, uint8_t* hit, int32_t* cidx,
                                       int32_t* oidx) {
  *hit = (w >> 31) & 1;
  *cidx = (int32_t)(w & 0x7FFFFFFFull);
  *oidx = (int32_t)(uint32_t)(w >> 32);
}

// collect's tally of this call: the blocks done (<< kTallyShift) and
// their queries still pending, added by one atomic a block.  The last
// block writes the count and resets the tally, so it is 0 between calls
// (which run one after another, on one stream).
__device__ unsigned long long g_tally = 0;

// kVec: slotq, cidx and oidx 16-B aligned, done and hit 4-B aligned.  A
// thread takes kGroups groups of 4 queries a pass, a warp's groups
// contiguous.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    collect_kernel(const uint64_t* __restrict__ back,
                   const int32_t* __restrict__ slotq, int64_t Q, int64_t dump,
                   uint8_t* __restrict__ done, uint8_t* __restrict__ hit,
                   int32_t* __restrict__ cidx, int32_t* __restrict__ oidx,
                   unsigned long long* __restrict__ pending) {
  __shared__ uint32_t s_cnt[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t span = (int64_t)kThreads * kCollectQ;
  uint32_t left = 0;  // this thread's queries not done after the update
  for (int64_t b0 = (int64_t)blockIdx.x * span; b0 < Q;
       b0 += (int64_t)gridDim.x * span) {
    int32_t s[kGroups][4];
    uint32_t d[kGroups];  // the 4 done flags, a byte each
    uint64_t w[kGroups][4];
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int64_t i = b0 + 4 * ((int64_t)g * kThreads + threadIdx.x);
      if (kVec && i + 4 <= Q) {
        const int4 v = *(const int4*)(slotq + i);
        s[g][0] = v.x, s[g][1] = v.y, s[g][2] = v.z, s[g][3] = v.w;
        d[g] = *(const uint32_t*)(done + i);
      } else {
        d[g] = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = i + e < Q;  // a lane past Q: not sent, done
          s[g][e] = in ? slotq[i + e] : (int32_t)dump;
          d[g] |= (uint32_t)(in ? done[i + e] : 1) << (8 * e);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[g][e] = s[g][e] < dump ? back[s[g][e]] : 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int64_t i = b0 + 4 * ((int64_t)g * kThreads + threadIdx.x);
      uint32_t sent = 0, dn = d[g];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s[g][e] < dump) sent |= 1u << e, dn |= 1u << (8 * e);
#pragma unroll
      for (int e = 0; e < 4; ++e) left += ((dn >> (8 * e)) & 0xFF) == 0;
      if (!sent) continue;
      if (kVec && i + 4 <= Q) {
        *(uint32_t*)(done + i) = dn;
        if (sent == 0xF) {
          uint32_t h = 0;
          int32_t c[4], o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint8_t b;
            answer(w[g][e], &b, &c[e], &o[e]);
            h |= (uint32_t)b << (8 * e);
          }
          *(uint32_t*)(hit + i) = h;
          *(int4*)(cidx + i) = make_int4(c[0], c[1], c[2], c[3]);
          *(int4*)(oidx + i) = make_int4(o[0], o[1], o[2], o[3]);
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!(sent >> e & 1)) continue;
        if (!kVec || i + 4 > Q) done[i + e] = 1;
        answer(w[g][e], hit + i + e, cidx + i + e, oidx + i + e);
      }
    }
  }
  left = __reduce_add_sync(kAll, left);
  if (lane == 0) s_cnt[warp] = left;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int x = 0; x < kWarps; ++x) sum += s_cnt[x];
    const unsigned long long old =
        atomicAdd(&g_tally, (1ull << kTallyShift) | sum);
    if ((old >> kTallyShift) == gridDim.x - 1) {  // the last block
      *pending = (old & ((1ull << kTallyShift) - 1)) + sum;
      g_tally = 0;
    }
  }
}

size_t frame_smem(int64_t ndb) { return (size_t)(kWarps + 2) * ndb * 4; }

// A probe's blocks for n keys: at most 32 of kProbeThreads an SM, each
// thread a stride past that.
unsigned probe_grid(int64_t n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n + kProbeThreads - 1) / kProbeThreads;
  const int64_t cap = (int64_t)sms * 32;
  return (unsigned)(want < cap ? (want > 0 ? want : 1) : cap);
}

// collect's blocks for Q queries: a block of kThreads * kCollectQ, at most
// kCollectBlocks (a block takes more a pass past that)
int64_t collect_blocks(int64_t Q) {
  const int64_t want = (Q + kThreads * kCollectQ - 1) / (kThreads * kCollectQ);
  return want < 1 ? 1 : want < kCollectBlocks ? want : kCollectBlocks;
}

// Blocks of the frame kernel resident on the card together (at ndb's
// shared memory): the most its cooperative grid may have.
cudaError_t resident_blocks(int64_t ndb, int* out) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per, frame_kernel, kThreads, frame_smem(ndb))) != cudaSuccess)
    return e;
  if (per < 1) return cudaErrorLaunchOutOfResources;
  *out = sms * per;
  return cudaSuccess;
}

}  // namespace

// The frame's scratch: a count a resident block and owner, and the
// owners' totals.  Q does not change it; it stays an argument, as the
// wrappers call every revision's scratch function alike.
extern "C" int64_t bk_route_frame_scratch(int64_t Q, int64_t ndb) {
  int most = 0;
  if (resident_blocks(ndb, &most) != cudaSuccess) return -1;
  return ((int64_t)most + 1) * ndb * 4;
}

// kq (Q,) int64-held u64 queries, done (Q,) bool -> send (ndb * cap,)
// int64 frame, slotq (Q,) int32 rows (ndb * cap where a query goes
// nowhere this round); 1 <= ndb <= 1024, Q < 2^30, ndb * cap < 2^31.
// One cooperative launch.
extern "C" int bk_route_frame(const void* kq, const void* done, int64_t Q,
                              int64_t ndb, int64_t cap, void* send,
                              void* slotq, void* scratch, void* stream) {
  if (Q < 0 || Q >= kMaxQ || ndb < 1 || ndb > kMaxOwners ||
      cap < 1 || ndb * cap >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  // a block a tile, or more where the padding takes more than kPadRows
  // rows a block; at most the resident blocks
  int most = 0;
  cudaError_t e = resident_blocks(ndb, &most);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (Q + kTile - 1) / kTile;
  const int64_t pads = (ndb * cap + kPadRows - 1) / kPadRows;
  const int64_t want = tiles > pads ? tiles : pads;
  const int G = (int)(want < most ? want : most);
  const uint64_t* k = (const uint64_t*)kq;
  const bool* d = (const bool*)done;
  int n = (int)ndb;
  uint64_t* s = (uint64_t*)send;
  int32_t* sq = (int32_t*)slotq;
  uint32_t* cnt = (uint32_t*)scratch;
  uint32_t* ctot = cnt + (int64_t)G * ndb;
  void* args[] = {&k, &d, &Q, &n, &cap, &s, &sq, &cnt, &ctot};
  e = cudaLaunchCooperativeKernel((const void*)frame_kernel, dim3(G),
                                  dim3(kThreads), args, frame_smem(ndb),
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// recv (n,) int64-held u64 keys probed against the rank's sub-table
// (db/table.py ProbeArrays.args) -> resp (n,) int64 response words.
extern "C" int bk_route_probe(const void* recv, int64_t n, const void* slots,
                              int lgnb, int vbits, const void* vals,
                              int64_t n_vals, int is_inline, int want_idx,
                              void* resp, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const bk::ProbeTable t{(const ulonglong2*)slots, (const uint64_t*)vals,
                         n_vals, lgnb, vbits, is_inline};
  probe_kernel<<<probe_grid(n), kProbeThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)recv, n, t, want_idx, (uint64_t*)resp);
  return (int)cudaGetLastError();
}

// back (dump,) int64 returned frame, slotq (Q,) int32 -> done, hit (Q,)
// bool, cidx, oidx (Q,) int32 updated where slotq < dump; pending (an
// int64 scalar) = the queries not done after the update; Q < 2^40.  One
// launch, nothing else.
extern "C" int bk_route_collect(const void* back, const void* slotq,
                                int64_t Q, int64_t dump, void* done,
                                void* hit, void* cidx, void* oidx,
                                void* pending, void* stream) {
  if (Q < 0 || Q >= (1ll << kTallyShift) || dump < 1)
    return (int)cudaErrorInvalidValue;
  const bool vec = (uintptr_t)slotq % 16 == 0 && (uintptr_t)cidx % 16 == 0 &&
                   (uintptr_t)oidx % 16 == 0 && (uintptr_t)done % 4 == 0 &&
                   (uintptr_t)hit % 4 == 0;
  const dim3 grid((unsigned)collect_blocks(Q));
  const cudaStream_t s = (cudaStream_t)stream;
  const uint64_t* b = (const uint64_t*)back;
  const int32_t* sq = (const int32_t*)slotq;
  uint8_t *d = (uint8_t*)done, *h = (uint8_t*)hit;
  int32_t *c = (int32_t*)cidx, *o = (int32_t*)oidx;
  unsigned long long* p = (unsigned long long*)pending;
  if (vec)
    collect_kernel<true><<<grid, kThreads, 0, s>>>(b, sq, Q, dump, d, h, c, o,
                                                   p);
  else
    collect_kernel<false><<<grid, kThreads, 0, s>>>(b, sq, Q, dump, d, h, c,
                                                    o, p);
  return (int)cudaGetLastError();
}
