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
//          an owner's count hold U64_MAX.  One thread a query: a warp
//          ranks its lanes of one owner with __match_any_sync, a block of
//          256 queries sums its warps' counts per owner in shared memory,
//          and the tiles' counts per owner are scanned by decoupled
//          look-back (lookback.cuh, one status word a tile and owner,
//          tile ids from an atomic counter).  The same queries go in the
//          same order as the JAX sort takes them, so the rounds agree.
//   bk_route_probe:   each received row probed against this rank's
//          sub-table (probe.cuh), and the response word
//          (val & ~U32 | found << 31 | val & LOW31), or with want_idx
//          (dictionary mode) (sel << 32 | found << 31 | val & LOW31);
//          0 where the key is missing.
//   bk_route_collect: for each query sent this round, its response from
//          the returned frame: done, hit = found, cidx = the compact
//          index (low 31 bits), oidx = the high word; and the count of
//          queries still pending (one 8-B word, read on the host once a
//          round, as the JAX while_loop's condition reads its psum).
//
// What bounds them on an H100: bytes.  frame reads 8 B and a flag and
// writes 4 B a query and 8 B a frame row; probe reads 8 B, one or two
// random 32-B slot rows and writes 8 B a row; collect reads 4 B of slotq,
// a flag and the response of each query and writes 10 B.  The owners are
// ~20 integer ops a query; the look-back's round trips sit on the frame's
// critical path.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"
#include "probe.cuh"

namespace {

constexpr int kT = 256;  // queries a frame tile, one a thread
constexpr int kWarps = kT / 32;
constexpr int kMaxOwners = 1024;
constexpr int kThreads = 256;

__device__ __forceinline__ int owner_of(uint64_t key, uint64_t ndb) {
  return (int)(((bk::splitmix64(key) >> 32) * ndb) >> 32);
}

__global__ void __launch_bounds__(kT)
    frame_kernel(const uint64_t* __restrict__ kq, const bool* __restrict__ done,
                 int64_t Q, int ndb, int64_t cap, uint64_t* __restrict__ send,
                 int32_t* __restrict__ slotq, uint32_t* tile_ctr,
                 uint32_t* status) {
  extern __shared__ uint32_t smem[];
  uint32_t* wcnt = smem;               // [kWarps][ndb]: warp w's count of o
  uint32_t* base = smem + kWarps * ndb;  // [ndb]: the tile's count, then
                                         // the earlier tiles' count
  __shared__ uint32_t s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(tile_ctr, 1u);
  for (int x = tid; x < kWarps * ndb; x += kT) wcnt[x] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t i = tile * kT + tid;
  const bool pend = i < Q && !done[i];
  uint64_t key = 0;
  int o = -1;
  if (pend) {
    key = kq[i];
    o = owner_of(key, (uint64_t)ndb);
  }
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, o);
  const int rank = __popc(peers & ((1u << lane) - 1));
  if (pend && rank == 0) wcnt[warp * ndb + o] = __popc(peers);
  __syncthreads();
  // each owner's warps scanned; the tile's count published
  for (int q = tid; q < ndb; q += kT) {
    uint32_t sum = 0;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = wcnt[w * ndb + q];
      wcnt[w * ndb + q] = sum;
      sum += c;
    }
    base[q] = sum;
    bk::publish(status + q, tile, ndb, sum);
  }
  for (int q = tid; q < ndb; q += kT)
    base[q] = bk::look_back(status + q, tile, ndb, base[q]);
  __syncthreads();
  if (i >= Q) return;
  const int64_t dump = (int64_t)ndb * cap;
  int64_t row = dump;
  if (pend) {
    const int64_t r = (int64_t)base[o] + wcnt[warp * ndb + o] + rank;
    if (r < cap) {
      row = (int64_t)o * cap + r;
      send[row] = key;
    }
  }
  slotq[i] = (int32_t)row;
}

__global__ void __launch_bounds__(kThreads)
    probe_kernel(const uint64_t* __restrict__ recv, int64_t n,
                 bk::ProbeTable t, int want_idx, uint64_t* __restrict__ resp) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
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

__global__ void __launch_bounds__(kThreads)
    collect_kernel(const uint64_t* __restrict__ back,
                   const int32_t* __restrict__ slotq, int64_t Q, int64_t dump,
                   bool* __restrict__ done, bool* __restrict__ hit,
                   int32_t* __restrict__ cidx, int32_t* __restrict__ oidx,
                   unsigned long long* pending) {
  __shared__ unsigned s_cnt[kThreads / 32];
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  unsigned cnt = 0;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < Q;
       i += stride) {
    const int64_t s = slotq[i];
    bool d = done[i];
    if (s < dump) {
      const uint64_t w = back[s];
      hit[i] = (w >> 31) & 1;
      cidx[i] = (int32_t)(w & 0x7FFFFFFFull);
      oidx[i] = (int32_t)(uint32_t)(w >> 32);
      done[i] = d = true;
    }
    cnt += !d;
  }
  cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
  if ((threadIdx.x & 31) == 0) s_cnt[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) sum += s_cnt[w];
    if (sum) atomicAdd(pending, sum);
  }
}

unsigned grid(int64_t n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 16;
  return (unsigned)(want < cap ? (want > 0 ? want : 1) : cap);
}

struct FrameScratch {
  uint32_t* tile_ctr;
  uint32_t* status;
  int64_t zero_bytes;
};

FrameScratch carve(char* p, int64_t Q, int64_t ndb, int64_t* used) {
  bk::Carve c{p};
  const int64_t tiles = (Q + kT - 1) / kT;
  FrameScratch f;
  f.tile_ctr = c.take<uint32_t>(1);
  f.status = c.take<uint32_t>(tiles * ndb);
  f.zero_bytes = c.used;
  *used = c.used;
  return f;
}

}  // namespace

extern "C" int64_t bk_route_frame_scratch(int64_t Q, int64_t ndb) {
  int64_t used = 0;
  carve(nullptr, Q, ndb, &used);
  return used;
}

// kq (Q,) int64-held u64 queries, done (Q,) bool -> send (ndb * cap,)
// int64 frame, slotq (Q,) int32 rows (ndb * cap where a query goes
// nowhere this round); 1 <= ndb <= 1024, Q < 2^30, ndb * cap < 2^31.
extern "C" int bk_route_frame(const void* kq, const void* done, int64_t Q,
                              int64_t ndb, int64_t cap, void* send,
                              void* slotq, void* scratch, void* stream) {
  if (Q < 0 || Q >= bk::kMaxCount || ndb < 1 || ndb > kMaxOwners ||
      cap < 1 || ndb * cap >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(send, 0xFF, ndb * cap * 8, s);
  if (e != cudaSuccess || Q == 0) return (int)e;
  int64_t used = 0;
  const FrameScratch f = carve((char*)scratch, Q, ndb, &used);
  e = cudaMemsetAsync(scratch, 0, f.zero_bytes, s);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (Q + kT - 1) / kT;
  const size_t smem = (size_t)(kWarps + 1) * ndb * 4;
  frame_kernel<<<(unsigned)tiles, kT, smem, s>>>(
      (const uint64_t*)kq, (const bool*)done, Q, (int)ndb, cap,
      (uint64_t*)send, (int32_t*)slotq, f.tile_ctr, f.status);
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
  probe_kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)recv, n, t, want_idx, (uint64_t*)resp);
  return (int)cudaGetLastError();
}

// back (dump,) int64 returned frame, slotq (Q,) int32 -> done, hit (Q,)
// bool, cidx, oidx (Q,) int32 updated where slotq < dump; pending (an
// int64 scalar) = the queries not done after the update.
extern "C" int bk_route_collect(const void* back, const void* slotq,
                                int64_t Q, int64_t dump, void* done,
                                void* hit, void* cidx, void* oidx,
                                void* pending, void* stream) {
  if (Q < 0 || dump < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(pending, 0, 8, s);
  if (e != cudaSuccess || Q == 0) return (int)e;
  collect_kernel<<<grid(Q), kThreads, 0, s>>>(
      (const uint64_t*)back, (const int32_t*)slotq, Q, dump, (bool*)done,
      (bool*)hit, (int32_t*)cidx, (int32_t*)oidx,
      (unsigned long long*)pending);
  return (int)cudaGetLastError();
}
