// KB4 compacted_minimizers: the uncanonical windowed minimizers of
// contiguous k-mers (`build -C -w`), lex, entropy-file, phase-1
// (score::Hash, `build -C -w -t|-f --phase1-db`) or Shannon (the scheme
// "entropy" of the Python API) score, of DNA or another alphabet's fold.
//
// Replaces the device path of bonsai_tpu/core/encoder.py
// BatchEncoder.emissions on its uncanonical unspaced windowed branches
// (:161-173 entropy-file, :185-188 -> _windowed_compacted :206-220 lex
// and Shannon) and its canonical unspaced Shannon branch (:156-160:
// select on the uncanonical k-mers, then canonicalize the emitted ones)
// with minimize.compact_valid (:84) and compacted_minimizers (:109), and
// for the other alphabets encode._pack (:108-137) and apply_mask
// (:163-170).
// Only valid seeds are pushed: with n_push = max(len - (k - 1), 0), the
// seed at p is valid iff p < n_push and its k bases hold no N.  The valid
// seeds of a row, in order, are its compacted stream, n_valid long; a
// position of the stream at or past n_valid reads as the sentinel
// (score, kmer) = (U64_MAX, U64_MAX).  With P = L - k + 1 and
// E = 1 + max(P - W + 1, 0), row b's output is
//   column 0 (the trailing partial window): emitted iff 0 < n_valid < W,
//          and then the unsigned (score, kmer) minimum of the stream's
//          n_valid seeds; U64_MAX when not emitted;
//   column 1 + j, j < P - W + 1: the minimum of stream positions
//          [j, j + W - 1], emitted iff j + W <= n_valid.
// The score is frev64(kmer), the entropy-file score (scores.cuh), the
// k-mer's value in the phase-1 image, U64_MAX where it is missing (DNA
// only; probe.cuh; ScoreMap.lookup_scores, bonsai_tpu/db/table.py:501), or
// the Shannon score of the seed's k codes with eps 1e-3 (scores.cuh; a
// DNA seed's counted from its uncanonical k-mer); with ``canon`` (DNA,
// Shannon) every emitted value is then replaced by its canonical form.
//
// What bounds it on an H100: the bytes, 1 B of codes a base in and 9 B a
// slot out (~42 MB, ~0.0125 ms at 3.35 TB/s for a 4M-base chunk); the
// compacted stream of this design adds 8 B a valid seed written and read
// back, and the work is a few integer ops a position (a double divide
// for the entropy-file score; under the hash score a phase-1 probe a
// valid seed, one or two random 32-B rows, which then bound it).  The
// design is two launches:
//   1. compact: a block of 256 threads owns kTile = 4096 seed positions
//      of a row, its tile id from an atomic counter over every row's
//      tiles.  It stages the tile's codes and the k - 1 halo in shared
//      memory by 16-B vector loads; each thread rolls the k-mers of its
//      kRun positions as KB1 does, flags the valid ones, and a block scan
//      of the flags places each in the tile.  The tile's offset in its
//      row comes from a decoupled look-back over the row's earlier tiles
//      (lookback.cuh, as KB2 and KB3), and the tile's valid k-mers go out
//      through shared memory with coalesced stores.  The row's last tile
//      writes n_valid.
//   2. window: a block owns kTile window slots of a row, stages the
//      stream's kTile + W - 1 positions with their scores (computed here,
//      so the stream carries k-mers only; a position past n_valid is the
//      sentinel and is never scored, so the hash score probes real seeds
//      alone, kProbeBatch of a thread's at once with probe.cuh
//      hash_scores, so that a thread keeps that many rows in flight), and
//      takes each thread's kRun
//      window minima from blocks of W positions (van Herk / Gil-Werman,
//      as KB1); the first block of a row also takes the tail, one warp
//      reducing at most W - 1 seeds.
// One entry point picks the instantiation from its arguments.  In the
// kGen instantiations another alphabet folds each
// position's k codes from the staged tile (k shared loads a position, the
// simple way); their Shannon score needs the seed's codes, which only
// the compaction launch holds, so there it scores each valid seed (k + 1
// scans of its k codes at most, scores.cuh) and writes the scores as a
// second stream beside the k-mers, which the window launch reads.  A DNA
// seed's codes are its k-mer's 2-bit groups, so the window launch scores
// it from the staged k-mer (four popcounts, scores.cuh
// shannon_dna_score), as it scores lex, and no score stream exists.
// A row is one 4M-base chunk of a genome in the device build and a read
// in the tests: rows of any length and any count up to the grid's 65535
// work, since the compaction is row-wide across tiles.
//
// The stream source (entry bk_compacted_stream) compacts a given (B, P)
// stream of u64 values with their validity flags instead of rolling
// k-mers from codes, so k is unbounded: the windowed rolling minimizers
// of bonsai_tpu/core/rolling.py RollingEncoder.emissions (:174-195), whose
// values are the cyclic hashes of KR1 (rolling.cu).  Its compaction
// stages each tile's values and flags by coalesced loads, then places
// the valid ones as above; the window launch is the lex one (frev64 of
// the value).  It reads 9 B a position and writes 9 B a slot, the stream
// 8 B a valid value both ways.

#include <cstdint>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

#include "lookback.cuh"
#include "probe.cuh"
#include "scores.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                // positions (slots) a thread owns
constexpr int kTile = kThreads * kRun;  // positions (slots) a block owns
constexpr uint64_t kSentinel = ~0ull;
constexpr int kProbeBatch = 4;  // seeds a thread probes at once (hash)

__device__ __host__ __forceinline__ int sx(int p) { return p + (p >> 4); }

__device__ __forceinline__ bool at_or_before(uint64_t s, uint64_t v,
                                             uint64_t bs, uint64_t bv) {
  return s < bs || (s == bs && v <= bv);
}

// the window launch's score: lex or entropy-file (runtime ``entropy``),
// the phase-1 score, the Shannon score of a DNA k-mer, or the score the
// compaction stored (the Shannon score of another alphabet's seed)
enum WindowScore { kLexFile, kHash, kShannonDna, kStored };

template <int kWin>
__device__ __forceinline__ uint64_t score_of(uint64_t kmer, int entropy,
                                             double denom,
                                             const bk::ProbeTable& tbl,
                                             const bk::Shannon& sh, int k) {
  if constexpr (kWin == kHash)
    return bk::hash_score(tbl, kmer);
  else if constexpr (kWin == kShannonDna)
    return bk::shannon_dna_score(kmer, k, sh);
  else
    return entropy ? bk::entropy_file_score(kmer, denom) : bk::frev64(kmer);
}

// -- 1. compact ---------------------------------------------------------------

// kGen: another alphabet's fold; kScored (kGen only): the Shannon score
// of each valid seed into ``sstream``
template <bool kGen, bool kScored>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(const int8_t* __restrict__ codes,
                   const int32_t* __restrict__ lengths, int64_t L, int k,
                   int64_t P, int64_t T, uint32_t* __restrict__ tile_ctr,
                   uint32_t* status, uint64_t* __restrict__ stream,
                   int64_t* __restrict__ n_valid,
                   uint64_t* __restrict__ sstream, bk::Fold fold,
                   bk::Shannon sh) {
  using Scan = cub::BlockScan<int32_t, kThreads>;
  __shared__ __align__(16) int8_t s_code[kTile + 32 + 16 + 16];
  __shared__ uint64_t s_km[kTile];  // the tile's k-mers, then its valid ones
  __shared__ typename Scan::TempStorage tmp;
  __shared__ uint32_t s_tile, s_before;
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = atomicAdd(tile_ctr, 1u);
  __syncthreads();
  const int64_t row = s_tile / T;
  const int64_t tile = s_tile - row * T;
  const int64_t p0 = tile * kTile;

  // stage codes [p0, p0 + kTile + k - 1) of the row, -1 past it
  const int need = kTile + k - 1;
  const int8_t* src = codes + row * L + p0;
  const int64_t avail = min((int64_t)need, L - p0);
  const int shift = (int)((uintptr_t)src & 15);
  const int nchunk = (shift + need + 15) >> 4;
  for (int q = tid; q < nchunk; q += kThreads) {
    const int lo = q * 16 - shift;
    union {
      int4 v;
      int8_t b[16];
    } u;
    if (lo >= 0 && lo + 16 <= avail) {
      u.v = *(const int4*)(src + lo);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        u.b[e] = lo + e >= 0 && lo + e < avail ? src[lo + e] : (int8_t)-1;
    }
    *(int4*)(s_code + q * 16) = u.v;
  }
  __syncthreads();

  // roll the k-mers of this thread's kRun positions; flag the valid ones
  const int64_t n_push =
      min(max((int64_t)lengths[row] - (k - 1), (int64_t)0), P);
  const uint64_t mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const int r0 = tid * kRun;
  uint32_t ok = 0;
  if constexpr (kGen) {
    for (int r = 0; r < kRun; ++r) {
      const int8_t* cp = s_code + shift + r0 + r;
      uint64_t v = 0;
      bool n_in = false;
      for (int i = 0; i < k; ++i) {
        const int c = cp[i];
        n_in |= c < 0;
        v = bk::fold_step(fold, v, c);
      }
      s_km[r0 + r] = bk::fold_finish(fold, v);
      ok |= (uint32_t)(!n_in && p0 + r0 + r < n_push) << r;
    }
  } else {
    const uint32_t* w32 = (const uint32_t*)s_code;
    int ci = shift + r0;
    uint32_t word = w32[ci >> 2] >> (8 * (ci & 3));
    uint64_t fwd = 0;
    int last_n = -1;
    for (int i = 0; i < kRun + k - 1; ++i, ++ci) {
      if (i > 0 && (ci & 3) == 0) word = w32[ci >> 2];
      int c = (int8_t)(word & 0xFF);
      word >>= 8;
      if (c < 0) {
        last_n = i;
        c = 0;
      }
      fwd = ((fwd << 2) | (uint64_t)c) & mask;
      const int r = i - (k - 1);
      if (r < 0) continue;
      s_km[r0 + r] = fwd;
      ok |= (uint32_t)(last_n < r && p0 + r0 + r < n_push) << r;
    }
  }
  // a thread's valid k-mers move left, onto slots other threads may still
  // read: each reads its own first
  uint64_t km[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) km[r] = s_km[r0 + r];
  uint64_t sc[kScored ? kRun : 1];
  if constexpr (kScored) {
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int8_t* cp = s_code + shift + r0 + r;
      sc[r] = ok >> r & 1 ? bk::shannon_score(
                                km[r], [&](int i) { return (int)cp[i]; }, k,
                                sh)
                          : 0;
    }
  }
  int32_t off, cnt;
  Scan(tmp).ExclusiveSum(__popc(ok), off, cnt);
  const int32_t off0 = off;
  __syncthreads();  // every thread holds its k-mers before any moves
#pragma unroll
  for (int r = 0; r < kRun; ++r)
    if (ok >> r & 1) s_km[off++] = km[r];
  if (tid == 0) {
    bk::publish(status + row * T, tile, 1, (uint32_t)cnt);
    s_before = bk::look_back(status + row * T, tile, 1, (uint32_t)cnt);
  }
  __syncthreads();
  const int64_t before = s_before;
  uint64_t* out = stream + row * P + before;
  for (int j = tid; j < cnt; j += kThreads) out[j] = s_km[j];
  if (tid == 0 && tile == T - 1) n_valid[row] = before + cnt;
  if constexpr (kScored) {  // the scores, through s_km again
    __syncthreads();
    off = off0;
#pragma unroll
    for (int r = 0; r < kRun; ++r)
      if (ok >> r & 1) s_km[off++] = sc[r];
    __syncthreads();
    uint64_t* sout = sstream + row * P + before;
    for (int j = tid; j < cnt; j += kThreads) sout[j] = s_km[j];
  }
}

// the stream source: a tile's valid values of a given stream, compacted
// as compact_kernel compacts its k-mers
__global__ void __launch_bounds__(kThreads)
    compact_stream_kernel(const uint64_t* __restrict__ values,
                          const bool* __restrict__ valid, int64_t P,
                          int64_t T, uint32_t* __restrict__ tile_ctr,
                          uint32_t* status, uint64_t* __restrict__ stream,
                          int64_t* __restrict__ n_valid) {
  using Scan = cub::BlockScan<int32_t, kThreads>;
  __shared__ uint64_t s_km[kTile];
  __shared__ __align__(16) uint8_t s_f[kTile];  // the valid flags
  __shared__ typename Scan::TempStorage tmp;
  __shared__ uint32_t s_tile, s_before;
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = atomicAdd(tile_ctr, 1u);
  __syncthreads();
  const int64_t row = s_tile / T;
  const int64_t tile = s_tile - row * T;
  const int64_t p0 = tile * kTile;
  const int n = (int)min((int64_t)kTile, P - p0);
  const uint64_t* vrow = values + row * P + p0;
  const bool* frow = valid + row * P + p0;
  for (int p = tid; p < kTile; p += kThreads) {
    const bool in = p < n;
    s_km[p] = in ? vrow[p] : 0;
    s_f[p] = in && frow[p];
  }
  __syncthreads();
  const int r0 = tid * kRun;
  uint32_t ok = 0;
  {
    const uint4 f = *(const uint4*)(s_f + r0);  // kRun = 16 flags
    const uint32_t w[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int r = 0; r < kRun; ++r)
      ok |= (uint32_t)((w[r >> 2] >> (8 * (r & 3))) & 1) << r;
  }
  uint64_t km[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) km[r] = s_km[r0 + r];
  int32_t off, cnt;
  Scan(tmp).ExclusiveSum(__popc(ok), off, cnt);
  __syncthreads();  // every thread holds its values before any moves
#pragma unroll
  for (int r = 0; r < kRun; ++r)
    if (ok >> r & 1) s_km[off++] = km[r];
  if (tid == 0) {
    bk::publish(status + row * T, tile, 1, (uint32_t)cnt);
    s_before = bk::look_back(status + row * T, tile, 1, (uint32_t)cnt);
  }
  __syncthreads();
  const int64_t before = s_before;
  uint64_t* out = stream + row * P + before;
  for (int j = tid; j < cnt; j += kThreads) out[j] = s_km[j];
  if (tid == 0 && tile == T - 1) n_valid[row] = before + cnt;
}

// -- 2. window minima -----------------------------------------------------------

// kStored reads the scores from ``sstream``; kShannonDna with ``canon``
// canonicalizes each emitted value (a DNA k-mer of k bases)
template <int kWin>
__global__ void __launch_bounds__(kThreads)
    window_kernel(const uint64_t* __restrict__ stream,
                  const int64_t* __restrict__ n_valid, int64_t P, int W,
                  int64_t E, int entropy, double denom, bk::ProbeTable tbl,
                  int64_t* __restrict__ keys, bool* __restrict__ emitted,
                  const uint64_t* __restrict__ sstream, int canon, int k,
                  bk::Shannon sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int npos = kTile + W - 1;
  const int nsx = sx(npos - 1) + 1;
  uint64_t* s_val = (uint64_t*)smem;
  uint64_t* s_score = s_val + nsx;
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.y;
  const int64_t j0 = (int64_t)blockIdx.x * kTile;
  const int64_t nv = n_valid[row];
  const int64_t ew = E - 1;  // window slots of the row
  const uint64_t* srow = stream + row * P;
  const uint64_t* scrow = sstream + row * P;  // kStored
  // the score of stream position q < nv
  auto score = [&](int64_t q, uint64_t v) {
    if constexpr (kWin == kStored)
      return scrow[q];
    else
      return score_of<kWin>(v, entropy, denom, tbl, sh, k);
  };
  int64_t* krow = keys + row * E;
  bool* erow = emitted + row * E;

  // the tail: the first block of the row, one warp
  if (blockIdx.x == 0 && tid < 32) {
    uint64_t bs = kSentinel, bv = kSentinel;
    const bool tail = nv > 0 && nv < W;
    if (tail)
      for (int64_t q = tid; q < nv; q += 32) {
        const uint64_t v = srow[q];
        const uint64_t s = score(q, v);
        if (at_or_before(s, v, bs, bv)) bs = s, bv = v;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const uint64_t s = __shfl_down_sync(0xFFFFFFFFu, bs, o);
      const uint64_t v = __shfl_down_sync(0xFFFFFFFFu, bv, o);
      if (at_or_before(s, v, bs, bv)) bs = s, bv = v;
    }
    if (tid == 0) {
      if (kWin == kShannonDna && canon && tail) bv = bk::canonical(bv, k);
      krow[0] = (int64_t)(tail ? bv : kSentinel);
      erow[0] = tail;
    }
  }
  if (j0 >= ew) return;  // P < W: the tail only

  // stage stream positions [j0, j0 + npos) with their scores; the hash
  // score probes kProbeBatch positions a thread at once, kThreads apart
  if constexpr (kWin == kHash) {
    const int64_t nseed = min((int64_t)npos, nv - j0);  // positions < nv
    for (int b = 0; b < npos; b += kThreads * kProbeBatch) {
      const int n = (int)max(
          min((int64_t)kProbeBatch,
              (nseed - b - tid + kThreads - 1) / kThreads),
          (int64_t)0);
      uint64_t v[kProbeBatch], s[kProbeBatch];
#pragma unroll
      for (int u = 0; u < kProbeBatch; ++u)
        v[u] = u < n ? srow[j0 + b + u * kThreads + tid] : kSentinel;
      bk::hash_scores(tbl, v, s, n);
#pragma unroll
      for (int u = 0; u < kProbeBatch; ++u) {
        const int p = b + u * kThreads + tid;
        if (p < npos) {
          s_val[sx(p)] = v[u];
          s_score[sx(p)] = s[u];
        }
      }
    }
  } else {
    for (int p = tid; p < npos; p += kThreads) {
      const int64_t q = j0 + p;
      uint64_t v = kSentinel, s = kSentinel;
      if (q < nv) {
        v = srow[q];
        s = score(q, v);
      }
      s_val[sx(p)] = v;
      s_score[sx(p)] = s;
    }
  }
  __syncthreads();

  // each thread's kRun window minima (van Herk / Gil-Werman, as in KB1):
  // a window meets at most two blocks of W positions, so its minimum is
  // the lesser of a suffix minimum of one and a prefix minimum of the next
  const int j = tid * kRun;
  uint64_t best[kRun];
  if (W == 1) {
#pragma unroll
    for (int r = 0; r < kRun; ++r) best[r] = s_val[sx(j + r)];
  } else {
    uint16_t suf[kRun];
    {
      uint64_t bs = 0, bv = 0;
      int bp = 0;
      int q = W - 1;
      for (int p = ((kRun - 1) / W + 1) * W - 1; p >= kRun; --p) {
        const uint64_t s = s_score[sx(j + p)], v = s_val[sx(j + p)];
        if (q == W - 1 || at_or_before(s, v, bs, bv)) bs = s, bv = v, bp = p;
        q = q ? q - 1 : W - 1;
      }
#pragma unroll
      for (int r = kRun - 1; r >= 0; --r) {
        const uint64_t s = s_score[sx(j + r)], v = s_val[sx(j + r)];
        if (q == W - 1 || at_or_before(s, v, bs, bv)) bs = s, bv = v, bp = r;
        q = q ? q - 1 : W - 1;
        suf[r] = (uint16_t)bp;
      }
    }
    uint64_t bs = 0, bv = 0;
    int q = 0;
    for (int p = 0; p < W - 1; ++p) {
      const uint64_t s = s_score[sx(j + p)], v = s_val[sx(j + p)];
      if (q == 0 || at_or_before(s, v, bs, bv)) bs = s, bv = v;
      q = q == W - 1 ? 0 : q + 1;
    }
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int p = W - 1 + r;
      const uint64_t s = s_score[sx(j + p)], v = s_val[sx(j + p)];
      if (q == 0 || at_or_before(s, v, bs, bv)) bs = s, bv = v;
      q = q == W - 1 ? 0 : q + 1;
      const int x = sx(j + suf[r]);
      best[r] = at_or_before(s_score[x], s_val[x], bs, bv) ? s_val[x] : bv;
    }
  }
  __syncthreads();  // every window is read before the slots overwrite it
#pragma unroll
  for (int r = 0; r < kRun; ++r) s_val[sx(j + r)] = best[r];
  __syncthreads();

  // out, coalesced: slot j0 + s goes to column 1 + j0 + s
  const int nslot = (int)min((int64_t)kTile, ew - j0);
  for (int s = tid; s < nslot; s += kThreads) {
    uint64_t v = s_val[sx(s)];
    const bool e = j0 + s + W <= nv;
    if (kWin == kShannonDna && canon && e) v = bk::canonical(v, k);
    krow[1 + j0 + s] = (int64_t)v;
    erow[1 + j0 + s] = e;
  }
}

int64_t tiles_of(int64_t P) { return (P + kTile - 1) / kTile; }

int window_smem(int W) {
  const int npos = kTile + W - 1;
  return (sx(npos - 1) + 1) * 16;
}

// Scratch: the compacted stream (and with ``scored`` its scores), the
// rows' n_valid, the tiles' status words and the tile counter.
struct Buffers {
  uint64_t* stream;
  uint64_t* sstream;
  int64_t* n_valid;
  uint32_t* status;
  uint32_t* tile_ctr;
  int64_t zero_bytes;  // status words and counter, cleared each call
  int64_t used;
};

Buffers carve(char* p, int64_t B, int64_t L, bool scored = false) {
  const int64_t P = L > 0 ? L : 1;  // at most L seeds a row
  bk::Carve c{p};
  Buffers b;
  b.stream = c.take<uint64_t>(B * P);
  b.sstream = scored ? c.take<uint64_t>(B * P) : nullptr;
  b.n_valid = c.take<int64_t>(B);
  const int64_t before = c.used;
  b.status = c.take<uint32_t>(B * tiles_of(P));
  b.tile_ctr = c.take<uint32_t>(1);
  b.zero_bytes = c.used - before;
  b.used = c.used;
  return b;
}

// the window launch over a compacted stream of P positions a row
template <int kWin>
int window(const Buffers& b, int64_t B, int64_t P, int W, int entropy,
           double denom, const bk::ProbeTable& tbl, void* keys, void* emitted,
           int canon, int k, const bk::Shannon& sh, cudaStream_t s) {
  const int64_t E = 1 + (P - W + 1 > 0 ? P - W + 1 : 0);
  const int smem = window_smem(W);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_kernel<kWin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t tw = E > 1 ? (E - 1 + kTile - 1) / kTile : 1;
  window_kernel<kWin><<<dim3((unsigned)tw, (unsigned)B), kThreads, smem, s>>>(
      b.stream, b.n_valid, P, W, E, entropy, denom, tbl, (int64_t*)keys,
      (bool*)emitted, b.sstream, canon, k, sh);
  return (int)cudaGetLastError();
}

template <bool kGen, int kWin>
int run(const void* codes, const void* lengths, int64_t B, int64_t L, int k,
        int W, int entropy, double denom, const bk::ProbeTable& tbl,
        void* keys, void* emitted, void* scratch, void* stream,
        const bk::Fold& fold = bk::Fold{}, const bk::Shannon& sh = {},
        int canon = 0) {
  constexpr bool kScored = kWin == kStored;
  const int64_t P = L - k + 1;
  if (B <= 0 || P <= 0 || P >= bk::kMaxCount || k < 1 || k > 32 || W < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Buffers b = carve((char*)scratch, B, L, kScored);
  cudaError_t e = cudaMemsetAsync(b.status, 0, b.zero_bytes, s);
  if (e != cudaSuccess) return (int)e;
  const int64_t T = tiles_of(P);
  compact_kernel<kGen, kScored><<<(unsigned)(B * T), kThreads, 0, s>>>(
      (const int8_t*)codes, (const int32_t*)lengths, L, k, P, T, b.tile_ctr,
      b.status, b.stream, b.n_valid, b.sstream, fold, sh);
  return window<kWin>(b, B, P, W, entropy, denom, tbl, keys, emitted, canon,
                      k, sh, s);
}

}  // namespace

// Bytes of scratch for a call on (B, L); ``scored`` for the Shannon
// score of another alphabet than DNA, whose scores go to a second stream.
extern "C" int64_t bk_compacted_minimizers_gen_scratch(int64_t B, int64_t L,
                                                       int64_t scored) {
  return carve(nullptr, B, L, scored != 0).used;
}

// The stream source: values (B, P) int64-held u64, valid (B, P) bool ->
// keys (B, E) int64-held u64, emitted (B, E) bool, E = 1 + max(P - W + 1,
// 0), scored by frev64 of the value; 1 <= W <= 8192, 1 <= P < 2^30, B <=
// 65535.  Scratch from bk_compacted_minimizers_gen_scratch(B, P, 0).
extern "C" int bk_compacted_stream(const void* values, const void* valid,
                                   int64_t B, int64_t P, int W, void* keys,
                                   void* emitted, void* scratch,
                                   void* stream) {
  if (B <= 0 || B > 65535 || P < 1 || P >= bk::kMaxCount || W < 1 ||
      W > 8192)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Buffers b = carve((char*)scratch, B, P);
  cudaError_t e = cudaMemsetAsync(b.status, 0, b.zero_bytes, s);
  if (e != cudaSuccess) return (int)e;
  const int64_t T = tiles_of(P);
  compact_stream_kernel<<<(unsigned)(B * T), kThreads, 0, s>>>(
      (const uint64_t*)values, (const bool*)valid, P, T, b.tile_ctr,
      b.status, b.stream, b.n_valid);
  return window<kLexFile>(b, B, P, W, 0, 0.0, bk::ProbeTable{}, keys,
                          emitted, 0, 0, bk::Shannon{}, s);
}

// The one entry point.  codes (B, L) int8, lengths (B,) int32 -> keys
// (B, E) int64-held u64, emitted (B, E) bool, E = 1 + max(P - W + 1, 0),
// P = L - k + 1 >= 1; 1 <= k <= 32, 1 <= W <= 8192, P < 2^30.  ``fold``
// 0 is DNA's 2-bit code, 1 shift-or by ``bits`` with the mask ``lim``, 2
// multiply-add by ``radix`` with the modulus ``lim``; ``score`` 0 lex, 1
// entropy-file (quotient by ``denom``), 2 hash (DNA: each valid seed
// scored by its value in the phase-1 image, slots (nb, 4), lgnb, vbits,
// vals, n_vals, inline, as db/table.py ProbeArrays.args), 3 Shannon
// (``terms``: k + 1 doubles on the card, ``R`` codes in the alphabet,
// ``eps``), which alone takes ``canon`` (DNA: each emitted value
// canonicalized).  Scratch from bk_compacted_minimizers_gen_scratch.
extern "C" int bk_compacted_minimizers_gen(
    const void* codes, const void* lengths, int64_t B, int64_t L, int k,
    int W, int fold, int bits, uint64_t radix, uint64_t lim, int score,
    double denom, const void* slots, int lgnb, int vbits, const void* vals,
    int64_t n_vals, int is_inline, const void* terms, int R, double eps,
    int canon, void* keys, void* emitted, void* scratch, void* stream) {
  const bk::ProbeTable t{(const ulonglong2*)slots, (const uint64_t*)vals,
                         n_vals, lgnb, vbits, is_inline};
  const bk::Fold f{fold, bits, radix, lim};
  const bk::Shannon sh{(const double*)terms, R, eps};
  const bool gen = fold != bk::kFoldDna;
  if ((canon && (gen || score != 3)) || (gen && score == 2))
    return (int)cudaErrorInvalidValue;
#define BK(kGen, kWin)                                                       \
  return run<kGen, kWin>(codes, lengths, B, L, k, W, score == 1, denom, t,  \
                         keys, emitted, scratch, stream, f, sh, canon)
  switch (score) {
    case 0:
    case 1:
      if (gen) BK(true, kLexFile);
      BK(false, kLexFile);
    case 2:
      BK(false, kHash);
    case 3:
      if (gen) BK(true, kStored);
      BK(false, kShannonDna);
  }
#undef BK
  return (int)cudaErrorInvalidValue;
}

// The blocks of bk_compacted_minimizers_gen's hash window launch for a
// window of W that one SM holds at once, or minus a CUDA error.
extern "C" int bk_compacted_minimizers_hash_blocks_per_sm(int W) {
  const int smem = window_smem(W);
  const void* f = (const void*)window_kernel<kHash>;
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, f, kThreads, smem);
  return e == cudaSuccess ? n : -(int)e;
}
