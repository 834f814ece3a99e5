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
// k-mer's value in the phase-1 image, U64_MAX where it is missing
// (probe.cuh; ScoreMap.lookup_scores, bonsai_tpu/db/table.py:501; another
// alphabet's k-mer is probed as its fold leaves it: `minimized_map(...,
// input_type=)`, bonsai_tpu/db/build.py:644), or
// the Shannon score of the seed's k codes with eps 1e-3 (scores.cuh; a
// DNA seed's counted from its uncanonical k-mer); with ``canon`` (DNA,
// Shannon) every emitted value is then replaced by its canonical form.
//
// What bounds it on an H100: the bytes, 1 B of codes a base in and 9 B a
// slot out (~42 MB, ~0.0125 ms at 3.35 TB/s for a 4M-base chunk), and
// the work is a few integer ops a position (a double divide for the
// entropy-file and Shannon scores; under the hash score a phase-1 probe
// a valid seed, one or two random 32-B rows, which then bound it).  The
// compacted stream never goes to device memory.  Two launches:
//   1. count: a block of 256 threads stages the codes of one tile of
//      kTile = 4096 seed positions of a row, a thread takes the N bits of
//      its 16 positions and the k - 1 after them, and the block writes
//      the tile's count of valid seeds: B x T u32 of scratch, no
//      look-back, no memset.
//   2. window: a block owns one tile of a row.  Its offset in the stream
//      is the sum of its row's earlier counts, and n_valid the sum of all
//      (a block reduction over the row's T counts, read from L2).  Its
//      window slots are its own valid seeds, [offset, offset + count),
//      and they read W - 1 valid seeds past the tile, a forward halo.  In
//      rounds the block stages codes in shared memory, flags the valid
//      seeds of each thread's run by N bits, places them by a block scan,
//      and rolls the k-mers straight into a shared stream of count + W -
//      1 (score, kmer) pairs; then it scores the round's places, a
//      thread's places 256 apart (lex, entropy-file, Shannon), so that
//      their divides overlap.  Round 1 is the tile and the first
//      kHaloGuess positions after it; while the halo is short of W - 1
//      seeds and the row has more, each further round reads the rest of
//      a tile, skipping the tiles whose counts say they hold nothing more
//      (N runs, empty tiles), guided by the counts alone.  The hash score
//      probes the shared stream kProbeBatch seeds a thread at once
//      (probe.cuh hash_scores) after the rounds: each valid seed once,
//      those of a halo also by the tile before.  Shared memory holds the
//      stream and a round's codes: ~74 KB at W = 10-13 (three blocks an
//      SM where the registers allow), ~209 KB at W = 8192 (one).  Then
//      each thread takes its kRun window minima from
//      blocks of W positions (van Herk / Gil-Werman, as KB1) and the
//      slots go out coalesced.  A block also writes the columns past
//      n_valid that fall in its tile's range (U64_MAX, not emitted), and
//      the block holding stream position 0 writes column 0 (one warp
//      reducing the n_valid < W seeds, all inside its shared stream).
// One entry point picks the instantiation from its arguments.  In the
// kGen instantiations another alphabet's k-mer is rolled (shift-or and
// mask, or multiply-add less the outgoing code times radix^(k-1), both
// modulo 2^64, then apply_mask: fold_finish, which the shared stream
// holds, so that the hash score probes exactly that value), and its
// Shannon score counts the seed's
// staged codes once into packed fields (scores.cuh CodeCounts; PROTEIN's
// 256 codes take shannon_h's passes).  A DNA seed's Shannon score counts
// its codes from the k-mer (four popcounts, scores.cuh
// shannon_dna_score).  A row is one 4M-base
// chunk of a genome in the device build and a read in the tests: rows of
// any length (P < 2^30) and any count up to the grid's 65535.  A block
// reads its row's T counts, so a row of T tiles costs T^2 / 2 counts read
// from L2 (512K for a 4M-base chunk; ~1.9G for a 250M-base one).
//
// The stream source (entry bk_compacted_stream) takes a given (B, P)
// stream of u64 values with their validity flags instead of rolling
// k-mers from codes, so k is unbounded: the windowed rolling minimizers
// of bonsai_tpu/core/rolling.py RollingEncoder.emissions (:174-195), whose
// values are the cyclic hashes of KR1 (rolling.cu).  Its count launch
// sums a tile's flags; its window launch loads a round's values and flags
// coalesced (a warp 32 consecutive positions) and places the valid ones
// by warp ballots, scored lex (frev64 of the value).  It reads 9 B a
// position and writes 9 B a slot.

#include <cstdint>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

#include "lookback.cuh"
#include "probe.cuh"
#include "scores.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 16;                // window slots a thread owns
constexpr int kTile = kThreads * kRun;  // seed positions a tile holds
constexpr int kHaloGuess = kThreads;    // round 1's positions past its tile
constexpr int kRoundMax = kTile + kHaloGuess;  // positions of a round
constexpr int kRunMax = kRoundMax / kThreads;  // positions a thread's round
// staged codes of a round: k - 1 <= 31 more, and the 16-B alignment
constexpr int kCodeBytes = kRoundMax + 32 + 16 + 16;
constexpr uint64_t kSentinel = ~0ull;
constexpr int kProbeBatch = 4;  // seeds a thread probes at once (hash)

__device__ __host__ __forceinline__ int sx(int p) { return p + (p >> 4); }

__device__ __forceinline__ bool at_or_before(uint64_t s, uint64_t v,
                                             uint64_t bs, uint64_t bv) {
  return s < bs || (s == bs && v <= bv);
}

// where the seeds come from: DNA codes, another alphabet's codes, or a
// given stream of values and flags
enum Source { kDna, kGen, kStream };
// the score: lex or entropy-file (runtime ``entropy``), the phase-1
// score, the Shannon score of a DNA k-mer or of another alphabet's seed
enum WindowScore { kLexFile, kHash, kShannonDna, kShannonGen };

struct Args {
  const int8_t* codes;  // (B, L), or the stream source's:
  const uint64_t* values;
  const bool* valid;  // (B, P)
  const int32_t* lengths;
  int64_t L, P, T, E;
  int k, W;
  uint32_t* counts;  // (B, T) valid seeds a tile
  int entropy;
  double denom;
  bk::ProbeTable tbl;
  bk::Fold fold;
  bk::Shannon sh;
  int canon;
  int64_t* keys;
  bool* emitted;
};

// seed positions of the row that can be valid: [0, n_push)
__device__ __forceinline__ int64_t n_push_of(const Args& a, int64_t row,
                                             bool stream) {
  if (stream) return a.P;
  return min(max((int64_t)a.lengths[row] - (a.k - 1), (int64_t)0), a.P);
}

// (kShannonDna: ``sh`` with the block's shared copy of the terms)
template <int kWin>
__device__ __forceinline__ uint64_t score_of(const Args& a,
                                             const bk::Shannon& sh,
                                             uint64_t kmer) {
  if constexpr (kWin == kShannonDna)
    return bk::shannon_dna_score(kmer, a.k, sh);
  else
    return a.entropy ? bk::entropy_file_score(kmer, a.denom)
                     : bk::frev64(kmer);
}

// Stage bytes [q, q + need) of a row of ``len`` (codes, or the stream
// source's flags) in s_code (-1 past the row) by 16-B chunks from the
// aligned address at or below the first; returns the offset of byte q in
// s_code, which is 16-B aligned.
__device__ __forceinline__ int stage_bytes(const int8_t* src_row, int64_t len,
                                           int64_t q, int need,
                                           int8_t* s_code) {
  const int8_t* src = src_row + q;
  const int64_t avail = min((int64_t)need, len - q);
  const int shift = (int)((uintptr_t)src & 15);
  const int nchunk = (shift + need + 15) >> 4;
  for (int c = threadIdx.x; c < nchunk; c += kThreads) {
    const int lo = c * 16 - shift;
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
    *(int4*)(s_code + c * 16) = u.v;
  }
  return shift;
}

// Bit i: bit kBit of staged byte at + i, for i < 64 - (at & 15) (four
// 16-B loads; the bytes past the staged ones give bits nobody reads)
template <int kBit>
__device__ __forceinline__ uint64_t byte_bits(const int8_t* s_code, int at) {
  const uint4* c16 = (const uint4*)s_code + (at >> 4);
  uint64_t x = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 v = c16[j];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)  // the four bytes' bits gathered by a multiply
      x |= (uint64_t)((((w[i] << (7 - kBit)) & 0x80808080u) * 0x00204081u) >>
                      28)
           << (16 * j + 4 * i);
  }
  return x >> (at & 15);
}

// Bit r set: the seed at staged position at + r (r < n <= 17, k <= 32)
// holds no code < 0 and its row position p0 + r is below n_push: the
// codes' sign bits, then the OR of k shifts of them by doubling.
__device__ __forceinline__ uint32_t valid_bits(const int8_t* s_code, int at,
                                               int n, int k, int64_t p0,
                                               int64_t n_push) {
  const int m = (int)min((int64_t)n, max(n_push - p0, (int64_t)0));
  if (m <= 0) return 0;
  uint64_t bad = byte_bits<7>(s_code, at);  // bit i: code at + i is an N
  int span = 1;  // bad's bit r: an N in [r, r + span)
  for (; 2 * span <= k; span *= 2) bad |= bad >> span;
  if (span < k) bad |= bad >> (k - span);
  return ~(uint32_t)bad & ((1u << m) - 1);
}

// the sum of ``v`` over the block, in every thread (s_red: kWarps words)
__device__ __forceinline__ int64_t block_sum(int64_t v, int64_t* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  __syncthreads();  // s_red's last readers are done
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  int64_t t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += s_red[w];
  return t;
}

// -- 1. count ---------------------------------------------------------------

template <bool kStreamSrc>
__global__ void __launch_bounds__(kThreads) count_kernel(Args a) {
  __shared__ __align__(16) int8_t s_code[kTile + 32 + 16 + 16];
  __shared__ int32_t s_n[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = blockIdx.y, tile = blockIdx.x;
  const int64_t p0 = tile * kTile;
  const int shift =
      kStreamSrc ? stage_bytes((const int8_t*)a.valid + row * a.P, a.P, p0,
                               kTile, s_code)
                 : stage_bytes(a.codes + row * a.L, a.L, p0, kTile + a.k - 1,
                               s_code);
  __syncthreads();
  const int64_t n_push = n_push_of(a, row, kStreamSrc);
  const int at = tid * kRun;
  int n;
  if constexpr (kStreamSrc) {  // a thread's kRun flags
    const int m = (int)min(max(n_push - p0 - at, (int64_t)0), (int64_t)kRun);
    n = __popcll(byte_bits<0>(s_code, shift + at) & ((1ull << m) - 1));
  } else {
    n = __popc(valid_bits(s_code, shift + at, kRun, a.k, p0 + at, n_push));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xFFFFFFFFu, n, o);
  if (lane == 0) s_n[warp] = n;
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) n += s_n[w];
    a.counts[row * a.T + tile] = (uint32_t)n;
  }
}

// -- 2. window minima -------------------------------------------------------

// a block scan of small temp storage (warp scans), so that three blocks of
// the window launch fit an SM at W <= ~120
using Scan = cub::BlockScan<int32_t, kThreads, cub::BLOCK_SCAN_WARP_SCANS>;

struct Shared {
  typename Scan::TempStorage scan;
  int64_t red[kWarps];
  int32_t wc[kRunMax * kWarps];  // the stream source: a warp's valid, a step
  int found;
  double terms[33];  // the Shannon score's terms, k + 1 <= 33
};

// One round of a codes source: the seeds at row positions [q, q + S),
// S <= kRoundMax; the valid ones go to stream places base, base + 1, ...,
// those below ``lim`` into s_val (their k-mers) and s_score.  A thread
// rolls its run's k-mers and writes each valid one to its place (for
// another alphabet's Shannon score, with its staged position in
// s_score); then the block scores the round's places, a thread's places
// kThreads apart, so that their long chains (a double divide, the counted
// codes' terms) run side by side (the hash score comes later).  Returns
// the round's valid seeds, in every thread.
template <int kSrc, int kWin, int kNR>
__device__ int codes_round(const Args& a, int64_t row, int64_t q, int S,
                           int base, int lim, int64_t n_push, uint64_t* s_val,
                           uint64_t* s_score, int8_t* s_code, Shared& sh) {
  __syncthreads();  // the last round is done with s_code and the scan
  const int shift =
      stage_bytes(a.codes + row * a.L, a.L, q, S + a.k - 1, s_code);
  __syncthreads();
  const int tid = threadIdx.x, k = a.k;
  const int rt = (S + kThreads - 1) / kThreads;
  const int r0 = tid * rt;
  const int nr = max(0, min(rt, S - r0));
  const uint32_t ok = valid_bits(s_code, shift + r0, nr, k, q + r0, n_push);
  int32_t at, total;
  Scan(sh.scan).ExclusiveSum(__popc(ok), at, total);
  if (ok) {
    // roll from the run's first code to its last valid seed
    const int last = 31 - __clz(ok);
    const uint64_t mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
    const int8_t* cp = s_code + shift + r0;
    uint64_t v = 0;
    at += base;
    const uint32_t* w32 = (const uint32_t*)s_code;
    int ci = shift + r0;  // byte of the next code in s_code
    uint32_t word = w32[ci >> 2] >> (8 * (ci & 3));
    for (int i = 0; i <= last + k - 1; ++i, ++ci) {
      if (i > 0 && (ci & 3) == 0) word = w32[ci >> 2];
      const int c = (int8_t)(word & 0xFF);
      word >>= 8;
      const uint64_t u = c < 0 ? 0 : c;
      if constexpr (kSrc == kDna)
        v = ((v << 2) | u) & mask;
      else
        v = bk::fold_roll(a.fold, v, u, i >= k ? max((int)cp[i - k], 0) : 0);
      const int r = i - (k - 1);
      if (r < 0 || !(ok >> r & 1)) continue;
      const int place = at++;
      if (place >= lim) continue;
      s_val[sx(place)] = kSrc == kGen ? bk::fold_finish(a.fold, v) : v;
      if constexpr (kWin == kShannonGen) s_score[sx(place)] = r0 + r;
    }
  }
  if constexpr (kWin != kHash) {
    __syncthreads();  // the round's places are written
    [[maybe_unused]] const bk::CountLayout cl = bk::count_layout(k, a.sh.R);
    const bk::Shannon ssh{sh.terms, a.sh.R, a.sh.eps};  // the shared terms
    const int end = min(base + total, lim);
    if constexpr (kWin == kShannonGen) {  // count the seed's staged codes
#pragma unroll 1
      for (int pl = base + tid; pl < end; pl += kThreads) {
        const uint64_t km = s_val[sx(pl)];
        const int8_t* cp = s_code + shift + (int)s_score[sx(pl)];
        if constexpr (kNR > 0) {
          bk::CodeCounts<kNR> cc;
          for (int j = 0; j < k; ++j) cc.add(cl, cp[j]);
          s_score[sx(pl)] = bk::shannon_quotient(km, cc.h(cl, sh.terms), ssh);
        } else {
          s_score[sx(pl)] = bk::shannon_score(
              km, [&](int j) { return (int)cp[j]; }, k, ssh);
        }
      }
    } else {  // four places a thread in flight
#pragma unroll 4
      for (int pl = base + tid; pl < end; pl += kThreads)
        s_score[sx(pl)] = score_of<kWin>(a, ssh, s_val[sx(pl)]);
    }
  }
  return total;
}

// One round of the stream source: positions [q, q + S) of the given
// values and flags, a warp 32 consecutive ones a step.  The flags are
// counted by warp ballots, the counts summed in step-major order, and a
// second pass over the flags (from L1) places the valid values as
// codes_round places its seeds.
__device__ int stream_round(const Args& a, int64_t row, int64_t q, int S,
                            int base, int lim, uint64_t* s_val,
                            uint64_t* s_score, Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rt = (S + kThreads - 1) / kThreads;
  const uint64_t* vrow = a.values + row * a.P + q;
  const bool* frow = a.valid + row * a.P + q;
  __syncthreads();  // the last round is done with sh.wc
  for (int r = 0; r < rt; ++r) {
    const int p = r * kThreads + tid;
    const uint32_t bal = __ballot_sync(0xFFFFFFFFu, p < S && frow[p]);
    if (lane == 0) sh.wc[r * kWarps + warp] = __popc(bal);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive sum of the rt * kWarps counts, step-major
    const int n = rt * kWarps, per = (n + 31) / 32;
    int s = 0;
    for (int j = lane * per; j < min(n, lane * per + per); ++j) s += sh.wc[j];
    int incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - s;
    for (int j = lane * per; j < min(n, lane * per + per); ++j) {
      const int c = sh.wc[j];
      sh.wc[j] = run;
      run += c;
    }
    if (lane == 31) sh.found = incl;  // the round's total
  }
  __syncthreads();
  const uint32_t below = (1u << lane) - 1;
#pragma unroll 4
  for (int r = 0; r < rt; ++r) {
    const int p = r * kThreads + tid;
    const bool f = p < S && frow[p];
    const uint32_t bal = __ballot_sync(0xFFFFFFFFu, f);
    const int place = base + sh.wc[r * kWarps + warp] + __popc(bal & below);
    if (f && place < lim) {
      const uint64_t v = vrow[p];
      s_val[sx(place)] = v;
      s_score[sx(place)] = bk::frev64(v);
    }
  }
  return sh.found;
}

// the first tile u >= from of the row with a count, in every thread (one
// exists)
__device__ int64_t next_counted(const uint32_t* crow, int64_t from,
                                int64_t T, Shared& sh) {
  for (int64_t b = from;; b += kThreads) {
    __syncthreads();  // every thread has read the last sh.found
    if (threadIdx.x == 0) sh.found = kThreads;
    __syncthreads();
    const int64_t u = b + threadIdx.x;
    if (u < T && crow[u] > 0) atomicMin(&sh.found, (int)threadIdx.x);
    __syncthreads();
    if (sh.found < kThreads) return b + sh.found;
  }
}

template <int kSrc, int kWin, int kNR>
__global__ void __launch_bounds__(kThreads) window_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int W = a.W;
  const int npos = kTile + W - 1;  // the shared stream's places
  const int nsx = sx(npos - 1) + 1;
  uint64_t* s_val = (uint64_t*)smem;
  uint64_t* s_score = s_val + nsx;
  int8_t* s_code = (int8_t*)(s_score + nsx);  // the codes sources
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.y, t = blockIdx.x;
  const int64_t p0 = t * kTile;
  const uint32_t* crow = a.counts + row * a.T;
  int64_t* krow = a.keys + row * a.E;
  bool* erow = a.emitted + row * a.E;
  const int64_t ew = a.E - 1;  // window slots of the row
  if constexpr (kWin == kShannonGen || kWin == kShannonDna)
    for (int i = tid; i <= a.k; i += kThreads) sh.terms[i] = a.sh.terms[i];

  // 1. the tile's offset in the row's stream, and n_valid
  int64_t before = 0, all = 0;
  for (int64_t u = tid; u < a.T; u += kThreads) {
    const int64_t c = crow[u];
    all += c;
    before += u < t ? c : 0;
  }
  const int64_t off = block_sum(before, sh.red);
  const int64_t nv = block_sum(all, sh.red);
  const int cnt = (int)crow[t];

  // 2. the slots past n_valid in this tile's range: U64_MAX, not emitted
  for (int64_t j = max(nv, p0) + tid; j < min(p0 + kTile, ew); j += kThreads) {
    krow[1 + j] = (int64_t)kSentinel;
    erow[1 + j] = false;
  }
  // the block holding stream position 0 (tile 0 where there is none)
  // writes column 0
  const bool tail = nv > 0 ? off == 0 && cnt > 0 : t == 0;
  if (cnt == 0 || (off >= ew && !tail)) {
    if (tail && tid == 0) {
      krow[0] = (int64_t)kSentinel;
      erow[0] = false;
    }
    return;
  }

  // 3. the tile's seeds and the halo's W - 1 into the shared stream
  const int need = W - 1, lim = cnt + need;
  const bool stream = kSrc == kStream;
  const int64_t n_push = n_push_of(a, row, stream);
  auto round = [&](int64_t q, int S, int base) {
    if constexpr (kSrc == kStream)
      return stream_round(a, row, q, S, base, lim, s_val, s_score, sh);
    else
      return codes_round<kSrc, kWin, kNR>(a, row, q, S, base, lim, n_push,
                                          s_val, s_score, s_code, sh);
  };
  const int S1 = (int)min((int64_t)kTile + (need ? kHaloGuess : 0),
                          n_push - p0);
  const int v1 = round(p0, S1, 0);
  int have = min(v1 - cnt, need);
  {
    int64_t u = t + 1, q = p0 + S1;
    int seen = v1 - cnt;  // tile u's valid seeds read so far
    while (have < need && off + cnt + have < nv) {
      if (q >= (u + 1) * kTile || seen >= (int)crow[u]) {
        u = next_counted(crow, u + 1, a.T, sh);
        q = u * kTile;
        seen = 0;
      }
      const int S = (int)(min((u + 1) * kTile, n_push) - q);
      const int got = round(q, S, cnt + have);
      seen += got;
      have = min(have + got, need);
      q += S;
    }
  }
  const int nbuf = cnt + have;
  __syncthreads();
  if constexpr (kWin == kHash) {  // kProbeBatch places a thread at once
    for (int b = 0; b < nbuf; b += kThreads * kProbeBatch) {
      const int n = max(min(kProbeBatch, (nbuf - b - tid + kThreads - 1) /
                                             kThreads),
                        0);
      uint64_t v[kProbeBatch], s[kProbeBatch];
#pragma unroll
      for (int u = 0; u < kProbeBatch; ++u)
        v[u] = u < n ? s_val[sx(b + u * kThreads + tid)] : kSentinel;
      bk::hash_scores(a.tbl, v, s, n);
#pragma unroll
      for (int u = 0; u < kProbeBatch; ++u)
        if (u < n) s_score[sx(b + u * kThreads + tid)] = s[u];
    }
  }
  // the sentinel past the stream's end, as far as the windows read
  const int fill = min(npos, (cnt + kRun - 1) / kRun * kRun + W - 1);
  for (int p = nbuf + tid; p < fill; p += kThreads)
    s_val[sx(p)] = s_score[sx(p)] = kSentinel;
  __syncthreads();

  // 4. column 0: one warp over the n_valid < W seeds, all in hand
  if (tail && tid < 32) {
    uint64_t bs = kSentinel, bv = kSentinel;
    const bool emit = nv < W;
    if (emit)
      for (int p = tid; p < nv; p += 32) {
        const uint64_t s = s_score[sx(p)], v = s_val[sx(p)];
        if (at_or_before(s, v, bs, bv)) bs = s, bv = v;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const uint64_t s = __shfl_down_sync(0xFFFFFFFFu, bs, o);
      const uint64_t v = __shfl_down_sync(0xFFFFFFFFu, bv, o);
      if (at_or_before(s, v, bs, bv)) bs = s, bv = v;
    }
    if (tid == 0) {
      if (kWin == kShannonDna && a.canon && emit) bv = bk::canonical(bv, a.k);
      krow[0] = (int64_t)(emit ? bv : kSentinel);
      erow[0] = emit;
    }
  }

  // 5. each thread's kRun window minima (van Herk / Gil-Werman, as in
  //    KB1): a window meets at most two blocks of W positions, so its
  //    minimum is the lesser of a suffix minimum of one and a prefix
  //    minimum of the next
  const int j = tid * kRun;
  uint64_t best[kRun];
  if (j < cnt) {
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
  }
  __syncthreads();  // every window is read before the slots overwrite it
  if (j < cnt) {
#pragma unroll
    for (int r = 0; r < kRun; ++r) s_val[sx(j + r)] = best[r];
  }
  __syncthreads();

  // 6. out, coalesced: slot s goes to column 1 + off + s
  const int nslot = (int)min((int64_t)cnt, ew - off);
  for (int s = tid; s < nslot; s += kThreads) {
    uint64_t v = s_val[sx(s)];
    const bool e = off + s + W <= nv;
    if (kWin == kShannonDna && a.canon && e) v = bk::canonical(v, a.k);
    krow[1 + off + s] = (int64_t)v;
    erow[1 + off + s] = e;
  }
}

int64_t tiles_of(int64_t P) { return (P + kTile - 1) / kTile; }

// dynamic shared memory of the window launch: the stream's (score, kmer)
// pairs, and the staged codes of a codes source
int window_smem(int W, bool codes) {
  return (sx(kTile + W - 2) + 1) * 16 + (codes ? kCodeBytes : 0);
}

// Scratch: the tiles' counts.
int64_t scratch_bytes(int64_t B, int64_t P) {
  bk::Carve c{nullptr};
  c.take<uint32_t>(B * tiles_of(P > 0 ? P : 1));
  return c.used;
}

template <int kSrc, int kWin, int kNR = 0>
int run(Args a, int64_t B, void* scratch, cudaStream_t s) {
  a.T = tiles_of(a.P);
  a.E = 1 + (a.P - a.W + 1 > 0 ? a.P - a.W + 1 : 0);
  a.counts = (uint32_t*)scratch;
  const dim3 grid((unsigned)a.T, (unsigned)B);
  count_kernel<kSrc == kStream><<<grid, kThreads, 0, s>>>(a);
  const int smem = window_smem(a.W, kSrc != kStream);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_kernel<kSrc, kWin, kNR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  window_kernel<kSrc, kWin, kNR><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch for a call on (B, L): the tiles' counts (``scored`` is
// no longer read: no score stream exists).
extern "C" int64_t bk_compacted_minimizers_gen_scratch(int64_t B, int64_t L,
                                                       int64_t scored) {
  (void)scored;
  return scratch_bytes(B, L);
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
  Args a{};
  a.values = (const uint64_t*)values;
  a.valid = (const bool*)valid;
  a.P = P;
  a.W = W;
  a.keys = (int64_t*)keys;
  a.emitted = (bool*)emitted;
  return run<kStream, kLexFile>(a, B, scratch, (cudaStream_t)stream);
}

// The one entry point.  codes (B, L) int8, lengths (B,) int32 -> keys
// (B, E) int64-held u64, emitted (B, E) bool, E = 1 + max(P - W + 1, 0),
// P = L - k + 1 >= 1; 1 <= k <= 32, 1 <= W <= 8192, P < 2^30, B <= 65535.
// ``fold`` 0 is DNA's 2-bit code, 1 shift-or by ``bits`` with the mask
// ``lim``, 2 multiply-add by ``radix`` with the modulus ``lim``; ``score``
// 0 lex, 1 entropy-file (quotient by ``denom``), 2 hash (each valid seed,
// as its alphabet folds it, scored by its value in the phase-1 image,
// slots (nb, 4), lgnb, vbits, vals, n_vals, inline, as db/table.py
// ProbeArrays.args), 3
// Shannon (``terms``: k + 1 doubles on the card, ``R`` codes in the
// alphabet, ``eps``), which alone takes ``canon`` (DNA: each emitted
// value canonicalized).  Scratch from bk_compacted_minimizers_gen_scratch.
extern "C" int bk_compacted_minimizers_gen(
    const void* codes, const void* lengths, int64_t B, int64_t L, int k,
    int W, int fold, int bits, uint64_t radix, uint64_t lim, int score,
    double denom, const void* slots, int lgnb, int vbits, const void* vals,
    int64_t n_vals, int is_inline, const void* terms, int R, double eps,
    int canon, void* keys, void* emitted, void* scratch, void* stream) {
  const int64_t P = L - k + 1;
  const bool gen = fold != bk::kFoldDna;
  if (B <= 0 || B > 65535 || P <= 0 || P >= bk::kMaxCount || k < 1 ||
      k > 32 || W < 1 || W > 8192 || (canon && (gen || score != 3)))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.codes = (const int8_t*)codes;
  a.lengths = (const int32_t*)lengths;
  a.L = L;
  a.P = P;
  a.k = k;
  a.W = W;
  a.entropy = score == 1;
  a.denom = denom;
  a.tbl = bk::ProbeTable{(const ulonglong2*)slots, (const uint64_t*)vals,
                         n_vals, lgnb, vbits, is_inline};
  a.fold = bk::Fold{fold, bits, radix, lim, bk::fold_rpow(radix, k)};
  a.sh = bk::Shannon{(const double*)terms, R, eps};
  a.canon = canon;
  a.keys = (int64_t*)keys;
  a.emitted = (bool*)emitted;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (score) {
    case 0:
    case 1:
      if (gen) return run<kGen, kLexFile>(a, B, scratch, s);
      return run<kDna, kLexFile>(a, B, scratch, s);
    case 2:
      if (gen) return run<kGen, kHash>(a, B, scratch, s);
      return run<kDna, kHash>(a, B, scratch, s);
    case 3:
      if (!gen) return run<kDna, kShannonDna>(a, B, scratch, s);
      switch (bk::count_regs(k, R)) {
        case 1: return run<kGen, kShannonGen, 1>(a, B, scratch, s);
        case 2: return run<kGen, kShannonGen, 2>(a, B, scratch, s);
      }
      return run<kGen, kShannonGen, 0>(a, B, scratch, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The blocks of bk_compacted_minimizers_gen's hash window launch (DNA, or
// with ``gen`` another alphabet) for a window of W that one SM holds at
// once, or minus a CUDA error.
extern "C" int bk_compacted_minimizers_hash_blocks_per_sm(int W, int gen) {
  const int smem = window_smem(W, true);
  const void* f = gen ? (const void*)window_kernel<kGen, kHash, 0>
                      : (const void*)window_kernel<kDna, kHash, 0>;
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, f, kThreads, smem);
  return e == cudaSuccess ? n : -(int)e;
}
