// KB1 minimizers: the k-mers of a batch of rows, contiguous or spaced,
// canonical or not, and for windows of W > 1 k-mers the minimizer of each
// window by the lex, the entropy-file, the phase-1 (score::Hash) or the
// Shannon (scheme "entropy") score; DNA, or another alphabet's fold.
//
// Replaces the device path of bonsai_tpu/core/encoder.py
// BatchEncoder.emissions on its unwindowed branch (:141-153), its
// canonical windowed branch (:174-184) and its spaced branch (:189-204),
// with what they call: encode._pack_contig_fast (:66), pack_spaced_kmers
// and _pack (:59,108), apply_mask (:163), position_validity (:141),
// bitops.canonical (:52), hashes.frev64 (:39), entropy.entropy_scores and
// f64_to_u64_x86 (:91,34; scores.cuh), ScoreMap.lookup_scores
// (db/table.py:501; probe.cuh), window_code_counts, spaced_code_counts
// and entropy_value (core/entropy.py:47,67,82; scores.cuh) and
// minimize.sliding_min / positional_minimizers (:41,65).  Per slot j of row b, with c the seed's
// span (k when contiguous) and n_push = max(len - (c - 1), 0):
//   contiguous, W = 1: value = canonical or raw k-mer at j (an N reads as
//          code 0), emitted = j < n_push and the window holds no N; the
//          sequence-parallel encode's instantiation writes 0 as the
//          value where nothing is emitted;
//   contiguous, W > 1 (canonical): every position pushes ck = N window ?
//          0 : canonical k-mer, scored frev64(ck), entropy-file(ck) or
//          hash(ck), its phase-1 value or U64_MAX (ck = 0 is probed too:
//          the poly-A k-mer can be in phase 1);
//          value = ck of the unsigned (score, ck) minimum over positions
//          [j, j + W - 1], emitted = j + W <= n_push;
//   spaced (never canonical): position p's k-mer folds the codes at
//          p + positions[i], i < k; a seed with an N pushes ov = U64_MAX,
//          scored frev64(U64_MAX) (lex), 0x8000000000000000
//          (entropy-file, Shannon) or hash(U64_MAX) (probed: at k = 32 a
//          real all-T k-mer is U64_MAX), any other ov = its k-mer scored
//          (the Shannon score reads the seed's k codes, eps 1e-4); value
//          = ov of the window minimum, emitted = j + W <= n_push and value
//          != U64_MAX, at W = 1 too (where a contiguous real U64_MAX k-mer
//          is kept);
//   another alphabet (the kGen instantiations, core/encode.py :108-137,
//          :163-170): the spaced discipline with the alphabet's fold
//          (scores.cuh: shift-or and mask, or multiply-add and modulus,
//          an ambiguous code folding as 0), every score but Shannon's of
//          DNA (the hash score probes the folded value: a spaced -t|-f
//          phase 2 of that alphabet, bonsai_tpu/db/build.py:644); its
//          contiguous seeds, at W = 1
//          only: value = the k-mer, emitted = j < n_push and the seed
//          holds no ambiguous code (PROTEIN_3BIT's k = 22 fold of 66 bits
//          can be a real U64_MAX).
// The first base sits in the k-mer's high bits; all compares are unsigned
// over 64 bits; a value is never a sentinel (the emitted flag says it).
//
// What bounds it on an H100: the bytes, 1 B of codes a base in and 9 B a
// slot out (~42 MB, ~0.0125 ms at 3.35 TB/s for a 4M-base chunk); the work
// is a few integer ops a position once each k-mer is rolled (k shared
// loads and shifts a position for a spaced seed, and a double divide for
// the entropy-file score), and with W > 1 a few compares a slot; the hash
// score adds a phase-1 probe a position, one or two random 32-B rows
// (probe.cuh), which then bound it: the card serves random rows at a
// rate well below its bytes' bound, and only as many as are in flight.
// The
// design: a block of 256 threads owns kTile = 4096 slots of a row and
// stages their codes, with the (c - 1) + (W - 1) halo, in shared memory by
// 16-B vector loads.  A contiguous thread builds the k-mer of the first
// position of its run once and then rolls it one base at a time, forward
// and reverse complement together; a position is bad when the last N seen
// lies inside its k-mer.  A spaced thread folds each position's k codes
// out of a rolled window of its span (spacing.cuh), or gathers them from
// the staged tile where the span exceeds 32 bases.  For W = 1 a
// thread's run is its own kRun slots.  For W > 1 the tile's kTile + W - 1
// positions are split into equal runs, their (score, value) pairs go to
// shared memory, and each thread takes the minima of its kRun windows
// from blocks of W positions (van Herk / Gil-Werman), the same steps in
// every lane (equal pairs carry equal values, so ties need no rule).
// Keys go out as coalesced 16-B pairs and the emitted flags of a run as
// one 16-B store, where the row's tile start is 16-B aligned.  The encode
// (contiguous | spaced) and the score (frev64 | entropy-file | hash) are
// template parameters, so the contiguous lex instantiation is the kernel
// it was before them; one entry point picks the instantiation from its
// arguments.  The hash score probes inside the roll, batched
// (RollProbe): each kProbeBatch k-mers of a thread's run go out together
// (probe.cuh ProbeBatch: every first row loaded before any compare), and
// their rows arrive while the thread rolls its next kProbeBatch positions,
// where a probe a position kept one dependent chain (hash, row, compare,
// value) in flight and a step of batched probes after the roll left the
// roll and the probes one after the other (PERF.md, row 6).  The image
// adds kernel arguments, not shared memory; the rows in flight take
// registers (2 blocks a SM at kProbeBatch = 4).  Another alphabet's
// spaced seed under the hash score (kGen, kHash) pushes each position's
// folded k-mer, fold_finish applied (the mask or the modulus: the value a
// phase-1 map of that alphabet holds), or U64_MAX for a seed with an
// ambiguous code, into the same RollProbe; its positions are gathered,
// not rolled, so the batch's rows arrive while the thread gathers the
// next kProbeBatch seeds' k codes.  Another alphabet's
// contiguous seed rolls its fold, one code a position (scores.cuh
// fold_roll: the mask kept, or the outgoing code times radix^(k - 1), from
// the host, subtracted first; the last ambiguous code's index says which
// seeds hold one), where folding k codes a position made k dependent
// shared loads and k 64-bit multiply-adds: a thread folds its run's first
// k - 1 codes, then rolls its kRun seeds in an unrolled loop on the codes
// coming in and going out, read as words at their own byte offset
// (codes4), with the fold's kind an instantiation of its own (kFold).
// Its spaced seeds fold each position's k codes from the
// staged tile (k shared loads a position), and their Shannon score
// counts those k codes as they are folded (scores.cuh CodeCounts, the
// terms in shared memory; PROTEIN's 256 codes: a scan of the k codes for
// each distinct one, shannon_h); a DNA
// spaced seed's Shannon score counts its codes from ov's 2-bit groups
// (four popcounts, scores.cuh shannon_dna_score), rolled or gathered.

#include <cstdint>
#include <cuda_runtime.h>

#include "probe.cuh"
#include "scores.cuh"
#include "spacing.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;                // slots a thread owns
constexpr int kTile = kThreads * kRun;  // slots a block owns
constexpr int kProbeBatch = 4;          // k-mers a thread probes at once

// Shared index of tile position p: one spare word every 16, so that the
// threads of a warp, 16 positions apart, fall in distinct banks.
__device__ __host__ __forceinline__ int sx(int p) { return p + (p >> 4); }

struct Layout {
  int npos;       // positions whose k-mers the tile reads
  int nsx;        // shared words of one position array
  int code_off;   // byte offset of the staged codes (16-B aligned)
  int bytes;      // dynamic shared memory in all
};

// span: the seed's span c (k when contiguous)
__device__ __host__ __forceinline__ Layout layout(int span, int W) {
  Layout l;
  l.npos = kTile + W - 1;
  l.nsx = sx(l.npos - 1) + 1;
  l.code_off = (l.nsx * 8 * (W > 1 ? 2 : 1) + 15) / 16 * 16;
  // the codes, the 16-B staging's shift and rounding, and the word past
  // the last code that a run's codes4 reads (its bytes unused)
  l.bytes = l.code_off + (l.npos + span - 1 + 34) / 16 * 16;
  return l;
}

// the u32 of the 4 staged codes from byte ``b`` of the staged tile (the
// first in its low byte)
__device__ __forceinline__ uint32_t codes4(const uint32_t* w32, int b) {
  return __funnelshift_r(w32[b >> 2], w32[(b >> 2) + 1], 8 * (b & 3));
}

// the score of a pushed k-mer or ov, by kind (kHash: RollProbe)
enum Score { kLex, kEntropy, kHash, kShannon };

template <int kScore>
__device__ __forceinline__ uint64_t score_of(uint64_t v, double denom) {
  if constexpr (kScore == kEntropy)
    return bk::entropy_file_score(v, denom);
  else
    return bk::frev64(v);
}

// The hash score inside the roll: a thread's k-mers, pushed at ascending
// positions, go out kProbeBatch at a time as one ProbeBatch, whose rows
// the roll of the next kProbeBatch positions hides; its scores then land
// in s_score.  An N window's 0 and an N seed's U64_MAX are probed too.
struct RollProbe {
  bk::ProbeBatch<kProbeBatch> pend;  // the batch in flight
  uint64_t km[kProbeBatch];          // the k-mers pushed since, newest last
  int nk = 0;                        // how many
  int at = -1;                       // position of pend's first lane, or -1

  __device__ __forceinline__ void flush(const bk::ProbeTable& t,
                                        uint64_t* s_score) {
    if (at < 0) return;
    uint64_t sc[kProbeBatch];
    pend.finish(t, sc);
#pragma unroll
    for (int u = 0; u < kProbeBatch; ++u)
      if (u < pend.n) s_score[sx(at + u)] = sc[u];
    at = -1;
  }

  __device__ __forceinline__ void shift_in(uint64_t v) {
#pragma unroll
    for (int u = 0; u + 1 < kProbeBatch; ++u) km[u] = km[u + 1];
    km[kProbeBatch - 1] = v;
  }

  __device__ __forceinline__ void push(const bk::ProbeTable& t,
                                       uint64_t* s_score, int p, uint64_t v) {
    shift_in(v);
    if (++nk == kProbeBatch) {
      flush(t, s_score);
      pend.issue(t, km, kProbeBatch);
      at = p - (kProbeBatch - 1);
      nk = 0;
    }
  }

  // after the last push, at position ``end`` - 1
  __device__ __forceinline__ void finish(const bk::ProbeTable& t,
                                         uint64_t* s_score, int end) {
    flush(t, s_score);
    if (nk) {  // the last nk k-mers down to lanes 0..nk-1
      for (int s = nk; s < kProbeBatch; ++s) shift_in(0);
      pend.issue(t, km, nk);
      at = end - nk;
      flush(t, s_score);
    }
  }
};

// (score, value) pair b orders at or before the best so far
__device__ __forceinline__ bool at_or_before(uint64_t s, uint64_t v,
                                             uint64_t bs, uint64_t bv) {
  return s < bs || (s == bs && v <= bv);
}

// span = k for a contiguous seed; sp, denom, tbl, fold, sh and
// unwindowed are read only by the spaced, entropy-file, hash, other
// alphabets' (kGen; contiguous: W = 1, the rolled fold), Shannon and
// sequence-parallel instantiations; kNR is the registers of the Shannon
// score's code counts (scores.cuh CodeCounts) of another alphabet, 0 for
// its passes (R = 256); kFold the rolled fold's kind (scores.cuh FoldKind)
template <bool kSpaced, int kScore, bool kGen = false, int kNR = 0,
          int kFold = 0>
__global__ void __launch_bounds__(kThreads)
    minimizers_kernel(const int8_t* __restrict__ codes,
                      const int32_t* __restrict__ lengths, int64_t L, int k,
                      int W, int canon, int64_t E,
                      int64_t* __restrict__ keys, bool* __restrict__ emitted,
                      int span, bk::Spacing sp, double denom,
                      bk::ProbeTable tbl, bk::Fold fold, bk::Shannon sh,
                      int unwindowed) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(kSpaced ? span : k, W);
  uint64_t* s_val = (uint64_t*)smem;
  uint64_t* s_score = s_val + l.nsx;  // W > 1 only
  int8_t* s_code = (int8_t*)(smem + l.code_off);
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.y;
  const int64_t j0 = (int64_t)blockIdx.x * kTile;
  const bk::Spacing* ss = nullptr;  // the seed, staged by step 1
  if constexpr (kSpaced) {
    __shared__ bk::Spacing s_sp;
    bk::stage_spacing(sp, &s_sp, tid);
    ss = &s_sp;
  }

  // 1. stage the tile's codes (-1 past the row) in 16-B chunks from the
  //    aligned address at or below the tile's first code
  const int need = l.npos + (kSpaced ? span : k) - 1;
  const int8_t* src = codes + row * L + j0;
  const int64_t avail = min((int64_t)need, L - j0);
  const int shift = (int)((uintptr_t)src & 15);
  const int nchunk = (shift + need + 15) >> 4;
  for (int q = tid; q < nchunk; q += kThreads) {
    const int lo = q * 16 - shift;  // tile index of the chunk's first code
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

  // 2. the k-mers of this thread's run of positions [p0, p1): rolled, or
  //    gathered for a spaced seed
  const int rt = W > 1 ? (l.npos + kThreads - 1) / kThreads : kRun;
  const int p0 = tid * rt;
  const int p1 = min(p0 + rt, l.npos);
  const uint64_t mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const int top = 2 * k - 2;
  uint32_t bad = 0;  // W = 1: bit r, slot p0 + r emits nothing
  [[maybe_unused]] RollProbe rp;  // kHash, W > 1
  if constexpr (kSpaced) {
    // the spaced k-mer (or U64_MAX) of position p, and its score; a kGen
    // k-mer comes folded and masked, with its seed's code counts ``cc``
    // (kNR > 0)
    using Counts = bk::CodeCounts<(kNR > 0 ? kNR : 1)>;
    [[maybe_unused]] const bk::CountLayout cl = bk::count_layout(k, sh.R);
    [[maybe_unused]] const double* terms = sh.terms;
    if constexpr (kScore == kShannon && kGen && kNR > 0) {
      __shared__ double s_terms[33];  // k + 1 <= 33 terms
      for (int i = tid; i <= k; i += kThreads) s_terms[i] = sh.terms[i];
      __syncthreads();
      terms = s_terms;
    }
    auto push = [&](int p, uint64_t v, bool n_in, const Counts& cc) {
      const uint64_t ov = n_in ? ~0ull : kGen ? v : v & mask;
      s_val[sx(p)] = ov;
      if (W > 1) {
        if constexpr (kScore == kShannon && kGen && kNR > 0) {
          s_score[sx(p)] = n_in ? bk::kInt64MinU
                                : bk::shannon_quotient(ov, cc.h(cl, terms),
                                                       sh);
        } else if constexpr (kScore == kShannon && kGen) {
          const int8_t* cp = s_code + shift + p;
          s_score[sx(p)] =
              n_in ? bk::kInt64MinU
                   : bk::shannon_score(
                         ov, [&](int i) { return (int)cp[ss->pos[i]]; }, k,
                         sh);
        } else if constexpr (kScore == kShannon) {  // DNA: from ov alone
          s_score[sx(p)] =
              n_in ? bk::kInt64MinU : bk::shannon_dna_score(ov, k, sh);
        } else if constexpr (kScore == kHash) {
          rp.push(tbl, s_score, p, ov);
        } else {
          s_score[sx(p)] = kScore == kEntropy && n_in
                               ? bk::kInt64MinU
                               : score_of<kScore>(ov, denom);
        }
      } else {
        bad |= (uint32_t)(ov == ~0ull) << (p - p0);
      }
    };
    if (!kGen && span <= 32) {
      // roll a window of the span's bases (first base high) and its N
      // bits, and fold each position's runs out of it
      const uint32_t* w32 = (const uint32_t*)s_code;
      int ci = shift + p0;
      uint32_t word = p0 < p1 ? w32[ci >> 2] >> (8 * (ci & 3)) : 0u;
      uint64_t win = 0;
      uint32_t nwin = 0;
      for (int i = 0; i < p1 - p0 + span - 1; ++i, ++ci) {
        if (i > 0 && (ci & 3) == 0) word = w32[ci >> 2];
        const int c = (int8_t)(word & 0xFF);
        word >>= 8;
        win = (win << 2) | (uint64_t)(c & 3);
        nwin = (nwin << 1) | (uint32_t)(c < 0);
        const int r = i - (span - 1);
        if (r >= 0)
          push(p0 + r, bk::fold_runs(win, *ss), (nwin & ss->nbits_hi) != 0,
               Counts());
      }
    } else {
      for (int p = p0; p < p1; ++p) {  // gather each position's k codes
        const int8_t* cp = s_code + shift + p;
        uint64_t v = 0;
        bool n_in = false;
        Counts cc;  // counted once a seed
        for (int i = 0; i < k; ++i) {
          const int c = cp[ss->pos[i]];
          n_in |= c < 0;
          v = kGen ? bk::fold_step(fold, v, c) : (v << 2) | (uint64_t)(c & 3);
          if constexpr (kScore == kShannon && kGen && kNR > 0) cc.add(cl, c);
        }
        push(p, kGen ? bk::fold_finish(fold, v) : v, n_in, cc);
      }
    }
    if constexpr (kScore == kHash)
      if (W > 1) rp.finish(tbl, s_score, p1);
  } else if constexpr (kGen) {
    // W = 1, so p1 = p0 + kRun: the run's first k - 1 codes folded, then
    // each seed r takes code k - 1 + r in and, past the first, r - 1 out
    const uint32_t* w32 = (const uint32_t*)s_code;
    const int b = shift + p0;  // byte of the run's first code in s_code
    uint64_t v = 0;
    int last_n = -1;  // run index of the last ambiguous code read
    for (int i = 0; i < k - 1; ++i) {
      const int c = s_code[b + i];
      if (c < 0) last_n = i;
      v = bk::fold_roll<kFold>(fold, v, (uint64_t)max(c, 0), 0);
    }
    uint32_t in[kRun / 4], out[kRun / 4];
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      in[q] = codes4(w32, b + k - 1 + 4 * q);
      out[q] = codes4(w32, b + 4 * q);
    }
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int c = (int8_t)(in[r >> 2] >> (8 * (r & 3)));
      const int o =
          r ? (int8_t)(out[(r - 1) >> 2] >> (8 * ((r - 1) & 3))) : 0;
      if (c < 0) last_n = k - 1 + r;
      v = bk::fold_roll<kFold>(fold, v, (uint64_t)max(c, 0),
                               (uint64_t)max(o, 0));
      s_val[sx(p0 + r)] = bk::fold_finish<kFold>(fold, v);
      bad |= (uint32_t)(last_n >= r) << r;
    }
  } else if (p0 < p1) {
    const int64_t n_push0 = max((int64_t)lengths[row] - (k - 1), (int64_t)0);
    const uint32_t* w32 = (const uint32_t*)s_code;
    int ci = shift + p0;  // byte of the next code in s_code
    uint32_t word = w32[ci >> 2] >> (8 * (ci & 3));
    uint64_t fwd = 0, rc = 0;
    int last_n = -1;  // run index of the last N read
    for (int i = 0; i < p1 - p0 + k - 1; ++i, ++ci) {
      if (i > 0 && (ci & 3) == 0) word = w32[ci >> 2];
      int c = (int8_t)(word & 0xFF);
      word >>= 8;
      if (c < 0) {
        last_n = i;
        c = 0;
      }
      fwd = ((fwd << 2) | (uint64_t)c) & mask;
      rc = (rc >> 2) | ((uint64_t)(3 - c) << top);
      const int r = i - (k - 1);  // the position whose k-mer is complete
      if (r < 0) continue;
      const uint64_t v = canon && rc < fwd ? rc : fwd;
      const bool n_in = last_n >= r;
      if (W > 1) {
        const uint64_t ck = n_in ? 0 : v;
        s_val[sx(p0 + r)] = ck;
        if constexpr (kScore == kHash)
          rp.push(tbl, s_score, p0 + r, ck);
        else
          s_score[sx(p0 + r)] = score_of<kScore>(ck, denom);
      } else {
        // with ``unwindowed`` set, a contiguous seed writes 0 as the value
        // of a slot that emits nothing (the sequence-parallel encode)
        s_val[sx(p0 + r)] =
            unwindowed && (n_in || j0 + p0 + r >= n_push0) ? 0 : v;
        bad |= (uint32_t)n_in << r;
      }
    }
    if constexpr (kScore == kHash)
      if (W > 1) rp.finish(tbl, s_score, p1);
  }
  __syncthreads();

  // 3. W > 1: the window minima of this thread's slots (van Herk /
  //    Gil-Werman).  Cut the positions from j on into blocks of W: the
  //    window of slot j + r meets at most two blocks, so its minimum is
  //    the lesser of the suffix minimum from j + r to the end of its block
  //    and the prefix minimum from the start of the next block to
  //    j + r + W - 1.  Two scans of about W + kRun positions, the same
  //    steps in every lane.
  const int j = tid * kRun;
  if ((kSpaced || !kGen) && W > 1) {
    uint16_t suf[kRun];  // position of the suffix minimum from j + r
    {
      uint64_t bs = 0, bv = 0;
      int bp = 0;
      int q = W - 1;  // the next position's place in its block
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
    uint64_t best[kRun];
    {
      uint64_t bs = 0, bv = 0;
      int q = 0;  // place of the next position in its block
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
  }
  __syncthreads();

  // 4. out: keys coalesced, the emitted flags of a run in one store
  const int nslot = (int)min((int64_t)kTile, E - j0);
  int64_t* krow = keys + row * E + j0;
  if (((uintptr_t)krow & 15) == 0) {
    for (int m = tid; 2 * m < nslot; m += kThreads) {
      const int s0 = 2 * m;
      if (s0 + 1 < nslot)
        *(ulonglong2*)(krow + s0) =
            make_ulonglong2(s_val[sx(s0)], s_val[sx(s0 + 1)]);
      else
        krow[s0] = (int64_t)s_val[sx(s0)];
    }
  } else {
    for (int s0 = tid; s0 < nslot; s0 += kThreads)
      krow[s0] = (int64_t)s_val[sx(s0)];
  }
  const int64_t n_push =
      max((int64_t)lengths[row] - ((kSpaced ? span : k) - 1), (int64_t)0);
  bool* erow = emitted + row * E + j0 + j;
  uint32_t f[kRun / 4] = {0, 0, 0, 0};
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    const int64_t js = j0 + j + r;
    bool e = W > 1 ? js + W <= n_push : js < n_push && !(bad >> r & 1);
    if (kSpaced && W > 1) e = e && s_val[sx(j + r)] != ~0ull;
    f[r / 4] |= (uint32_t)e << (8 * (r % 4));
  }
  if (j + kRun <= nslot && ((uintptr_t)erow & 15) == 0) {
    *(uint4*)erow = make_uint4(f[0], f[1], f[2], f[3]);
  } else {
#pragma unroll
    for (int r = 0; r < kRun; ++r)
      if (j + r < nslot) erow[r] = (f[r / 4] >> (8 * (r % 4))) & 1;
  }
}

template <bool kSpaced, int kScore, bool kGen = false, int kNR = 0,
          int kFold = 0>
int launch(const void* codes, const void* lengths, int64_t B, int64_t L,
           int k, int W, int canon, int span, const bk::Spacing& sp,
           double denom, const bk::ProbeTable& tbl,
           void* keys, void* emitted, cudaStream_t stream,
           const bk::Fold& fold = bk::Fold{}, const bk::Shannon& sh = {},
           int unwindowed = 0) {
  const int64_t E = L - span - W + 2;
  const Layout l = layout(span, W);
  if (l.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        minimizers_kernel<kSpaced, kScore, kGen, kNR, kFold>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((E + kTile - 1) / kTile), (unsigned)B);
  minimizers_kernel<kSpaced, kScore, kGen, kNR, kFold>
      <<<grid, kThreads, l.bytes, stream>>>(
          (const int8_t*)codes, (const int32_t*)lengths, L, k, W, canon, E,
          (int64_t*)keys, (bool*)emitted, span, sp, denom, tbl, fold, sh,
          unwindowed);
  return (int)cudaGetLastError();
}

}  // namespace

// The one entry point.  codes (B, L) int8, lengths (B,) int32 -> keys
// (B, E) int64-held u64, emitted (B, E) bool, E = L - span - W + 2 > 0;
// 1 <= k <= 32; the tile's shared memory must fit (W <= 8192).  With
// ``spaced`` the seed is the k offsets ``positions`` (a host int32[32],
// positions[0] = 0, span = positions[k - 1] + 1), never canonical;
// otherwise it is contiguous (span = k), canonical with ``canon`` (DNA).
// ``fold`` 0 is DNA's 2-bit code, 1 shift-or by ``bits`` with the mask
// ``lim``, 2 multiply-add by ``radix`` with the modulus ``lim``: another
// alphabet, never canonical, whose spaced seeds take every score, whose
// contiguous seeds (the rolled fold,
// W = 1 only) pass 0..k-1 and ``unwindowed``, which that fold does not
// read; a contiguous DNA seed at W = 1 with
// ``unwindowed`` set writes 0 as the value of each slot that emits
// nothing (the sequence-parallel encode of bonsai_tpu_torch/parallel/
// sharded.py, as sharded_encode_contig, bonsai_tpu/parallel/
// sharded.py:1283-1285, writes it).  ``score`` 0 lex, 1 entropy-file
// (quotient by ``denom``), 2 hash (the phase-1 image, slots (nb, 4), lgnb,
// vbits, vals, n_vals, inline, as db/table.py ProbeArrays.args), 3 Shannon
// (spaced seeds; ``terms``: k + 1 doubles on the card, ``R`` codes in the
// alphabet, ``eps``).
extern "C" int bk_minimizers_gen(const void* codes, const void* lengths,
                                 int64_t B, int64_t L, int k, int W,
                                 int canon, int spaced,
                                 const int32_t* positions, int span,
                                 int unwindowed, int fold, int bits,
                                 uint64_t radix, uint64_t lim, int score,
                                 double denom, const void* slots, int lgnb,
                                 int vbits, const void* vals, int64_t n_vals,
                                 int is_inline, const void* terms, int R,
                                 double eps, void* keys, void* emitted,
                                 void* stream) {
  const bk::ProbeTable t{(const ulonglong2*)slots, (const uint64_t*)vals,
                         n_vals, lgnb, vbits, is_inline};
  const bk::Fold f{fold, bits, radix, lim, bk::fold_rpow(radix, k)};
  const bk::Shannon sh{(const double*)terms, R, eps};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool gen = fold != bk::kFoldDna;
  if (gen && canon) return (int)cudaErrorInvalidValue;
  const bk::Spacing sp =
      spaced ? bk::make_spacing(positions, k) : bk::Spacing{};
#define BK(kSpaced, kScore, kGen, ...)                                       \
  return launch<kSpaced, kScore, kGen, ##__VA_ARGS__>(                       \
      codes, lengths, B, L, k, W, kSpaced ? 0 : canon, kSpaced ? span : k,   \
      sp, denom, t, keys, emitted, s, f, sh, kSpaced ? 0 : unwindowed)
  if (gen && !spaced) {  // the rolled fold of a contiguous seed
    if (W != 1 || !unwindowed) return (int)cudaErrorInvalidValue;
    if (fold == bk::kFoldShift) BK(false, kLex, true, 0, bk::kFoldShift);
    BK(false, kLex, true, 0, bk::kFoldMulAdd);
  } else if (gen) {
    switch (score) {
      case kLex: BK(true, kLex, true);
      case kEntropy: BK(true, kEntropy, true);
      case kHash: BK(true, kHash, true);
      case kShannon:
        switch (bk::count_regs(k, R)) {
          case 1: BK(true, kShannon, true, 1);
          case 2: BK(true, kShannon, true, 2);
        }
        BK(true, kShannon, true);
    }
  } else if (spaced) {
    switch (score) {
      case kLex: BK(true, kLex, false);
      case kEntropy: BK(true, kEntropy, false);
      case kHash: BK(true, kHash, false);
      case kShannon: BK(true, kShannon, false);
    }
  } else {
    switch (score) {
      case kLex: BK(false, kLex, false);
      case kEntropy: BK(false, kEntropy, false);
      case kHash: BK(false, kHash, false);
    }
  }
#undef BK
  return (int)cudaErrorInvalidValue;
}

// The blocks of bk_minimizers_gen's hash instantiation (DNA, contiguous
// or ``spaced``; with ``gen``, another alphabet's spaced seed) for a seed
// of span ``span`` and a window of W that one SM holds at once, or minus
// a CUDA error.
extern "C" int bk_minimizers_hash_blocks_per_sm(int spaced, int span, int W,
                                                int gen) {
  const Layout l = layout(span, W);
  const void* f =
      gen      ? (const void*)minimizers_kernel<true, kHash, true>
      : spaced ? (const void*)minimizers_kernel<true, kHash, false>
               : (const void*)minimizers_kernel<false, kHash, false>;
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, f, kThreads,
                                                      l.bytes);
  return e == cudaSuccess ? n : -(int)e;
}
