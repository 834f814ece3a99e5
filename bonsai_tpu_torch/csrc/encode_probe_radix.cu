// K1 radix: another input type's int8 codes -> k-mers -> quotient-cuckoo
// probe.
//
// The entries bk_encode_probe_radix, bk_encode_probe_radix_range and
// bk_encode_only_radix, each contiguous or spaced, take the reads of an
// input type other than DNA: the JAX step on int8 codes
// (bonsai_tpu/classify/pipeline.py:404-463, _make_step), whose encode is
// BatchEncoder.emissions at W = 1 with the other alphabets' fold
// (core/encode.py _pack :108-137, apply_mask :163-170), then
// probe_slots_device (db/table.py:370) and the hit / cidx / oidx glue; the
// bucket-range entry is the psum route's probe_local
// (parallel/sharded.py:466-501), the encode-only entry the a2a route's
// encode (:405-407).  The reads arrive as a row of int8 codes a read,
// ``ld`` bytes apart (ld >= P + c - 1, c the seed's span), -1 for an
// ambiguous code or padding.  Position p of read b folds the k codes at
// b * ld + p + pos[j] (pos[j] = j when contiguous) by the alphabet's fold
// (scores.cuh: shift-or under the mask, or multiply-add and the modulus,
// an ambiguous code folding as 0).  It is valid iff p < len - (c - 1), no
// code of its seed is ambiguous, and, for a spaced seed only, its k-mer
// is not U64_MAX (the classifier's spaced seed is the encoder's windowed
// spaced branch at W = 1, core/encoder.py:189-204; PROTEIN_3BIT's k = 22
// contiguous fold of 66 bits keeps a real U64_MAX).  The probe: h =
// splitmix64(kmer), b1 = h & (nb - 1), q = h >> lgnb, b2 = b1 ^
// (splitmix64(q ^ BSALT) & (nb - 1)), the first bucket whose 32-B row
// holds [occupied | choice | q] outside the value field decides, and
// within it the value index (inline, u32) or the flat slot position
// (64-bit) is summed over the matching lanes, then clamped to the value
// array; in the range mode a bucket outside the rank's rows [row0, row0 +
// rows) is skipped and the flat position is the local one.  hit, valid,
// cidx = the value's low 32 bits, oidx = its high 32 or, with want_idx,
// the u32 index; never canonical.
//
// What bounds it on an H100: at a classify batch (8192 reads of 33
// residues, P = 34: 278,528 positions, ~208,000 slot rows) not the bytes
// (0.0029 ms) but the chain of dependent steps a thread waits on -- its
// codes, the fold, the hash, row 1, then row 2 for a lane that missed,
// then the value -- over about one wave of threads, and a launch floor
// of ~0.0012 ms (PERF.md row 1).  The design: a thread owns a run of
// kRun consecutive flat positions of the (B, P) output, 2 for a
// contiguous seed (its run shares one rolled fold; runs of 1 left the
// batch's threads past one wave, runs of 4 and 8 too few warps to hide
// the rows' latency) and 1 for a spaced seed (each position gathers
// afresh, so a longer run only takes threads away).  A contiguous seed
// folds its run's first position from its k codes, read 4 a word, then
// rolls across the run, one code in and one out a position (scores.cuh
// fold_roll, an ambiguous code in or out as 0), and folds afresh where
// the run enters the next read; the byte of the last ambiguous code read
// marks the positions that hold one.  A spaced seed gathers its k codes
// at its offsets.  The codes are read where they are: staging a block's
// codes in shared memory first (16-B loads of its one byte range, behind
// a barrier) was no faster at that batch, whose codes sit in L2.  The
// fold's kind is a template parameter.  Then the run's probes go out
// together: every valid lane's first row is loaded before any compare,
// then the second rows of the lanes that missed (or whose first bucket
// lies outside the rank's rows), together, then the values of the lanes
// found (KB1's ProbeBatch order, probe.cuh, with want_idx's index and the
// range mode).  A run's outputs go out as one store an array (hit and
// valid kRun bytes, cidx and oidx 4 kRun bytes, kmers 8 kRun bytes),
// aligned because a run starts at a multiple of kRun and the outputs are
// 16-B aligned (the entries check).  Measured and not kept
// (tools/kernel_ab.py --classify, K1R_EDITS): the staging, both rows
// loaded at once, the rows read by lane pairs, other run lengths and
// block sizes, the rows read past L1.  The lengths come as int32 or, with
// ``len16``, as u16 widened through uint16_t.

#include <cstdint>
#include <cuda_runtime.h>
#include <initializer_list>

#include "scores.cuh"
#include "spacing.cuh"

namespace {

constexpr int kThreads = 128;
// positions a thread: a contiguous seed's run shares its rolled fold; a
// spaced seed gathers each position's codes afresh, so its runs are one
// position, twice the threads
constexpr int kRunContiguous = 2;
constexpr int kRunSpaced = 1;
template <bool kSpaced>
constexpr int kRun = kSpaced ? kRunSpaced : kRunContiguous;
constexpr uint64_t kBSalt = 0xA24BAED4963EE407ULL;

template <int R>
constexpr bool kRunOk = R == 1 || R == 2 || R == 4 || R == 8;
static_assert(kRunOk<kRunContiguous> && kRunOk<kRunSpaced>,
              "a run's stores take 1, 2, 4 or 8 positions");

enum Mode { kProbe = 0, kRange = 1, kEncode = 2 };

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

struct Args {
  const int8_t* codes;
  int64_t ld, total;  // row stride, and B * ld bytes in all
  const void* lengths;
  int len16;
  int64_t n, P;  // n = B * P positions
  int k, c;      // c: the seed's span
  const ulonglong2* slots;
  int lgnb, vbits;
  const uint64_t* vals;
  int64_t n_vals;
  int is_inline, want_idx;
  int64_t row0, rows;
  bool* hit;
  bool* valid;
  int32_t* cidx;
  uint32_t* oidx;
  int64_t* kmers;
  bk::Fold fold;
};

// read b's length: u16 where len16, else int32
__device__ __forceinline__ int64_t read_length(const Args& a, int64_t b) {
  if (a.len16) return (int64_t)(uint32_t)__ldg((const uint16_t*)a.lengths + b);
  return (int64_t)__ldg((const int32_t*)a.lengths + b);
}

// x / d and x % d, in 32 bits where both fit
__device__ __forceinline__ void divmod(int64_t x, int64_t d, int64_t* q,
                                       int64_t* r) {
  if ((uint64_t)x <= 0xFFFFFFFFull && (uint64_t)d <= 0xFFFFFFFFull) {
    const uint32_t qq = (uint32_t)x / (uint32_t)d;
    *q = qq;
    *r = (int64_t)((uint32_t)x - qq * (uint32_t)d);
  } else {
    *q = x / d;
    *r = x - *q * d;
  }
}

// one step of a spaced seed's fold: code c (an ambiguous one as 0) comes in
template <int kFold>
__device__ __forceinline__ uint64_t fold_step(const bk::Fold& f, uint64_t v,
                                              int c) {
  const uint64_t u = (uint64_t)(c < 0 ? 0 : c);
  return kFold == bk::kFoldShift ? (v << f.bits) | u : v * f.radix + u;
}

// the R bytes of bits ``m`` (bit r -> byte r) at p, one store
template <int R>
__device__ __forceinline__ void store_flags(bool* p, uint32_t m) {
  if constexpr (R == 1) {
    *(uint8_t*)p = (uint8_t)(m & 1);
  } else {
    // bit r of m -> bit 8 r: spread each nibble over four bytes
    const uint32_t lo = ((m & 0xF) * 0x00204081u) & 0x01010101u;
    if constexpr (R == 2) {
      *(uint16_t*)p = (uint16_t)lo;
    } else if constexpr (R == 4) {
      *(uint32_t*)p = lo;
    } else {
      const uint32_t hi = (((m >> 4) & 0xF) * 0x00204081u) & 0x01010101u;
      *(uint2*)p = make_uint2(lo, hi);
    }
  }
}

// R 32-bit words at p, in 16-B stores (or one of 4 or 8 B)
template <int R>
__device__ __forceinline__ void store_words(uint32_t* p,
                                            const uint32_t (&w)[R]) {
  if constexpr (R == 1) {
    p[0] = w[0];
  } else if constexpr (R == 2) {
    *(uint2*)p = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int q = 0; q < R; q += 4)
      *(uint4*)(p + q) = make_uint4(w[q], w[q + 1], w[q + 2], w[q + 3]);
  }
}

// R 64-bit words at p, in 16-B stores (or one of 8 B)
template <int R>
__device__ __forceinline__ void store_dwords(int64_t* p,
                                             const uint64_t (&w)[R]) {
  if constexpr (R == 1) {
    p[0] = (int64_t)w[0];
  } else {
#pragma unroll
    for (int q = 0; q < R; q += 2)
      *(ulonglong2*)(p + q) = make_ulonglong2(w[q], w[q + 1]);
  }
}

// The codes tensor, ``total`` bytes: byte(g) is the code at byte g, word(g)
// the 4 codes from g (the first in the low byte, -1 past the tensor).
struct Codes {
  const int8_t* codes;
  int64_t total;
  __device__ __forceinline__ int byte(int64_t g) const {
    return __ldg(codes + g);
  }
  __device__ __forceinline__ uint32_t word(int64_t g) const {
    uint32_t w = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      w |= (uint32_t)(uint8_t)(g + u < total ? __ldg(codes + g + u) : -1)
           << (8 * u);
    return w;
  }
};

// A contiguous seed's fold of the k codes from byte g, 4 codes a word (an
// ambiguous one as 0); ``last_n`` becomes the byte of the last ambiguous
// code, or stays.
template <int kFold>
__device__ __forceinline__ uint64_t fold_fresh(const Args& a, const Codes& cs,
                                               int64_t g, int64_t& last_n) {
  uint64_t v = 0;
  for (int j = 0; j < a.k; j += 4) {
    uint32_t w = cs.word(g + j);
    const int left = a.k - j;
    const uint32_t amb =
        w & 0x80808080u & (left >= 4 ? ~0u : (1u << (8 * left)) - 1);
    if (amb) last_n = g + j + ((31 - __clz(amb)) >> 3);
    w &= ~((amb >> 7) * 0xFFu);  // an ambiguous code folds as 0
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < left)
        v = bk::fold_roll<kFold>(a.fold, v, (w >> (8 * u)) & 0xFFu, 0);
  }
  return v;
}

// Whether the slot row (lo, hi) holds ``e`` outside the value field; each
// matching lane adds its value index (inline) or its flat position
// bk * 4 + lane to ``acc``.
__device__ __forceinline__ bool match_row(const Args& a, ulonglong2 lo,
                                          ulonglong2 hi, uint64_t e,
                                          uint64_t bk, uint64_t& acc) {
  const uint64_t vmask = (1ULL << a.vbits) - 1;
  const uint64_t row[4] = {lo.x, lo.y, hi.x, hi.y};
  bool found = false;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    if ((row[l] & ~vmask) == e) {
      found = true;
      acc += a.is_inline ? (row[l] & vmask) : bk * 4 + l;
    }
  }
  return found;
}

// The run of positions i .. i + kRun - 1 (those below n) of one thread,
// from (b, p), its first, whose read's positions p < end are inside it.
template <int kMode, bool kSpaced, int kFold>
__device__ __forceinline__ void run(const Args& a, const bk::Spacing* ss,
                                    int64_t i, int64_t b, int64_t p,
                                    int64_t end, const Codes& cs) {
  constexpr int kR = kRun<kSpaced>;
  const int m = a.n - i < kR ? (int)(a.n - i) : kR;  // positions owned
  uint64_t km[kR];
  uint32_t ok = 0;     // bit r: position i + r valid
  int64_t g = b * a.ld + p;  // byte of the position's first code
  uint64_t v = 0;      // the rolled fold (contiguous)
  int64_t last_n = -1; // byte of the last ambiguous code read (contiguous)
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    km[r] = 0;
    if (r < m) {
      // the run's first position (its read's end given), or a new read
      const bool fresh = r == 0 || p == 0;
      if (r > 0 && fresh) end = read_length(a, b) - (a.c - 1);
      bool in = p < end;
      if constexpr (kSpaced) {
        uint64_t f = 0;
        bool amb = false;
        for (int j = 0; j < a.k; ++j) {
          const int cj = cs.byte(g + ss->pos[j]);
          amb |= cj < 0;
          f = fold_step<kFold>(a.fold, f, cj);
        }
        km[r] = bk::fold_finish<kFold>(a.fold, f);
        in = in && !amb && km[r] != ~0ULL;
      } else {
        if (fresh) {
          last_n = -1;
          v = fold_fresh<kFold>(a, cs, g, last_n);
        } else {
          const int ci = cs.byte(g + a.k - 1), co = cs.byte(g - 1);
          if (ci < 0) last_n = g + a.k - 1;
          v = bk::fold_roll<kFold>(a.fold, v, (uint64_t)max(ci, 0),
                                   (uint64_t)max(co, 0));
        }
        km[r] = bk::fold_finish<kFold>(a.fold, v);
        in = in && last_n < g;
      }
      ok |= (uint32_t)in << r;
    }
    if (++p == a.P) {
      p = 0;
      g = ++b * a.ld;
    } else {
      ++g;
    }
  }

  if constexpr (kMode == kEncode) {
    uint64_t out[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) out[r] = (ok >> r & 1) ? km[r] : 0;
    if (m == kR) {
      store_dwords<kR>(a.kmers + i, out);
      store_flags<kR>(a.valid + i, ok);
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r < m) {
          a.kmers[i + r] = (int64_t)out[r];
          a.valid[i + r] = ok >> r & 1;
        }
      }
    }
    return;
  }

  // the run's probes together: every first row, then the second rows of
  // the lanes that missed, then the values of the lanes found
  const uint64_t bmask = (1ULL << a.lgnb) - 1;
  const uint64_t base = kMode == kRange ? (uint64_t)a.row0 : 0;
  uint64_t h[kR], bk[kR], acc[kR];
  ulonglong2 lo[kR], hi[kR];
  uint32_t loaded = 0, found = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    h[r] = splitmix64(km[r]);
    bk[r] = (h[r] & bmask) - base;  // the local row in the range mode
    acc[r] = 0;
    if ((ok >> r & 1) && (kMode != kRange || bk[r] < (uint64_t)a.rows)) {
      lo[r] = a.slots[2 * bk[r]];
      hi[r] = a.slots[2 * bk[r] + 1];
      loaded |= 1u << r;
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if ((loaded >> r & 1) &&
        match_row(a, lo[r], hi[r],
                  (1ULL << 63) | ((h[r] >> a.lgnb) << a.vbits), bk[r],
                  acc[r]))
      found |= 1u << r;
  loaded = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if ((ok & ~found) >> r & 1) {
      const uint64_t b1 = h[r] & bmask;
      bk[r] = (b1 ^ (splitmix64((h[r] >> a.lgnb) ^ kBSalt) & bmask)) - base;
      if (kMode != kRange || bk[r] < (uint64_t)a.rows) {
        lo[r] = a.slots[2 * bk[r]];
        hi[r] = a.slots[2 * bk[r] + 1];
        loaded |= 1u << r;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if ((loaded >> r & 1) &&
        match_row(a, lo[r], hi[r],
                  (3ULL << 62) | ((h[r] >> a.lgnb) << a.vbits), bk[r],
                  acc[r]))
      found |= 1u << r;
  uint64_t val[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    val[r] = 0;
    if (found >> r & 1) {
      int64_t idx = a.is_inline ? (int64_t)(uint32_t)acc[r] : (int64_t)acc[r];
      if (idx > a.n_vals - 1) idx = a.n_vals - 1;
      val[r] = a.vals[idx];
    }
  }
  uint32_t c32[kR], o32[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const bool f = found >> r & 1;
    c32[r] = f ? (uint32_t)val[r] : 0u;
    o32[r] = f ? (a.want_idx ? (uint32_t)acc[r] : (uint32_t)(val[r] >> 32))
               : 0u;
  }
  if (m == kR) {
    store_flags<kR>(a.hit + i, found);
    store_flags<kR>(a.valid + i, ok);
    store_words<kR>((uint32_t*)a.cidx + i, c32);
    store_words<kR>(a.oidx + i, o32);
  } else {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r < m) {
        a.hit[i + r] = found >> r & 1;
        a.valid[i + r] = ok >> r & 1;
        a.cidx[i + r] = (int32_t)c32[r];
        a.oidx[i + r] = o32[r];
      }
    }
  }
}

template <int kMode, bool kSpaced, int kFold>
__global__ void __launch_bounds__(kThreads)
    radix_kernel(Args a, bk::Spacing sp) {
  const bk::Spacing* ss = nullptr;
  if constexpr (kSpaced) {
    __shared__ bk::Spacing s_sp;
    bk::stage_spacing(sp, &s_sp, threadIdx.x);
    __syncthreads();
    ss = &s_sp;
  }
  const int64_t i =
      ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kRun<kSpaced>;
  if (i >= a.n) return;
  int64_t b, p;
  divmod(i, a.P, &b, &p);
  run<kMode, kSpaced, kFold>(a, ss, i, b, p, read_length(a, b) - (a.c - 1),
                             Codes{a.codes, a.total});
}

template <int kMode, bool kSpaced, int kFold>
int launch(const Args& a, const bk::Spacing& sp, void* stream) {
  constexpr int kTile = kThreads * kRun<kSpaced>;
  const int64_t blocks = (a.n + kTile - 1) / kTile;
  radix_kernel<kMode, kSpaced, kFold>
      <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a, sp);
  return (int)cudaGetLastError();
}

// The kernel of one mode, seed and fold kind (scores.cuh FoldKind: 1
// shift-or, 2 multiply-add), as a function pointer.
template <int kMode>
const void* kernel_of(int spaced, int fold) {
  if (fold == bk::kFoldShift)
    return spaced ? (const void*)radix_kernel<kMode, true, bk::kFoldShift>
                  : (const void*)radix_kernel<kMode, false, bk::kFoldShift>;
  return spaced ? (const void*)radix_kernel<kMode, true, bk::kFoldMulAdd>
                : (const void*)radix_kernel<kMode, false, bk::kFoldMulAdd>;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The instantiations of one mode, contiguous or spaced; the fold (kind 1
// shift-or by ``bits`` under the mask ``lim``, kind 2 multiply-add by
// ``radix`` modulo ``lim``), or an error.
template <int kMode>
int launch_radix(const void* codes, int64_t ld, const void* lengths,
                 int len16, int64_t B, int64_t P, int k, int spaced,
                 const int32_t* positions, int fold, int bits,
                 uint64_t radix, uint64_t lim, const void* slots, int lgnb,
                 int vbits, const void* vals, int64_t n_vals, int is_inline,
                 int want_idx, int64_t row0, int64_t rows, void* hit,
                 void* valid, void* cidx, void* oidx, void* kmers,
                 void* stream) {
  if (fold != bk::kFoldShift && fold != bk::kFoldMulAdd)
    return (int)cudaErrorInvalidValue;
  if (k < 1 || k > bk::kMaxK || B < 0 || P < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t c = spaced ? positions[k - 1] + 1 : k;
  if (ld < P + c - 1) return (int)cudaErrorInvalidValue;
  for (const void* out : {hit, valid, cidx, oidx, kmers})
    if (out != nullptr && !aligned16(out)) return (int)cudaErrorInvalidValue;
  Args a{(const int8_t*)codes, ld, B * ld, lengths, len16, B * P, P, k,
         (int)c, (const ulonglong2*)slots, lgnb, vbits,
         (const uint64_t*)vals, n_vals, is_inline, want_idx, row0, rows,
         (bool*)hit, (bool*)valid, (int32_t*)cidx, (uint32_t*)oidx,
         (int64_t*)kmers,
         bk::Fold{fold, bits, radix, lim, bk::fold_rpow(radix, k)}};
  if (a.n == 0) return 0;
  const bk::Spacing sp =
      spaced ? bk::make_spacing(positions, k) : bk::Spacing{};
  if (fold == bk::kFoldShift)
    return spaced ? launch<kMode, true, bk::kFoldShift>(a, sp, stream)
                  : launch<kMode, false, bk::kFoldShift>(a, sp, stream);
  return spaced ? launch<kMode, true, bk::kFoldMulAdd>(a, sp, stream)
                : launch<kMode, false, bk::kFoldMulAdd>(a, sp, stream);
}

}  // namespace

// Another input type's reads: ``codes`` (B, ld) int8, -1 ambiguous or
// padding, P <= ld - c + 1 positions a read; the fold (kind 1 shift-or by
// ``bits`` under the mask ``lim``, kind 2 multiply-add by ``radix`` modulo
// ``lim``); contiguous, or with ``spaced`` the k offsets ``positions`` (a
// host array); never canonical.  The outputs hit, valid (B, P) bool and
// cidx, oidx (B, P) int32 start on 16-B boundaries.  Otherwise as
// bk_encode_probe (encode_probe.cu).
extern "C" int bk_encode_probe_radix(
    const void* codes, int64_t ld, const void* lengths, int len16, int64_t B,
    int64_t P, int k, int spaced, const int32_t* positions, int fold,
    int bits, uint64_t radix, uint64_t lim, const void* slots, int lgnb,
    int vbits, const void* vals, int64_t n_vals, int is_inline, int want_idx,
    void* hit, void* valid, void* cidx, void* oidx, void* stream) {
  return launch_radix<kProbe>(codes, ld, lengths, len16, B, P, k, spaced,
                              positions, fold, bits, radix, lim, slots, lgnb,
                              vbits, vals, n_vals, is_inline, want_idx, 0, 0,
                              hit, valid, cidx, oidx, nullptr, stream);
}

// The psum route's probe of rows [row0, row0 + rows) of the global table
// (as bk_encode_probe_range, encode_probe.cu) on another input type's
// codes (as bk_encode_probe_radix).
extern "C" int bk_encode_probe_radix_range(
    const void* codes, int64_t ld, const void* lengths, int len16, int64_t B,
    int64_t P, int k, int spaced, const int32_t* positions, int fold,
    int bits, uint64_t radix, uint64_t lim, const void* slots, int lgnb,
    int vbits, const void* vals, int64_t n_vals, int is_inline, int want_idx,
    int64_t row0, int64_t rows, void* hit, void* valid, void* cidx,
    void* oidx, void* stream) {
  if (row0 < 0 || rows < 1) return (int)cudaErrorInvalidValue;
  return launch_radix<kRange>(codes, ld, lengths, len16, B, P, k, spaced,
                              positions, fold, bits, radix, lim, slots, lgnb,
                              vbits, vals, n_vals, is_inline, want_idx, row0,
                              rows, hit, valid, cidx, oidx, nullptr, stream);
}

// The a2a route's encode (as bk_encode_only, encode_probe.cu) of another
// input type's codes (as bk_encode_probe_radix): kmers (B, P) int64, 0
// where not valid, and valid (B, P) bool, both on 16-B boundaries.
extern "C" int bk_encode_only_radix(
    const void* codes, int64_t ld, const void* lengths, int len16, int64_t B,
    int64_t P, int k, int spaced, const int32_t* positions, int fold,
    int bits, uint64_t radix, uint64_t lim, void* kmers, void* valid,
    void* stream) {
  return launch_radix<kEncode>(codes, ld, lengths, len16, B, P, k, spaced,
                               positions, fold, bits, radix, lim, nullptr, 0,
                               0, nullptr, 0, 0, 0, 0, 0, nullptr, valid,
                               nullptr, nullptr, kmers, stream);
}

// The build of one instantiation (mode 0 whole table, 1 bucket range, 2
// encode only; ``spaced``; ``fold`` 1 shift-or, 2 multiply-add): out[0]
// its registers a thread, out[1] its local (spilled) bytes a thread,
// out[2] its static shared bytes, out[3] its resident blocks a SM; out[4]
// its positions a thread, out[5] its threads a block.
extern "C" int bk_encode_probe_radix_attrs(int mode, int spaced, int fold,
                                           int* out) {
  if (mode < 0 || mode > 2 ||
      (fold != bk::kFoldShift && fold != bk::kFoldMulAdd))
    return (int)cudaErrorInvalidValue;
  const void* fn = mode == kProbe   ? kernel_of<kProbe>(spaced, fold)
                   : mode == kRange ? kernel_of<kRange>(spaced, fold)
                                    : kernel_of<kEncode>(spaced, fold);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = blocks;
  out[4] = spaced ? kRunSpaced : kRunContiguous;
  out[5] = kThreads;
  return 0;
}
