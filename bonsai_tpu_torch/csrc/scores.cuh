// Minimizer scores, and the fold of the other alphabets, shared by KB1
// (minimizers.cu) and KB4 (compacted_minimizers.cu).
//
// frev64 is the lex score (bonsai_tpu/core/hashes.py:39): xor, multiply
// mod 2^64, rotate left 31, xor.  entropy_file_score is the score of the
// scheme "entropy-file" that `build -e` runs
// (bonsai_tpu/core/entropy.py:91 with H = NOT_FULL = -1): the u64 k-mer
// rounded to the nearest double, one IEEE double divide by the host's
// double (-1.0 + 1e-4), and the x86-64 gcc conversion of the quotient to
// u64 (f64_to_u64_x86, entropy.py:34), written out: at or above 2^63 it
// subtracts 2^63 and sets bit 63 again, anything else outside
// [-2^63, 2^63) (NaN too) gives 0x8000000000000000, and in range it
// truncates toward zero.  The range is tested here, not left to the
// saturation of __double2ll_rz, whose out-of-range result differs.  The
// score is computed where the k-mer is, inside the kernels, so it never
// makes a round trip through device memory.
//
// shannon_score is the score of the scheme "entropy" (the Python API):
// u64(kmer / (H + eps)), H = sum_c p_c ln p_c over the codes of the seed,
// p_c = count / k (bonsai_tpu/core/entropy.py window_code_counts :47,
// spaced_code_counts :67, entropy_value :82).  A count is one of 0..k, so
// the terms come from a table of k + 1 doubles made on the host with
// numpy (core/entropy.py shannon_terms): the card computes no log.  The
// terms are added in numpy's pairwise order over the R codes of the
// alphabet (in order below 8; up to 128, eight accumulators by code mod 8
// combined as ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)), then the
// codes past the last multiple of 8 in order; R = 256 as two halves of
// 128).  An absent code's term is an exact 0.0, which changes no partial
// sum.  The counts: a DNA seed's from the k-mer (four popcounts,
// shannon_dna_score); an alphabet of at most ~40 codes counts its k codes
// once into packed fields (CodeCounts) and adds every code's term in a
// fixed tree; PROTEIN (R = 256) visits the codes present in ascending
// order, each found by a pass over the k codes (shannon_h).
//
// Fold: the k-mer of an alphabet other than DNA's 2 bits (core/encode.py
// _pack :108-137, apply_mask :163-170): shift-or by the power-of-two
// radix's bits and a bit mask, or multiply-add by the radix and the
// modulus radix**k, both modulo 2^64.  An ambiguous code (< 0) folds as 0.
// A contiguous seed rolls its fold one code a position (fold_roll): the
// mask kept at each step, or the outgoing code times radix^(k - 1)
// subtracted before the multiply-add, exact modulo 2^64, so fold_finish of
// the rolled value is the fold of the last k codes.
// Everything sits in an anonymous namespace, so each source that
// includes this header owns its copy.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bk {
namespace {

constexpr uint64_t kInt64MinU = 0x8000000000000000ull;

__device__ __forceinline__ uint64_t frev64(uint64_t x) {
  x = (x ^ 0x533F8C2151B20F97ull) * 0x9A98567ED20C127Dull;
  x = (x << 31) | (x >> 33);
  return x ^ 0x691A9D706391077Aull;
}

__device__ __forceinline__ uint64_t f64_to_u64_x86(double x) {
  const double two63 = 9223372036854775808.0;
  const bool big = x >= two63;
  const double xm = big ? x - two63 : x;
  const bool in_range = xm >= -two63 && xm < two63;
  const uint64_t u = in_range ? (uint64_t)__double2ll_rz(xm) : kInt64MinU;
  return big ? u ^ kInt64MinU : u;
}

__device__ __forceinline__ uint64_t entropy_file_score(uint64_t kmer,
                                                       double denom) {
  return f64_to_u64_x86(__ddiv_rn(__ull2double_rn(kmer), denom));
}

// the fold of an alphabet: kind 0 is DNA's (the kernels' own 2-bit code)
enum FoldKind { kFoldDna = 0, kFoldShift = 1, kFoldMulAdd = 2 };

struct Fold {
  int kind;
  int bits;       // kFoldShift
  uint64_t radix; // kFoldMulAdd
  uint64_t lim;   // the mask (kFoldShift) or the modulus (kFoldMulAdd)
  uint64_t rpow;  // radix^(k - 1) mod 2^64 (kFoldMulAdd, fold_roll)
};

// radix^(k - 1) mod 2^64, on the host
inline uint64_t fold_rpow(uint64_t radix, int k) {
  uint64_t r = 1;
  for (int i = 1; i < k; ++i) r *= radix;
  return r;
}

__device__ __forceinline__ uint64_t fold_step(const Fold& f, uint64_t v,
                                              int c) {
  const uint64_t u = (uint64_t)(c < 0 ? 0 : c);
  return f.kind == kFoldShift ? (v << f.bits) | u : v * f.radix + u;
}

// one step of a contiguous seed's rolled fold: code c comes in and, once
// k codes are in, code ``out`` (k places before c) goes; both >= 0 (an
// ambiguous code passed as 0), ``out`` 0 before the seed is full.  kKind
// is the fold's kind where the caller's instantiation knows it, else -1.
// A radix is below 2^32 (at most 256), so its multiply is 64 x 32 bits.
template <int kKind = -1>
__device__ __forceinline__ uint64_t fold_roll(const Fold& f, uint64_t v,
                                              uint64_t c, uint64_t out) {
  if ((kKind < 0 ? f.kind : kKind) == kFoldShift)
    return ((v << f.bits) | c) & f.lim;
  return (v - out * f.rpow) * (uint64_t)(uint32_t)f.radix + c;
}

template <int kKind = -1>
__device__ __forceinline__ uint64_t fold_finish(const Fold& f, uint64_t v) {
  if ((kKind < 0 ? f.kind : kKind) == kFoldShift) return v & f.lim;
  return v >= f.lim ? v % f.lim : v;
}

// The Shannon score's table and constants: terms[c] = p ln p of a count
// c = 0..k (in global or shared memory), R codes in the alphabet, eps
// added to H.
struct Shannon {
  const double* terms;
  int R;
  double eps;
};

__device__ __forceinline__ double sum8(const double* r) {
  return __dadd_rn(__dadd_rn(__dadd_rn(r[0], r[1]), __dadd_rn(r[2], r[3])),
                   __dadd_rn(__dadd_rn(r[4], r[5]), __dadd_rn(r[6], r[7])));
}

__device__ __forceinline__ void add_at(double* r, int j, double t) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i == j) r[i] = __dadd_rn(r[i], t);
}

// H of the k codes code(0..k-1), all >= 0: each pass finds the least code
// above the last one and its count (at most k + 1 passes of k codes); the
// form of PROTEIN's 256 codes, too many for CodeCounts
template <class Code>
__device__ __forceinline__ double shannon_h(Code code, int k,
                                            const Shannon& sh) {
  const int R = sh.R;
  const int m8 = R <= 128 ? R - R % 8 : 128;  // first code past the r's
  double a[8] = {0, 0, 0, 0, 0, 0, 0, 0}, b[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  double res = 0.0;
  bool tail = false;  // 8 <= R <= 128: res holds sum8(a) and the tail
  for (int prev = -1;;) {
    int m = 1 << 30, cnt = 0;
    for (int i = 0; i < k; ++i) {
      const int c = code(i);
      if (c > prev && c <= m) {
        cnt = c == m ? cnt + 1 : 1;
        m = c;
      }
    }
    if (cnt == 0) break;
    const double t = sh.terms[cnt];
    if (R < 8) {
      res = __dadd_rn(res, t);
    } else if (m < m8) {
      add_at(a, m & 7, t);
    } else if (R <= 128) {
      if (!tail) res = sum8(a), tail = true;
      res = __dadd_rn(res, t);
    } else {
      add_at(b, m & 7, t);
    }
    prev = m;
  }
  if (R < 8) return res;
  if (R <= 128) return tail ? res : sum8(a);
  return __dadd_rn(sum8(a), sum8(b));
}

// The counting form: a seed's code counts as packed fields of b =
// ceil(log2(k + 1)) bits, fpr = 64 / b fields a u64, code c in register
// c / fpr at bit (c % fpr) * b, kNR registers (count_regs): counting a
// code adds 1 at its field, one shared load of the code and no pass over
// the others.  H then takes every code's term, terms[count], in numpy's
// pairwise order over the R codes as a fixed tree: an absent code's term
// is +0.0, which changes no partial sum (a term is <= 0 and never -0.0),
// so this is shannon_h's sum, bit for bit, with no branch on the counts.
// Codes outside [0, R) are not counted, as core/entropy.py counts them.
struct CountLayout {
  int b, fpr, R;
  uint32_t inv_fpr;  // (x * inv_fpr) >> 16 is x / fpr for x < 256
  uint64_t fmask;    // one field's bits
};

__device__ __forceinline__ CountLayout count_layout(int k, int R) {
  CountLayout l;
  l.b = 32 - __clz(k);
  l.fpr = 64 / l.b;
  l.R = R;
  l.inv_fpr = (65536 + l.fpr - 1) / l.fpr;
  l.fmask = (1ull << l.b) - 1;
  return l;
}

// registers of the counting form for a seed of k codes of an alphabet of
// R, or 0 for shannon_h's passes (host side: the entry points pick the
// instantiation); one or two cover every alphabet of at most 32 codes at
// the largest k its fold takes
inline int count_regs(int k, int R) {
  int b = 0;
  while ((1 << b) <= k) ++b;
  const int regs = (R + 64 / b - 1) / (64 / b);
  return regs <= 1 ? 1 : regs <= 2 ? 2 : 0;
}

template <int kNR>
struct CodeCounts {
  uint64_t f[kNR];

  __device__ __forceinline__ CodeCounts() {
#pragma unroll
    for (int g = 0; g < kNR; ++g) f[g] = 0;
  }

  __device__ __forceinline__ int reg(const CountLayout& l, int c) const {
    return kNR == 1 ? 0 : (int)(((unsigned)c * l.inv_fpr) >> 16);
  }

  // one more of code c (nothing outside [0, R))
  __device__ __forceinline__ void add(const CountLayout& l, int c) {
    if ((unsigned)c >= (unsigned)l.R) return;
    const int g = reg(l, c);
    const uint64_t one = 1ull << ((c - g * l.fpr) * l.b);
#pragma unroll
    for (int i = 0; i < kNR; ++i)
      if (i == g) f[i] += one;
  }

  __device__ __forceinline__ int count(const CountLayout& l, int c) const {
    const int g = reg(l, c);
    uint64_t x = f[0];
#pragma unroll
    for (int i = 1; i < kNR; ++i)
      if (i == g) x = f[i];
    return (int)((x >> ((c - g * l.fpr) * l.b)) & l.fmask);
  }

  // H with the k + 1 terms ``terms`` (shared memory or global)
  __device__ __forceinline__ double h(const CountLayout& l,
                                      const double* terms) const {
    const int R = l.R;
    if (R < 8) {
      double res = 0.0;
      for (int c = 0; c < R; ++c) res = __dadd_rn(res, terms[count(l, c)]);
      return res;
    }
    const int m8 = R - R % 8;  // R <= 64 here
    double r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = terms[count(l, j)];
    for (int c0 = 8; c0 < m8; c0 += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        r[j] = __dadd_rn(r[j], terms[count(l, c0 + j)]);
    }
    double res = sum8(r);
    for (int c = m8; c < R; ++c) res = __dadd_rn(res, terms[count(l, c)]);
    return res;
  }
};

// u64(kmer / (H + eps)), x86 conversion
__device__ __forceinline__ uint64_t shannon_quotient(uint64_t kmer, double h,
                                                     const Shannon& sh) {
  return f64_to_u64_x86(
      __ddiv_rn(__ull2double_rn(kmer), __dadd_rn(h, sh.eps)));
}

template <class Code>
__device__ __forceinline__ uint64_t shannon_score(uint64_t kmer, Code code,
                                                  int k, const Shannon& sh) {
  return shannon_quotient(kmer, shannon_h(code, k, sh), sh);
}

// The Shannon score of a DNA seed (R = 4) from its packed k-mer alone:
// its k 2-bit groups are its codes, so four popcounts of the k-mer's bit
// planes count them (as KS4's nuccount, bitmix.cu), and the terms of the
// codes present are added in ascending code order, as shannon_h adds
// them for R < 8: the same bits, with no pass over the codes.  ``kmer``
// holds k groups (bits past 2k are 0) and is the seed's own, uncanonical
// k-mer: complement swaps the counts of A and T, C and G, and with them
// the order of the additions.
__device__ __forceinline__ uint64_t shannon_dna_score(uint64_t kmer, int k,
                                                      const Shannon& sh) {
  const uint64_t lo = kmer & 0x5555555555555555ull;
  const uint64_t hi = (kmer >> 1) & 0x5555555555555555ull;
  const int c1 = __popcll(lo & ~hi), c2 = __popcll(hi & ~lo);
  const int c3 = __popcll(lo & hi);
  const int c0 = k - c1 - c2 - c3;
  double h = 0.0;
  if (c0) h = __dadd_rn(h, sh.terms[c0]);
  if (c1) h = __dadd_rn(h, sh.terms[c1]);
  if (c2) h = __dadd_rn(h, sh.terms[c2]);
  if (c3) h = __dadd_rn(h, sh.terms[c3]);
  return shannon_quotient(kmer, h, sh);
}

// min(kmer, reverse complement) of a 2-bit DNA k-mer (bitops.canonical,
// bonsai_tpu/core/bitops.py:52): the complement, the 2-bit groups
// reversed, the k groups shifted down
__device__ __forceinline__ uint64_t canonical(uint64_t x, int k) {
  uint64_t r = __brevll(~x);
  r = ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
  r = k == 32 ? r : r >> (64 - 2 * k);
  return r < x ? r : x;
}

}  // namespace
}  // namespace bk
