// A spaced seed as the kernels take it: K1 (encode_probe.cu) and KB1
// (minimizers.cu).
//
// The seed's k offsets from its first base, pos[0] = 0 < pos[1] < ...,
// span = pos[k - 1] + 1, pass by value in a kernel's parameters and are
// copied into shared memory at the block's start (a loop over a by-value
// array indexed at run time would read it through local memory).  The
// offsets fall into runs of consecutive bases (0x16,1x4: one run of 17,
// then four of 1).  Where the span fits one 64-bit word of 2-bit codes,
// a position's k-mer is folded run by run from a window of its span bases
// held first base high: a shift, a mask and an or a run instead of a load
// a base; its N test is one and of the window's N bits with the seed's
// positions.  Everything sits in an anonymous namespace, so each source
// that includes this header owns its copy.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bk {
namespace {

constexpr int kMaxK = 32;

struct Spacing {
  int32_t pos[kMaxK];
  int32_t k, span, nrun;
  uint8_t run_shift[kMaxK];  // a run's place in a first-base-high window
  uint8_t run_bits[kMaxK];   // 2 x its length
  uint64_t nbits_lo;         // bit pos[j]: N bits with the first base low
  uint64_t nbits_hi;         // bit span - 1 - pos[j]: first base high
};

// positions: k strictly increasing offsets from 0 (a host array)
inline Spacing make_spacing(const int32_t* positions, int k) {
  Spacing s{};
  s.k = k;
  s.span = positions[k - 1] + 1;
  for (int j = 0; j < k; ++j) s.pos[j] = positions[j];
  if (s.span > 32) return s;  // the fast path's fields stay unused
  for (int j = 0; j < k; ++j) {
    s.nbits_lo |= 1ull << positions[j];
    s.nbits_hi |= 1ull << (s.span - 1 - positions[j]);
  }
  for (int j = 0; j < k;) {
    int len = 1;
    while (j + len < k && positions[j + len] == positions[j] + len) ++len;
    s.run_shift[s.nrun] = (uint8_t)(2 * (s.span - positions[j] - len));
    s.run_bits[s.nrun] = (uint8_t)(2 * len);
    ++s.nrun;
    j += len;
  }
  return s;
}

// Copy the by-value seed into shared memory, field by field at
// compile-time offsets; the caller synchronizes the block after.
__device__ __forceinline__ void stage_spacing(const Spacing& sp, Spacing* dst,
                                              int tid) {
#pragma unroll
  for (int i = 0; i < kMaxK; ++i)
    if (tid == i) {
      dst->pos[i] = sp.pos[i];
      dst->run_shift[i] = sp.run_shift[i];
      dst->run_bits[i] = sp.run_bits[i];
    }
  if (tid == kMaxK) {
    dst->k = sp.k;
    dst->span = sp.span;
    dst->nrun = sp.nrun;
    dst->nbits_lo = sp.nbits_lo;
    dst->nbits_hi = sp.nbits_hi;
  }
}

// The k-mer, first base high, of a window of the seed's span bases held
// first base high (base i of the span at bits 2 (span - 1 - i)); span <= 32.
__device__ __forceinline__ uint64_t fold_runs(uint64_t win, const Spacing& s) {
  uint64_t v = 0;
  for (int q = 0; q < s.nrun; ++q) {
    const int b = s.run_bits[q];
    const uint64_t m = b == 64 ? ~0ull : (1ull << b) - 1;
    v = (b == 64 ? 0 : v << b) | ((win >> s.run_shift[q]) & m);
  }
  return v;
}

}  // namespace
}  // namespace bk
