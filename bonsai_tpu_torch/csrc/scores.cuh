// Minimizer scores shared by KB1 (minimizers.cu) and KB4
// (compacted_minimizers.cu).
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
// makes a round trip through device memory.  Everything sits in an
// anonymous namespace, so each source that includes this header owns its
// copy.

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

}  // namespace
}  // namespace bk
