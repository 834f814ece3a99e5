// Elementwise 64-bit mixes shared by KS4 (bitmix.cu) and KS1 (hll.cu), so
// that the HyperLogLog fill hashes its keys in registers instead of a
// second pass over device memory.  Everything sits in an anonymous
// namespace, so each source that includes this header owns its copy.

#pragma once

#include <cstdint>

namespace bk {
namespace {

// Thomas Wang's 64-bit mix (hash.h:32-41; bonsai_tpu/core/hashes.py:58),
// wrapping arithmetic on u64.
__device__ __forceinline__ uint64_t wang_hash(uint64_t x) {
  x = (~x) + (x << 21);
  x = x ^ (x >> 24);
  x = x * 265ull;
  x = x ^ (x >> 14);
  x = x * 21ull;
  x = x ^ (x >> 28);
  return x + (x << 31);
}

// klib khash's int64 hash truncated to u32 (khash64.h:425), in the low
// half of a u64.
__device__ __forceinline__ uint64_t khash_int64_hash(uint64_t x) {
  return ((x >> 33) ^ x ^ (x << 11)) & 0xFFFFFFFFull;
}

}  // namespace
}  // namespace bk
