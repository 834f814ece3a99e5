// Binary-lifting LCA over compact taxonomy indices, shared by K2
// (resolve.cu) and KB3 (merge_fold.cu).
//
// The device counterpart of TaxTree._lca_compact and of the JAX
// package's lca_device (bonsai_tpu/classify/resolve.py:25) and
// _lca_compact_dev (bonsai_tpu/db/build_device.py:61), with their
// 0-identity rules: lca(x, 0) = lca(0, x) = x and lca(0, 0) = 0.  lift is
// (levels, n) int32, row j holding each node's 2^j-th ancestor.

#pragma once

#include <cstdint>

namespace bk {

__device__ __forceinline__ int32_t lca_compact(
    int32_t a0, int32_t b0, const int32_t* __restrict__ depth,
    const int32_t* __restrict__ parent, const int32_t* __restrict__ lift,
    int levels, int32_t n) {
  int32_t a = a0, b = b0;
  int32_t da = depth[a], db = depth[b];
  for (int j = levels - 1; j >= 0; --j) {
    const int32_t step = 1 << j;
    if (da - db >= step) { a = lift[(int64_t)j * n + a]; da -= step; }
    if (db - da >= step) { b = lift[(int64_t)j * n + b]; db -= step; }
  }
  const bool neq = a != b;
  for (int j = levels - 1; j >= 0; --j) {
    const int32_t pa = lift[(int64_t)j * n + a];
    const int32_t pb = lift[(int64_t)j * n + b];
    if (neq && pa != pb) { a = pa; b = pb; }
  }
  int32_t res = neq ? parent[a] : a;
  if (a0 == 0) res = b0;
  if (b0 == 0) res = a0 == 0 ? 0 : a0;
  return res;
}

}  // namespace bk
