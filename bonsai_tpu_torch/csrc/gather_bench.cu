// G1 row_gather and G2 take_along: the two microbenchmarks of the probe's
// row gather that the JAX package wrote as Pallas kernels for the TPU.
//
// G1 replaces tools/probe_microbench.py probeF -> gather_kernel2 (:225,
// body :190): out[i] = tbl[idx[i]] for rows of C u32 lanes (128 B in
// variant F), which F computed through a ring of 16 in-flight DMA copies
// per grid step.  On an H100 the bound is device memory: one random row
// read and one sequential row write per index, latency-bound until enough
// rows are in flight.  The design: one thread per 16-B vector of a row,
// so a warp reads 512 contiguous bytes of 4 rows (128-B rows) and
// thousands of warps keep the loads in flight that F's DMA ring kept; row
// offsets are 64-bit.  (A cp.async / TMA ring into shared memory is the
// Hopper analog of F's ring, left for later.)
//
// G2 replaces tools/vmem_gather_bench2.py pcall (:35) with its cases
// build_same_shape_ax0 / _ax1 / build_diff_rows / build_big_same
// (:44,61,78,95): take_along_axis of a u32 table, kept in VMEM on the
// TPU, on axis 0 (out[i, j] = tab[idx[i, j], j]) or axis 1 (out[i, j] =
// tab[i, idx[i, j]]).  The 512 KiB and 4 MiB tables sit in the 50 MB L2
// and each table element is read about once, so staging in shared memory
// buys no reuse; what bounds the kernel is the launch and one wave of
// loads.  The design fills the card: a block of 32 x 4 threads covers 4
// output rows, a thread 4 consecutive columns of one row, whose 4 indices
// it loads as one 16-B vector and whose 4 values it stores as one; the
// grid is 2-D (row blocks, column groups), so no thread divides.  On axis
// 1 one warp covers one output row of 128 columns, and the 512-B table
// row it reads sits in L1 after the first touch.
//
// Both kernels stop with __trap() on an index outside the table, as
// torch.gather's device-side assert does: the launch fails and the CUDA
// context is lost, and the next synchronising call reports it.
//
// bk_empty_launch replaces no TPU kernel: it is a yardstick, the floor of
// a launch by graph replay, an empty kernel of some blocks of 256
// threads, or a cooperative one whose blocks meet at one grid barrier (the
// fixed cost of KD1's frame and collect, csrc/route.cu).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kColThreads = 32;  // G2: threads along a row, 4 columns each
constexpr int kRowsPerBlock = 4;  // G2: output rows per block

__global__ void row_gather_kernel(const uint4* __restrict__ tbl,
                                  const int32_t* __restrict__ idx, int64_t R,
                                  int64_t Q, int vpr, uint4* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Q * vpr) return;
  const int64_t i = t / vpr;
  const int v = (int)(t - i * vpr);
  const int32_t r = idx[i];
  if (r < 0 || r >= R) __trap();
  out[t] = tbl[(int64_t)r * vpr + v];
}

// VEC: Ci % 4 == 0 and idx, out 16-byte aligned
template <int AXIS, bool VEC>
__global__ void __launch_bounds__(kColThreads * kRowsPerBlock)
    take_kernel(const uint32_t* __restrict__ tab,
                const int32_t* __restrict__ idx, int64_t R, int64_t Ct,
                int64_t Q, int64_t Ci, uint32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  const int64_t j = ((int64_t)blockIdx.y * kColThreads + threadIdx.x) * 4;
  if (i >= Q || j >= Ci) return;
  const int64_t lim = AXIS == 0 ? R : Ct;
  const int32_t* ix = idx + i * Ci + j;
  int32_t x[4];
  if (VEC) {
    const int4 v = *(const int4*)ix;
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = j + e < Ci ? ix[e] : 0;
  }
  uint32_t y[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!VEC && j + e >= Ci) break;
    if (x[e] < 0 || x[e] >= lim) __trap();
    y[e] = AXIS == 0 ? tab[(int64_t)x[e] * Ct + j + e] : tab[i * Ct + x[e]];
  }
  uint32_t* o = out + i * Ci + j;
  if (VEC) {
    *(uint4*)o = make_uint4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j + e < Ci) o[e] = y[e];
  }
}

template <int AXIS>
void take(bool vec, dim3 grid, cudaStream_t s, const uint32_t* tab,
          const int32_t* idx, int64_t R, int64_t Ct, int64_t Q, int64_t Ci,
          uint32_t* out) {
  const dim3 block(kColThreads, kRowsPerBlock);
  if (vec)
    take_kernel<AXIS, true><<<grid, block, 0, s>>>(tab, idx, R, Ct, Q, Ci, out);
  else
    take_kernel<AXIS, false><<<grid, block, 0, s>>>(tab, idx, R, Ct, Q, Ci, out);
}

__global__ void empty_kernel() {}

__global__ void barrier_kernel() { cooperative_groups::this_grid().sync(); }

}  // namespace

// tbl (R, C) u32 with C % 4 == 0, idx (Q,) int32 in [0, R) -> out (Q, C)
extern "C" int bk_row_gather(const void* tbl, const void* idx, int64_t R,
                             int64_t Q, int64_t C, void* out, void* stream) {
  const int vpr = (int)(C / 4);
  const int64_t n = Q * vpr;
  if (n > 0)
    row_gather_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                        (cudaStream_t)stream>>>(
        (const uint4*)tbl, (const int32_t*)idx, R, Q, vpr, (uint4*)out);
  return (int)cudaGetLastError();
}

// tab (R, Ct) u32, idx (Q, Ci) int32 -> out (Q, Ci); axis 0 needs
// Ci == Ct and indices in [0, R), axis 1 needs Q == R and indices in
// [0, Ct).
extern "C" int bk_take_along(const void* tab, const void* idx, int64_t R,
                             int64_t Ct, int64_t Q, int64_t Ci, int axis,
                             void* out, void* stream) {
  if (Q == 0 || Ci == 0) return (int)cudaGetLastError();
  const int64_t col_blocks = (Ci + 4 * kColThreads - 1) / (4 * kColThreads);
  const int64_t row_blocks = (Q + kRowsPerBlock - 1) / kRowsPerBlock;
  if (col_blocks > 65535 || row_blocks > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)row_blocks, (unsigned)col_blocks);
  const bool vec = Ci % 4 == 0 && (uintptr_t)idx % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* t = (const uint32_t*)tab;
  const int32_t* ix = (const int32_t*)idx;
  uint32_t* o = (uint32_t*)out;
  if (axis == 0)
    take<0>(vec, grid, s, t, ix, R, Ct, Q, Ci, o);
  else
    take<1>(vec, grid, s, t, ix, R, Ct, Q, Ci, o);
  return (int)cudaGetLastError();
}

// An empty launch of ``blocks`` blocks of 256 threads, or with ``coop`` a
// cooperative one (at most the blocks resident together) whose blocks
// meet at one grid barrier.
extern "C" int bk_empty_launch(int64_t blocks, int coop, void* stream) {
  if (blocks < 1 || blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!coop) {
    empty_kernel<<<(unsigned)blocks, 256, 0, s>>>();
    return (int)cudaGetLastError();
  }
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)barrier_kernel, dim3((unsigned)blocks), dim3(256), nullptr,
      0, s);
  cudaGetLastError();  // a refused launch leaves no error for the next
  return (int)e;
}
