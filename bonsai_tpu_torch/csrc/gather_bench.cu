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
// tab[i, idx[i, j]]).  A 512 KiB or 4 MiB table does not fit one SM's
// 227 KB of shared memory, so:
//   axis 1: output row i needs only row i of tab, which the block stages
//           in shared memory (C u32);
//   axis 0: output column j needs only column j of tab; a block that owns
//           32 columns stages that strip (R x 32 u32, 128 KB at R = 1024)
//           when it fits in 128 KB, and otherwise (R = 8192: 1 MB) reads
//           the table through L2, which holds all of it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 32;                   // axis-0 columns per block
constexpr int kRowsPerBlock = 256;           // axis-0 staged rows per block
constexpr int64_t kStageBytes = 128 * 1024;  // axis-0 staging limit

__global__ void row_gather_kernel(const uint4* __restrict__ tbl,
                                  const int32_t* __restrict__ idx, int64_t Q,
                                  int vpr, uint4* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= Q * vpr) return;
  const int64_t i = t / vpr;
  const int v = (int)(t - i * vpr);
  out[t] = tbl[(int64_t)idx[i] * vpr + v];
}

__global__ void take_ax1(const uint32_t* __restrict__ tab,
                         const int32_t* __restrict__ idx, int64_t Ct,
                         int64_t Ci, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t row[];
  const int64_t i = blockIdx.x;
  for (int64_t c = threadIdx.x; c < Ct; c += blockDim.x)
    row[c] = tab[i * Ct + c];
  __syncthreads();
  for (int64_t c = threadIdx.x; c < Ci; c += blockDim.x)
    out[i * Ci + c] = row[idx[i * Ci + c]];
}

// block (strip, row chunk); 256 threads = 8 rows x 32 columns at a time
__global__ void take_ax0_staged(const uint32_t* __restrict__ tab,
                                const int32_t* __restrict__ idx, int64_t R,
                                int64_t C, int64_t Q,
                                uint32_t* __restrict__ out) {
  extern __shared__ uint32_t strip[];  // R x kStrip
  const int64_t j0 = (int64_t)blockIdx.x * kStrip;
  const int jj = threadIdx.x % kStrip;
  const int r0 = threadIdx.x / kStrip;
  const int rstep = blockDim.x / kStrip;
  const bool col_ok = j0 + jj < C;
  for (int64_t r = r0; r < R; r += rstep)
    strip[r * kStrip + jj] = col_ok ? tab[r * C + j0 + jj] : 0u;
  __syncthreads();
  if (!col_ok) return;
  const int64_t i_end = min((int64_t)(blockIdx.y + 1) * kRowsPerBlock, Q);
  for (int64_t i = (int64_t)blockIdx.y * kRowsPerBlock + r0; i < i_end;
       i += rstep)
    out[i * C + j0 + jj] = strip[(int64_t)idx[i * C + j0 + jj] * kStrip + jj];
}

__global__ void take_ax0_l2(const uint32_t* __restrict__ tab,
                            const int32_t* __restrict__ idx, int64_t C,
                            int64_t n, uint32_t* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) out[t] = tab[(int64_t)idx[t] * C + t % C];
}

}  // namespace

// tbl (R, C) u32 with C % 4 == 0, idx (Q,) int32 -> out (Q, C)
extern "C" int bk_row_gather(const void* tbl, const void* idx, int64_t Q,
                             int64_t C, void* out, void* stream) {
  const int vpr = (int)(C / 4);
  const int64_t n = Q * vpr;
  if (n > 0)
    row_gather_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                        (cudaStream_t)stream>>>(
        (const uint4*)tbl, (const int32_t*)idx, Q, vpr, (uint4*)out);
  return (int)cudaGetLastError();
}

// tab (R, Ct) u32, idx (Q, Ci) int32 -> out (Q, Ci); axis 0 needs
// Ci == Ct, axis 1 needs Q == R.
extern "C" int bk_take_along(const void* tab, const void* idx, int64_t R,
                             int64_t Ct, int64_t Q, int64_t Ci, int axis,
                             void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* t = (const uint32_t*)tab;
  const int32_t* ix = (const int32_t*)idx;
  uint32_t* o = (uint32_t*)out;
  if (Q == 0 || Ci == 0) return (int)cudaGetLastError();
  if (axis == 1) {
    const size_t smem = (size_t)Ct * 4;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          take_ax1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    take_ax1<<<(unsigned)Q, 256, smem, s>>>(t, ix, Ct, Ci, o);
  } else if (R * kStrip * 4 <= kStageBytes) {
    const size_t smem = (size_t)R * kStrip * 4;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          take_ax0_staged, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((unsigned)((Ct + kStrip - 1) / kStrip),
                    (unsigned)((Q + kRowsPerBlock - 1) / kRowsPerBlock));
    take_ax0_staged<<<grid, 256, smem, s>>>(t, ix, R, Ct, Q, o);
  } else {
    const int64_t n = Q * Ci;
    take_ax0_l2<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(t, ix, Ct, n, o);
  }
  return (int)cudaGetLastError();
}
