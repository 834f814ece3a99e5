// K3 step_outputs: per read, the compact run-length output and the full
// positional matrix that the host decodes into Kraken text.
//
// Replaces bonsai_tpu/classify/pipeline.py build_step_outputs (:124-260),
// with the layout of dict_layout (:113), which the wrapper passes in:
//   full    [taxon | miss | kmers | kmers1 | hit-bitmask words | taxa]
//   compact W <  2^15, dict:  [taxon | head (2 or 3 words) |
//                              run values vb-bit packed | run lengths lb-bit]
//           W <  2^15, plain: [taxon | miss|kmers<<16 | kmers1|n_runs<<16 |
//                              run values | run lengths 16-bit packed]
//           W >= 2^15:        [taxon | miss | kmers | kmers1 | n_runs |
//                              run values | run lengths]
// A run is a maximal stretch of hits with one value, where the stretch
// skips non-hit positions (append_taxa_runs, classifier.h:45-61); only the
// first maxr runs are stored, n_runs counts them all.
//
// What bounds it on an H100: it reads each read's (hit, valid, taxa) row
// once (6 bytes a position) and writes the full matrix (4 bytes a
// position), so it is bound by device-memory bytes, about 2 us for a
// batch of 8192 short reads (a plain elementwise kernel over the same
// bytes takes 0.002 ms under graph replay).  The design: one warp per
// read, several reads a block, the lanes over the row in chunks of 32
// positions.  A chunk's hit-bitmask word is the ballot of its hits; miss
// and kmers are per-lane counts summed once by __reduce_add_sync.  A hit
// starts a run when its value differs from the previous hit's: that value
// comes by shuffle from the highest hit lane below, or from the last hit
// of the chunks before (carried in registers).  A run's id is the
// popcount of the run-start ballot below the lane plus the runs before
// the chunk; a run start records its value and its hit rank in the warp's
// shared memory, and a run's length is the difference of the hit ranks of
// its start and the next one.  Then lane i takes run i, shifts its value
// and length into place, and the lanes of each packed word add theirs by
// shuffles.  Every load and store of the rows is coalesced across the
// warp.  It takes ~0.006 ms there (CUDA-graph replay, H100 80GB HBM3 at
// 700 W), three times its bytes' time: each warp runs a serial chain of
// loads, ballots and shuffles over its read, 8192 warps in about two
// waves.  Packing at widths fixed at compile time took it from ~0.0072 to
// ~0.0057 ms; loading four chunks ahead and a 32-register cap did not
// move it.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;  // reads a block
constexpr int kShared = 48 * 1024;
constexpr unsigned kAll = 0xFFFFFFFFu;

// the layout codes the wrapper passes (see classify/pipeline.py); the
// third, 1, is the plain layout: W < 2^15 with u32 run values
constexpr int kWide = 0;  // W >= 2^15: one word per field
constexpr int kDict = 2;  // W < 2^15, dictionary run indices

// ``count`` values of kBits bits, 32 / kBits to a word, little end
// first, as sums of u32 words (as the plain version takes them): lane i
// shifts value i0 + i into place and the lanes of each word add theirs
// with a butterfly of shuffles.  Returns the number of words.
template <int kBits, typename At>
__device__ __forceinline__ int pack_bits(uint32_t* out, At at, int count,
                                         int lane) {
  constexpr int kPer = 32 / kBits;
  for (int i0 = 0; i0 < count; i0 += 32) {
    const int i = i0 + lane;
    uint32_t x = i < count ? at(i) << ((i % kPer) * kBits) : 0u;
#pragma unroll
    for (int o = 1; o < kPer; o <<= 1) x += __shfl_xor_sync(kAll, x, o);
    if (i < count && i % kPer == 0) out[i / kPer] = x;
  }
  return (count + kPer - 1) / kPer;
}

// pack_bits at a width of 4, 8, 16 or 32 bits, chosen once per call
template <typename At>
__device__ __forceinline__ int pack_bits(uint32_t* out, At at, int count,
                                         int bits, int lane) {
  switch (bits) {
    case 4: return pack_bits<4>(out, at, count, lane);
    case 8: return pack_bits<8>(out, at, count, lane);
    case 16: return pack_bits<16>(out, at, count, lane);
    default: return pack_bits<32>(out, at, count, lane);
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32) step_outputs_kernel(
    const uint32_t* __restrict__ taxon, const uint32_t* __restrict__ taxa,
    const bool* __restrict__ hit, const bool* __restrict__ valid,
    const uint32_t* __restrict__ valid1, int64_t R, int64_t W, int maxr,
    int layout, int vb, int lb, int head_words, uint32_t* __restrict__ compact,
    int64_t cols, uint32_t* __restrict__ full) {
  extern __shared__ uint32_t s_warps[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= R) return;
  // this warp's run starts: values [maxr], hit ranks [maxr + 1]
  uint32_t* s_vals = s_warps + (size_t)warp * (2 * maxr + 1);
  uint32_t* s_rank = s_vals + maxr;
  const uint32_t* trow = taxa + r * W;
  const bool* hrow = hit + r * W;
  const bool* vrow = valid + r * W;
  const int hb = (int)((W + 31) / 32);
  uint32_t* frow = full + r * (4 + hb + W);
  const int Wi = (int)W;  // the entry point takes W < 2^31
  const uint32_t below = (1u << lane) - 1u;
  const uint32_t tx = taxon[r];
  const uint32_t v1 = valid1[r];

  uint32_t my_valid = 0, my_miss = 0;  // this lane's positions
  uint32_t n_runs = 0, n_hits = 0;     // the warp's, so far
  uint32_t last = 0;  // the value of the last hit of the chunks before
  bool any = false;   // whether those chunks held a hit
  for (int p0 = 0; p0 < Wi; p0 += 32) {
    const int p = p0 + lane;
    const bool in = p < Wi;
    const bool h = in && hrow[p];
    const bool v = in && vrow[p];
    const uint32_t t = in ? trow[p] : 0u;
    if (in) frow[4 + hb + p] = t;
    my_valid += v;
    my_miss += v && !h;
    const uint32_t hw = __ballot_sync(kAll, h);
    // the previous hit: the highest hit lane below, else the carry
    const uint32_t hits_below = hw & below;
    const uint32_t from = __shfl_sync(
        kAll, t, hits_below ? 31 - __clz(hits_below) : lane);
    const bool has_prev = hits_below != 0 || any;
    const uint32_t prev = hits_below ? from : last;
    const bool starts = h && (!has_prev || t != prev);
    const uint32_t sw = __ballot_sync(kAll, starts);
    if (starts) {
      const uint32_t id = n_runs + __popc(sw & below);
      if (id < (uint32_t)maxr) s_vals[id] = t;
      if (id <= (uint32_t)maxr) s_rank[id] = n_hits + __popc(hits_below);
    }
    if (lane == 0) frow[4 + (p0 >> 5)] = hw;
    if (hw) {
      last = __shfl_sync(kAll, t, 31 - __clz(hw));
      any = true;
    }
    n_runs += __popc(sw);
    n_hits += __popc(hw);
  }
  const uint32_t n_valid = __reduce_add_sync(kAll, my_valid);
  const uint32_t n_miss = __reduce_add_sync(kAll, my_miss);
  __syncwarp();

  if (lane < 4)
    frow[lane] = lane == 0 ? tx : lane == 1 ? n_miss : lane == 2 ? n_valid : v1;
  // run i's value and length; 0 past the stored runs
  const uint32_t stored = n_runs < (uint32_t)maxr ? n_runs : (uint32_t)maxr;
  auto val_at = [&](int i) -> uint32_t {
    return (uint32_t)i < stored ? s_vals[i] : 0u;
  };
  auto len_at = [&](int i) -> uint32_t {
    if ((uint32_t)i >= stored) return 0u;
    const uint32_t end = (uint32_t)i + 1 < n_runs ? s_rank[i + 1] : n_hits;
    return end - s_rank[i];
  };

  uint32_t* crow = compact + r * cols;
  int off;
  if (layout == kWide) {
    if (lane < 5)
      crow[lane] = lane == 0 ? tx : lane == 1 ? n_miss : lane == 2 ? n_valid
                 : lane == 3 ? v1 : n_runs;
    off = 5;
  } else if (layout == kDict && head_words == 2) {
    if (lane == 0) crow[0] = tx;
    if (lane == 1)
      crow[1] = n_miss | (n_valid << 8) | (v1 << 16) | (n_runs << 24);
    off = 2;
  } else {
    if (lane < 3)
      crow[lane] = lane == 0 ? tx
                 : lane == 1 ? (n_miss & 0xFFFFu) | (n_valid << 16)
                             : (v1 & 0xFFFFu) | (n_runs << 16);
    off = 3;
  }
  // run values: u32 (wide, plain) or vb-bit (dict); lengths: u32 (wide),
  // 16-bit (plain) or lb-bit (dict)
  off += pack_bits(crow + off, val_at, maxr, layout == kDict ? vb : 32, lane);
  pack_bits(crow + off, len_at, maxr,
            layout == kWide ? 32 : (layout == kDict ? lb : 16), lane);
}

}  // namespace

extern "C" int bk_step_outputs(const void* taxon, const void* taxa,
                               const void* hit, const void* valid,
                               const void* valid1, int64_t R, int64_t W,
                               int maxr, int layout, int vb, int lb,
                               int head_words, void* compact, int64_t cols,
                               void* full, void* stream) {
  if (W >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  // as many reads a block as the warps' run starts leave room for
  const size_t per_warp = sizeof(uint32_t) * (2 * (size_t)maxr + 1);
  int warps = (int)(kShared / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const int64_t blocks = (R + warps - 1) / warps;
  step_outputs_kernel<<<(unsigned)blocks, warps * 32, warps * per_warp,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)taxon, (const uint32_t*)taxa, (const bool*)hit,
      (const bool*)valid, (const uint32_t*)valid1, R, W, maxr, layout, vb,
      lb, head_words, (uint32_t*)compact, cols, (uint32_t*)full);
  return (int)cudaGetLastError();
}
