// K1 encode_probe: 2-bit reads -> canonical k-mers -> quotient-cuckoo probe.
//
// Replaces the XLA-lowered front half of the JAX classify step
// (bonsai_tpu/classify/pipeline.py): unpack_2bit (:85) and the lproc slice
// (:496); BatchEncoder.emissions on its unwindowed branch
// (core/encoder.py:141-153 -> encode.py _pack_contig_fast :66,
// apply_mask :163, position_validity :141, bitops.canonical :36-57);
// probe_slots_device (db/table.py:370-410) with splitmix64
// (core/hashes.py:84) and KmerTable._split (:101); and the hit / cidx /
// oidx glue of _make_step (pipeline.py:441-463).
//
// What bounds it on an H100: the slot rows, one 32-byte row per valid
// (read, position) whose k-mer sits in its first bucket and two per miss,
// read at random from a slot array of 128 MiB to 1 GiB.  Random 32-byte
// rows come from such tables at about 22-25 G rows/s on an H100 80GB HBM3
// (G1's cliff in chip_smoke.py); a batch of 8192 HiSeq reads on the ec
// table reads ~1.0M rows in ~0.033 ms, ~30 G rows/s, where its bytes
// alone would take 0.0117.  The encode is a few dozen integer ops a
// position.  The design:
// one thread per (read, position), as many threads in flight as the card
// holds; a k-mer is built in O(1): a funnel-shifted 64-bit window of the
// read's packed words holds its bases first-base-low, so the reverse
// complement is that window complemented and masked, and the forward
// k-mer is the window with its 2-bit groups reversed (__brevll and a swap
// of the bits of each pair) shifted down; the N test is one funnel-shifted
// window of the N mask.  The second bucket's row is read only when the
// first has no match: reading both at once (one round trip instead of
// two) gained at most 5% where most probes miss, since the rows' rate
// and not their latency bounds the kernel, and it was a third slower at
// the scale probe's shape, where half the probes hit.  Several positions
// a thread did not help, and streaming (evict-first) row loads lost 5%
// at the scale probe's shape.  A slot row is two 16-byte vector loads
// (sm_90 has no 32-byte load); the slot index is 64-bit, so tables with
// nb * 4 >= 2^31 slots index correctly.
//
// A spaced seed (classify against a database built with -S; the
// encoder's spaced branch, core/encoder.py:189-204, at W = 1 with
// pack_spaced_kmers, encode.py:59) is the template's other instantiation:
// position p's k-mer folds, high-first, the 2-bit fields at
// p + positions[i], i < k, and its N bits come from the N mask; it is
// uncanonical, and it is valid iff p < len - c + 1 (c = positions[k - 1]
// + 1), it holds no N, and the k-mer is not U64_MAX.  Where c <= 32 the
// fields come run by run out of the same funnel-shifted window the
// contiguous k-mer uses, its groups reversed (spacing.cuh); past that, one
// field at a time from the packed words (a word is loaded again only when
// the next field lies in another).  The probe is the same.  The offsets
// pass by value in the kernel's parameters and are staged in shared
// memory; the contiguous instantiation reads none of them, so it is the
// kernel it was before the template.
//
// The sparse instantiation (entry bk_encode_probe_sparse, contiguous or
// spaced) takes the JAX step's sparse-N channel (pipeline.py:508-520):
// no N mask, but a list of the batch's in-read Ns as flat positions
// row * lproc + col, sorted ascending and padded with 0x7FFFFFFF, which
// the JAX step scatters as -1 into the unpacked codes (an entry past the
// batch dropped).  Here the codes never exist: a block turns its first
// and last (read, position) into flat bounds [lo, hi) (hi = the last
// window's end), finds the entries inside by a search of the whole block
// (a round a thread samples one entry: 1-2 rounds for a list of a few
// hundred), and stages them in shared memory (past kStage of them the
// block reads them where they are).  Usually there are none, and a
// thread tests nothing.  Else a thread searches the staged entries for
// the first at or past its window's start f; the position is invalid if
// one lies in [f, f + c) and, for a spaced seed, on one of its offsets
// (an N on a gap does not count).  The list strides by lproc, the
// threads by P = lproc - c + 1; an N past a read's length is never
// listed, and validity there comes from the lengths as before.  The
// list's entries are below B * lproc <= 0x7FFFFFFF (the wrapper checks),
// so the sentinel lies past every block's bounds.

// The lengths come as int32 or, where a batch's longest read fits in 16
// bits, as u16 (the JAX step's u16 lengths, pipeline.py:496-501,667-668):
// every entry point takes ``len16`` beside the pointer, one argument of
// the launch, so a thread's one load of its read's length takes the width
// the batch shipped, widened through uint16_t, never a signed 16-bit
// value (a length of 32,768-65,535 stays positive).

// Two more instantiations serve the sharded classifier
// (bonsai_tpu_torch/parallel/sharded.py):
//   encode-only (entry bk_encode_only): the a2a route's encode
//          (sharded.py:405-407: unpack_2bit + BatchEncoder.emissions at
//          W = 1), no table: kmers = the k-mer where the position is
//          valid and 0 elsewhere, and valid; the rank's queries then go
//          to KD1 (route.cu);
//   bucket-range (entry bk_encode_probe_range): the psum route's
//          probe_local (sharded.py:466-501): the rank holds rows
//          [row0, row0 + rows) of the one global table, a bucket outside
//          them misses, and the flat value position is the local one
//          (local bucket * 4 + lane).

// The reads of another input type (int8 codes) take K1's radix kernel,
// encode_probe_radix.cu, which shares nothing of this file's template.

#include <cstdint>
#include <cuda_runtime.h>

#include "spacing.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStage = 256;  // sparse-N entries a block stages
constexpr uint64_t kBSalt = 0xA24BAED4963EE407ULL;

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// the 2-bit groups of x in reverse order: group j -> group 31 - j
__device__ __forceinline__ uint64_t reverse_groups(uint64_t x) {
  x = __brevll(x);  // reverses the groups, and the two bits inside each
  return ((x >> 1) & 0x5555555555555555ULL) |
         ((x & 0x5555555555555555ULL) << 1);
}

// bits [s, s + 64) of the little-endian 96-bit value (w2, w1, w0), s < 32
__device__ __forceinline__ uint64_t window96(uint32_t w0, uint32_t w1,
                                             uint32_t w2, int s) {
  const uint64_t lo = ((uint64_t)w1 << 32) | w0;
  // ((w2 << 32) << (32 - s)) is w2 << (64 - s), and 0 at s = 0
  return (lo >> s) | (((uint64_t)w2 << 32) << (32 - s));
}

enum Mode { kProbe = 0, kRange = 1, kEncode = 2, kSparse = 3 };

// read b's length: u16 where len16, else int32
__device__ __forceinline__ int64_t read_length(const void* lengths,
                                               int len16, int64_t b) {
  if (len16) return (int64_t)(uint32_t)__ldg((const uint16_t*)lengths + b);
  return (int64_t)__ldg((const int32_t*)lengths + b);
}

// The first index of the sorted a[lo, hi) whose entry is >= key (hi if
// none), the whole block together: a round, thread t samples entry
// lo + t * step, and the count below key narrows the range kThreads-fold.
// Every thread of the block calls it with the same arguments.
__device__ __forceinline__ int64_t block_lower_bound(const uint32_t* a,
                                                     int64_t lo, int64_t hi,
                                                     uint64_t key) {
  while (lo < hi) {
    const int64_t step = (hi - lo + kThreads - 1) / kThreads;
    const int64_t j = lo + (int64_t)threadIdx.x * step;
    const int below = __syncthreads_count(j < hi && __ldg(a + j) < key);
    if (below == 0) return lo;
    const int64_t top = lo + (int64_t)below * step;
    lo = top - step + 1;
    hi = top < hi ? top : hi;
  }
  return lo;
}

// Whether a listed N falls in the window [f, f + c) of a position, on one
// of the seed's offsets for a spaced seed (ss non-null); list[0, m) sorted.
__device__ __forceinline__ bool listed_n(const uint32_t* list, int m,
                                         uint64_t f, int c,
                                         const bk::Spacing* ss) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] < f) lo = mid + 1; else hi = mid;
  }
  for (int j = lo; j < m && list[j] < f + c; ++j) {
    if (ss == nullptr) return true;
    const int d = (int)(list[j] - f);
    if (ss->span <= 32) {
      if ((ss->nbits_lo >> d) & 1) return true;
    } else {
      for (int t = 0; t < ss->k; ++t)
        if (ss->pos[t] == d) return true;
    }
  }
  return false;
}

template <bool kSpaced, int kMode>
__global__ void __launch_bounds__(kThreads) encode_probe_kernel(
    const uint32_t* __restrict__ pcodes, int64_t w16,
    const uint32_t* __restrict__ nmask, int64_t nmw,
    const void* __restrict__ lengths, int len16, int64_t n, int64_t P,
    int k, int canon, const ulonglong2* __restrict__ slots, int lgnb, int vbits,
    const uint64_t* __restrict__ vals, int64_t n_vals, int is_inline,
    int want_idx, bool* __restrict__ hit, bool* __restrict__ valid,
    int32_t* __restrict__ cidx, uint32_t* __restrict__ oidx,
    bk::Spacing sp, int64_t row0, int64_t rows,
    int64_t* __restrict__ kmers_out, const uint32_t* __restrict__ nidx,
    int64_t n_nidx) {
  const bk::Spacing* ss = nullptr;
  if constexpr (kSpaced) {
    __shared__ bk::Spacing s_sp;
    bk::stage_spacing(sp, &s_sp, threadIdx.x);
    __syncthreads();
    ss = &s_sp;
  }
  // the sparse list's entries inside the block's flat bounds
  const uint32_t* list = nullptr;
  int n_list = 0;
  if constexpr (kMode == kSparse) {
    __shared__ uint32_t s_list[kStage];
    const int c = kSpaced ? sp.span : k;
    const int64_t lproc = P + c - 1;
    const int64_t i0 = (int64_t)blockIdx.x * kThreads;
    const int64_t i1 = (i0 + kThreads < n ? i0 + kThreads : n) - 1;
    const int64_t b0 = i0 / P, b1 = i1 / P;
    const uint64_t lo = (uint64_t)(b0 * lproc + (i0 - b0 * P));
    const uint64_t hi = (uint64_t)(b1 * lproc + (i1 - b1 * P) + c);
    const int64_t s0 = block_lower_bound(nidx, 0, n_nidx, lo);
    const int64_t m = block_lower_bound(nidx, s0, n_nidx, hi) - s0;
    if (m > 0 && m <= kStage) {
      for (int j = threadIdx.x; j < m; j += kThreads)
        s_list[j] = __ldg(nidx + s0 + j);
      __syncthreads();
      list = s_list;
    } else if (m > kStage) {
      list = nidx + s0;
    }
    n_list = (int)m;
  }
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t b = i / P;
  const int64_t p = i - b * P;
  const uint32_t* pw = pcodes + b * w16;
  uint64_t kmer = 0;
  bool v;
  if constexpr (kSpaced) {
    // the k 2-bit fields at p + pos[j] (all below lproc <= 16 * w16) and
    // their N bits
    const int span = ss->span;
    bool bad = false;
    if (span <= 32) {
      const int64_t c = p >> 4;
      const uint32_t w0 = __ldg(pw + c);
      const uint32_t w1 = c + 1 < w16 ? __ldg(pw + c + 1) : 0u;
      const uint32_t w2 = c + 2 < w16 ? __ldg(pw + c + 2) : 0u;
      const uint64_t win = window96(w0, w1, w2, (int)(p & 15) * 2);
      kmer = bk::fold_runs(reverse_groups(win) >> (64 - 2 * span), *ss);
      if (nmask != nullptr) {
        const uint32_t* nm = nmask + b * nmw;
        const int64_t d = p >> 5;
        const uint32_t m0 = __ldg(nm + d);
        const uint32_t m1 = d + 1 < nmw ? __ldg(nm + d + 1) : 0u;
        bad = (((((uint64_t)m1 << 32) | m0) >> (p & 31)) & ss->nbits_lo) != 0;
      }
    } else {
      const uint32_t* nm = nmask + b * nmw;
      int64_t cw = -1, cm = -1;
      uint32_t word = 0, mword = 0;
      for (int j = 0; j < k; ++j) {
        const int64_t q = p + ss->pos[j];
        if (q >> 4 != cw) cw = q >> 4, word = __ldg(pw + cw);
        kmer = (kmer << 2) | ((word >> (2 * (q & 15))) & 3u);
        if (nmask != nullptr) {
          if (q >> 5 != cm) cm = q >> 5, mword = __ldg(nm + cm);
          bad |= (mword >> (q & 31)) & 1u;
        }
      }
    }
    v = !bad && kmer != ~0ULL &&
        p < read_length(lengths, len16, b) - (span - 1);
  } else {
    // bases p .. p + 31, base p in the low bits
    const int64_t c = p >> 4;
    const uint32_t w0 = __ldg(pw + c);
    const uint32_t w1 = c + 1 < w16 ? __ldg(pw + c + 1) : 0u;
    const uint32_t w2 = c + 2 < w16 ? __ldg(pw + c + 2) : 0u;
    const uint64_t win = window96(w0, w1, w2, (int)(p & 15) * 2);
    kmer = reverse_groups(win) >> (64 - 2 * k);
    if (canon) {
      const uint64_t rc = ~win & (k < 32 ? (1ULL << (2 * k)) - 1 : ~0ULL);
      kmer = rc < kmer ? rc : kmer;
    }
    bool bad = false;
    if (nmask != nullptr) {
      const uint32_t* nm = nmask + b * nmw;
      const int64_t d = p >> 5;
      const uint32_t m0 = __ldg(nm + d);
      const uint32_t m1 = d + 1 < nmw ? __ldg(nm + d + 1) : 0u;
      const uint64_t nbits = k < 32 ? (1ULL << k) - 1 : 0xFFFFFFFFULL;
      bad = (((((uint64_t)m1 << 32) | m0) >> (p & 31)) & nbits) != 0;
    }
    // in-length validity: a read shorter than k has no valid position
    v = !bad && p < read_length(lengths, len16, b) - (k - 1);
  }
  if constexpr (kMode == kSparse) {
    if (v && n_list > 0) {
      const int64_t c = kSpaced ? ss->span : k;
      v = !listed_n(list, n_list, (uint64_t)(b * (P + c - 1) + p), (int)c,
                    ss);
    }
  }

  if constexpr (kMode == kEncode) {
    kmers_out[i] = v ? (int64_t)kmer : 0;
    valid[i] = v;
    return;
  }
  bool found = false;
  uint32_t sel = 0;   // u32 value index (inline) or bucket*4+lane (flat)
  uint64_t pos = 0;   // 64-bit flat slot position of the match
  if (v) {
    const uint64_t h = splitmix64(kmer);
    const uint64_t bmask = (1ULL << lgnb) - 1;
    const uint64_t b1 = h & bmask;
    const uint64_t q = h >> lgnb;
    const uint64_t vmask = (1ULL << vbits) - 1;
    const uint64_t e1 = (1ULL << 63) | (q << vbits);
    // the first bucket whose row matches; within it the sums over the
    // matching lanes, as the plain version takes them
    for (int ch = 0; ch < 2 && !found; ++ch) {
      uint64_t bk = ch ? b1 ^ (splitmix64(q ^ kBSalt) & bmask) : b1;
      if constexpr (kMode == kRange) {
        bk -= (uint64_t)row0;  // the local row; a foreign bucket misses
        if (bk >= (uint64_t)rows) continue;
      }
      const uint64_t e = ch ? (e1 | (1ULL << 62)) : e1;
      const ulonglong2 lo = slots[2 * bk];
      const ulonglong2 hi = slots[2 * bk + 1];
      const uint64_t row[4] = {lo.x, lo.y, hi.x, hi.y};
      uint32_t s = 0;
      uint64_t ps = 0;
      for (int l = 0; l < 4; ++l) {
        if ((row[l] & ~vmask) == e) {
          found = true;
          ps += bk * 4 + l;
          s += is_inline ? (uint32_t)(row[l] & vmask) : (uint32_t)(bk * 4 + l);
        }
      }
      if (found) {
        sel = s;
        pos = ps;
      }
    }
  }
  uint64_t val = 0;
  if (found) {
    int64_t idx = is_inline ? (int64_t)sel : (int64_t)pos;
    if (idx > n_vals - 1) idx = n_vals - 1;
    val = vals[idx];
  }
  const bool h = v && found;
  hit[i] = h;
  valid[i] = v;
  cidx[i] = h ? (int32_t)(uint32_t)(val & 0xFFFFFFFFULL) : 0;
  oidx[i] = h ? (want_idx ? sel : (uint32_t)(val >> 32)) : 0u;
}

template <bool kSpaced, int kMode = kProbe>
int launch(const void* pcodes, int64_t w16, const void* nmask, int64_t nmw,
           const void* lengths, int len16, int64_t B, int64_t P, int k,
           int canon,
           const void* slots, int lgnb, int vbits, const void* vals,
           int64_t n_vals, int is_inline, int want_idx, void* hit,
           void* valid, void* cidx, void* oidx, const bk::Spacing& sp,
           void* stream, int64_t row0 = 0, int64_t rows = 0,
           void* kmers = nullptr, const void* nidx = nullptr,
           int64_t n_nidx = 0) {
  const int64_t n = B * P;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  encode_probe_kernel<kSpaced, kMode>
      <<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)pcodes, w16, (const uint32_t*)nmask, nmw,
          lengths, len16, n, P, k, canon, (const ulonglong2*)slots,
          lgnb, vbits, (const uint64_t*)vals, n_vals, is_inline, want_idx,
          (bool*)hit, (bool*)valid, (int32_t*)cidx, (uint32_t*)oidx, sp,
          row0, rows, (int64_t*)kmers, (const uint32_t*)nidx, n_nidx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bk_encode_probe(
    const void* pcodes, int64_t w16, const void* nmask, int64_t nmw,
    const void* lengths, int len16, int64_t B, int64_t P, int k, int canon,
    const void* slots, int lgnb, int vbits, const void* vals, int64_t n_vals,
    int is_inline, int want_idx, void* hit, void* valid, void* cidx,
    void* oidx, void* stream) {
  return launch<false>(pcodes, w16, nmask, nmw, lengths, len16, B, P, k,
                       canon, slots, lgnb, vbits, vals, n_vals, is_inline,
                       want_idx, hit, valid, cidx, oidx, bk::Spacing{},
                       stream);
}

// A spaced seed of k offsets ``positions`` (a host array, positions[0] =
// 0); P = lproc - positions[k - 1], uncanonical.
extern "C" int bk_encode_probe_spaced(
    const void* pcodes, int64_t w16, const void* nmask, int64_t nmw,
    const void* lengths, int len16, int64_t B, int64_t P, int k,
    const int32_t* positions, const void* slots, int lgnb, int vbits,
    const void* vals, int64_t n_vals, int is_inline, int want_idx, void* hit,
    void* valid, void* cidx, void* oidx, void* stream) {
  return launch<true>(pcodes, w16, nmask, nmw, lengths, len16, B, P, k, 0,
                      slots, lgnb, vbits, vals, n_vals, is_inline, want_idx,
                      hit, valid, cidx, oidx, bk::make_spacing(positions, k),
                      stream);
}

// The a2a route's encode: kmers (B, P) int64 (0 where not valid), valid
// (B, P) bool; contiguous (canonical with ``canon``) or, with ``spaced``,
// the k offsets ``positions`` (a host array, as bk_encode_probe_spaced).
extern "C" int bk_encode_only(const void* pcodes, int64_t w16,
                              const void* nmask, int64_t nmw,
                              const void* lengths, int len16, int64_t B,
                              int64_t P, int k, int canon, int spaced,
                              const int32_t* positions, void* kmers,
                              void* valid, void* stream) {
  if (spaced)
    return launch<true, kEncode>(
        pcodes, w16, nmask, nmw, lengths, len16, B, P, k, 0, nullptr, 0, 0,
        nullptr, 0, 0, 0, nullptr, valid, nullptr, nullptr,
        bk::make_spacing(positions, k), stream, 0, 0, kmers);
  return launch<false, kEncode>(pcodes, w16, nmask, nmw, lengths, len16, B,
                                P, k, canon, nullptr, 0, 0, nullptr, 0, 0, 0,
                                nullptr, valid, nullptr, nullptr,
                                bk::Spacing{}, stream, 0, 0, kmers);
}

// The psum route's probe of rows [row0, row0 + rows) of the global table:
// ``slots`` (rows, 4) and, flat, ``vals`` (rows, 4) are the rank's rows;
// inline vals the global unique values.  Otherwise as bk_encode_probe
// (and bk_encode_probe_spaced with ``spaced``).
extern "C" int bk_encode_probe_range(
    const void* pcodes, int64_t w16, const void* nmask, int64_t nmw,
    const void* lengths, int len16, int64_t B, int64_t P, int k, int canon,
    int spaced, const int32_t* positions, const void* slots, int lgnb,
    int vbits, const void* vals, int64_t n_vals, int is_inline, int want_idx,
    int64_t row0, int64_t rows, void* hit, void* valid, void* cidx,
    void* oidx, void* stream) {
  if (row0 < 0 || rows < 1) return (int)cudaErrorInvalidValue;
  if (spaced)
    return launch<true, kRange>(
        pcodes, w16, nmask, nmw, lengths, len16, B, P, k, 0, slots, lgnb,
        vbits, vals, n_vals, is_inline, want_idx, hit, valid, cidx, oidx,
        bk::make_spacing(positions, k), stream, row0, rows);
  return launch<false, kRange>(pcodes, w16, nmask, nmw, lengths, len16, B, P,
                               k, canon, slots, lgnb, vbits, vals, n_vals,
                               is_inline, want_idx, hit, valid, cidx, oidx,
                               bk::Spacing{}, stream, row0, rows);
}

// The sparse-N channel: ``nidx`` (n_nidx,) u32 flat positions row * lproc
// + col of the in-read Ns, sorted ascending, padded with 0x7FFFFFFF, in
// place of the N mask; B * lproc <= 0x7FFFFFFF.  Otherwise as
// bk_encode_probe (and bk_encode_probe_spaced with ``spaced``).
extern "C" int bk_encode_probe_sparse(
    const void* pcodes, int64_t w16, const void* nidx, int64_t n_nidx,
    const void* lengths, int len16, int64_t B, int64_t P, int k, int canon,
    int spaced, const int32_t* positions, const void* slots, int lgnb,
    int vbits, const void* vals, int64_t n_vals, int is_inline, int want_idx,
    void* hit, void* valid, void* cidx, void* oidx, void* stream) {
  const int64_t c = spaced ? positions[k - 1] + 1 : k;
  if (n_nidx < 0 || B * (P + c - 1) > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  if (spaced)
    return launch<true, kSparse>(
        pcodes, w16, nullptr, 0, lengths, len16, B, P, k, 0, slots, lgnb,
        vbits, vals, n_vals, is_inline, want_idx, hit, valid, cidx, oidx,
        bk::make_spacing(positions, k), stream, 0, 0, nullptr, nidx, n_nidx);
  return launch<false, kSparse>(pcodes, w16, nullptr, 0, lengths, len16, B, P,
                                k, canon, slots, lgnb, vbits, vals, n_vals,
                                is_inline, want_idx, hit, valid, cidx, oidx,
                                bk::Spacing{}, stream, 0, 0, nullptr, nidx,
                                n_nidx);
}
