// The quotient-cuckoo probe as a device function: KB5 lookup_scores
// (lookup_scores.cu) probes the phase-1 table with it, one k-mer a thread,
// and KD1's route_probe (route.cu) a rank's sub-table; the score::Hash
// instantiations of KB1 (minimizers.cu) and KB4 (compacted_minimizers.cu)
// probe U k-mers of a thread at once with ProbeBatch (below).
//
// It is probe_slots_device of bonsai_tpu/db/table.py:370-406 (with
// splitmix64, core/hashes.py:84, and KmerTable._split, :101), written as
// K1 writes it (encode_probe.cu keeps its own copy: on this header, with
// the rows and the value read through __ldg, K1 took 5% longer on an
// NVIDIA H100 80GB HBM3 where every probe hits, and __ldg gained the
// kernels here nothing):
//   h = splitmix64(kmer), b1 = h & (nb - 1), q = h >> lgnb,
//   b2 = b1 ^ (splitmix64(q ^ BSALT) & (nb - 1));
// the first bucket whose 32-B row holds a slot equal, outside its vbits
// value field, to [occupied | choice | q] decides; within it the value
// index (inline) or the flat slot position of the matching lanes is
// summed, as the plain version takes it, and the value is read at that
// index clamped to the value array (the flat position is 64-bit, so
// images of 2^31 slots and more index correctly).  The second row is read
// only when the first has no match.  Everything sits in an anonymous
// namespace, so each source that includes this header owns its copy.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bk {
namespace {

constexpr uint64_t kBucketSalt = 0xA24BAED4963EE407ULL;

// A slot image on the card (db/table.py ProbeArrays): slots (nb, 4) u64
// as 16-B pairs, vals (n_vals,) inline or (nb, 4) flat.
struct ProbeTable {
  const ulonglong2* slots;
  const uint64_t* vals;
  int64_t n_vals;
  int lgnb;
  int vbits;
  int is_inline;
};

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// true and the packed value of ``kmer`` where the image holds it; with
// ``sel_out``, also the u32 value index (inline) or the u32 flat slot
// position (flat) of the match (probe_slots' want_idx)
__device__ __forceinline__ bool probe(const ProbeTable& t, uint64_t kmer,
                                      uint64_t* val,
                                      uint32_t* sel_out = nullptr) {
  const uint64_t h = splitmix64(kmer);
  const uint64_t bmask = (1ULL << t.lgnb) - 1;
  const uint64_t b1 = h & bmask;
  const uint64_t q = h >> t.lgnb;
  const uint64_t vmask = (1ULL << t.vbits) - 1;
  const uint64_t e1 = (1ULL << 63) | (q << t.vbits);
  bool found = false;
  uint32_t sel = 0;  // u32 value index (inline)
  uint64_t pos = 0;  // 64-bit flat slot position (flat)
  for (int ch = 0; ch < 2 && !found; ++ch) {
    const uint64_t b = ch ? b1 ^ (splitmix64(q ^ kBucketSalt) & bmask) : b1;
    const uint64_t e = ch ? (e1 | (1ULL << 62)) : e1;
    const ulonglong2 lo = t.slots[2 * b];
    const ulonglong2 hi = t.slots[2 * b + 1];
    const uint64_t row[4] = {lo.x, lo.y, hi.x, hi.y};
    for (int l = 0; l < 4; ++l) {
      if ((row[l] & ~vmask) == e) {
        found = true;
        sel += (uint32_t)(row[l] & vmask);
        pos += b * 4 + l;
      }
    }
  }
  if (found) {
    int64_t idx = t.is_inline ? (int64_t)sel : (int64_t)pos;
    if (idx > t.n_vals - 1) idx = t.n_vals - 1;
    *val = t.vals[idx];
    if (sel_out) *sel_out = t.is_inline ? sel : (uint32_t)pos;
  }
  return found;
}

// the score::Hash score of ``kmer``: its phase-1 value, U64_MAX where
// phase 1 lacks it (bonsai_tpu/db/table.py ScoreMap.lookup_scores)
__device__ __forceinline__ uint64_t hash_score(const ProbeTable& t,
                                               uint64_t kmer) {
  uint64_t v = 0;
  return probe(t, kmer, &v) ? v : ~0ULL;
}

// Whether the slot row (lo, hi) of bucket b holds ``e`` outside the vbits
// value field; each matching lane adds its value index (inline) or its
// flat slot position to ``acc``, as probe sums them.
__device__ __forceinline__ bool match_row(const ProbeTable& t, ulonglong2 lo,
                                          ulonglong2 hi, uint64_t e,
                                          uint64_t b, uint64_t& acc) {
  const uint64_t vmask = (1ULL << t.vbits) - 1;
  const uint64_t row[4] = {lo.x, lo.y, hi.x, hi.y};
  bool found = false;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    if ((row[l] & ~vmask) == e) {
      found = true;
      acc += t.is_inline ? (row[l] & vmask) : b * 4 + l;
    }
  }
  return found;
}

// A batch of up to U probes of one thread in flight: ``issue`` computes
// every bucket of kmer[0..n) and loads every first row before any compare
// (lanes from n on load nothing); ``finish`` compares, loads the second
// rows of the lanes that missed in their first together (a second row
// only on a miss, as probe: K1's header records that loading both at once
// lost), then the values of the lanes found, and gives hash_score of each
// lane (U64_MAX from n on).  Work placed between the two hides the rows'
// latency.  An inline index is the u32 sum of the matching lanes' fields,
// so the 64-bit sum is cut to 32 bits; a flat one is the 64-bit slot
// position; both clamp to the value array.
template <int U>
struct ProbeBatch {
  uint64_t h[U];  // splitmix64 of each lane's k-mer
  ulonglong2 lo[U], hi[U];
  int n;

  __device__ __forceinline__ void issue(const ProbeTable& t,
                                        const uint64_t (&kmer)[U], int n_) {
    n = n_;
    const uint64_t bmask = (1ULL << t.lgnb) - 1;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h[u] = splitmix64(kmer[u]);
      if (u < n) {
        const uint64_t b = h[u] & bmask;
        lo[u] = t.slots[2 * b];
        hi[u] = t.slots[2 * b + 1];
      }
    }
  }

  __device__ __forceinline__ void finish(const ProbeTable& t,
                                         uint64_t (&out)[U]) {
    const uint64_t bmask = (1ULL << t.lgnb) - 1;
    uint64_t acc[U], b[U];
    uint32_t found = 0;  // bit u: lane u's k-mer is in the image
#pragma unroll
    for (int u = 0; u < U; ++u) {
      acc[u] = 0;
      b[u] = h[u] & bmask;
      if (u < n && match_row(t, lo[u], hi[u],
                             (1ULL << 63) | ((h[u] >> t.lgnb) << t.vbits),
                             b[u], acc[u]))
        found |= 1u << u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n && !(found >> u & 1)) {
        b[u] ^= splitmix64((h[u] >> t.lgnb) ^ kBucketSalt) & bmask;
        lo[u] = t.slots[2 * b[u]];
        hi[u] = t.slots[2 * b[u] + 1];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u < n && !(found >> u & 1) &&
          match_row(t, lo[u], hi[u],
                    (3ULL << 62) | ((h[u] >> t.lgnb) << t.vbits), b[u],
                    acc[u]))
        found |= 1u << u;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      out[u] = ~0ULL;
      if (found >> u & 1) {
        int64_t idx =
            t.is_inline ? (int64_t)(uint32_t)acc[u] : (int64_t)acc[u];
        if (idx > t.n_vals - 1) idx = t.n_vals - 1;
        out[u] = t.vals[idx];
      }
    }
  }
};

// hash_score of kmer[0..n) of one thread, probed together so that their
// rows are in flight at once (n <= U; U64_MAX from n on)
template <int U>
__device__ __forceinline__ void hash_scores(const ProbeTable& t,
                                            const uint64_t (&kmer)[U],
                                            uint64_t (&out)[U], int n) {
  ProbeBatch<U> pb;
  pb.issue(t, kmer, n);
  pb.finish(t, out);
}

}  // namespace
}  // namespace bk
