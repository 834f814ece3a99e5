// Copied from bonsai_tpu/native/src/kmers.cpp; only the reference path
// in the comment below lost its local directory prefix.
// One-pass canonical k-mer extraction over a raw sequence.
//
// Native-runtime counterpart of the reference's scalar rolling encoder
// (bonsai include/bonsai/encoder.h:241-272): O(1) carried state
// (forward kmer, reverse-complement kmer, run length since the last
// ambiguous base), ambiguous base -> restart.  Canonical representation is
// min(fw, rc) (kmerutil.h:137-140).  Used by the DB-build fast path for
// the (DNA, contiguous, unwindowed) discipline; bit-identical to the
// vectorized BatchEncoder emissions (verified in tests/test_native_io.py).

#include <cstdint>

extern "C" {

// Emits one u64 per valid window into `out` (caller sizes it to n).
// Returns the number of kmers emitted, or -1 on bad arguments.
int64_t btpu_canon_kmer_set(const uint8_t *seq, int64_t n, const int8_t *lut,
                            int32_t k, int32_t canonical, uint64_t *out) {
  if (k < 1 || k > 32 || n < 0) return -1;
  const uint64_t mask =
      (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  const int shift = 2 * (k - 1);
  uint64_t fw = 0, rc = 0;
  int64_t run = 0, m = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int8_t c = lut[seq[i]];
    if (c < 0) {
      run = 0;
      fw = 0;
      rc = 0;
      continue;
    }
    fw = ((fw << 2) | (uint64_t)(uint8_t)c) & mask;
    rc = (rc >> 2) | (((uint64_t)(3 - (uint8_t)c)) << shift);
    if (++run >= k) out[m++] = canonical ? (fw < rc ? fw : rc) : fw;
  }
  return m;
}

}  // extern "C"
