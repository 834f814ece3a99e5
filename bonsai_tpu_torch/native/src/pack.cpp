// Copied unchanged from bonsai_tpu/native/src/pack.cpp.
// One-pass batch preparation for the classify upload path
// (classify/pipeline.py _prepare_batch): pad + 2-bit pack + N-channel
// extraction in a single sweep over the codes, replacing ~6 numpy passes
// in the producer thread.  Host-side runtime component (the reference's
// equivalent hot path is kseq_read + bseq batching, kseq_declare.h).
//
// Inputs are (n, L) int8 codes (-1 = ambiguous), per-row lengths.
// Outputs:
//   pcodes (Bp, w16) u32  little-endian 2-bit codes, 16 per word; columns
//                         past a row's length (or rows past n) pack as 0
//   nmask  (Bp, nmw) u32  bit set where the UNPACKED code would be -1
//                         (in-read N, or any column >= the row's length) —
//                         matches the python pack_codes semantics exactly
//   nidx   (cap,) u32     flat row*lproc+col of in-read Ns (col < length),
//                         sentinel-padded with 0x7FFFFFFF
// Returns the total count of in-read Ns (the caller picks the upload
// channel: 0 -> none, <= cap -> sparse, else mask).

#include <cstdint>
#include <cstring>

extern "C" int64_t btpu_pack_batch(
    const int8_t* codes, int64_t n, int64_t L, const int32_t* lengths,
    int64_t Bp, int64_t w16, int64_t lproc,
    uint32_t* pcodes, uint32_t* nmask, int64_t nmw,
    uint32_t* nidx, int64_t cap) {
  const int64_t W = w16 * 16;  // unpacked columns covered by the words
  int64_t n_inread = 0;
  for (int64_t i = 0; i < cap; ++i) nidx[i] = 0x7FFFFFFFu;
  for (int64_t r = 0; r < Bp; ++r) {
    uint32_t* pw = pcodes + r * w16;
    uint32_t* nm = nmask + r * nmw;
    if (r >= n) {
      std::memset(pw, 0, sizeof(uint32_t) * (size_t)w16);
      std::memset(nm, 0xFF, sizeof(uint32_t) * (size_t)nmw);
      continue;
    }
    const int8_t* row = codes + r * L;
    const int64_t len = lengths[r];
    std::memset(pw, 0, sizeof(uint32_t) * (size_t)w16);
    std::memset(nm, 0, sizeof(uint32_t) * (size_t)nmw);
    for (int64_t c = 0; c < W; ++c) {
      int8_t v = (c < L) ? row[c] : (int8_t)-1;
      if (v < 0) {
        nm[c >> 5] |= 1u << (c & 31);
        if (c < len) {
          if (n_inread < cap) nidx[n_inread] = (uint32_t)(r * lproc + c);
          ++n_inread;
        }
        v = 0;
      }
      pw[c >> 4] |= (uint32_t)(v & 3) << ((c & 15) * 2);
    }
    // nmask tail bits past the covered words (odd w16): mirror the
    // numpy reference, which masks whatever the padded codes hold there
    for (int64_t c = W; c < nmw * 32; ++c) {
      int8_t v = (c < L) ? row[c] : (int8_t)-1;
      if (v < 0) nm[c >> 5] |= 1u << (c & 31);
    }
  }
  return n_inread;
}
