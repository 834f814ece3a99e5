// Copied unchanged from bonsai_tpu/native/src/kraken_out.cpp.
// Native Kraken-format classification emitter.
//
// The per-read text formatting (run-length-encoded hit taxa; reference
// append_kraken_classification, include/bonsai/classifier.h:112-129) is
// the host-side bottleneck once the device classifies ~700k reads/s —
// the Python formatter tops out around 34k reads/s.  This emits the
// byte-identical format at C speed.
//
// Returns bytes written, or -(bytes needed) when the caller's buffer is
// too small (caller retries with a larger one).

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

inline char *put_u32(char *p, uint32_t v) {
  char tmp[10];
  int n = 0;
  do {
    tmp[n++] = '0' + (v % 10);
    v /= 10;
  } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

}  // namespace

// One row per classification unit (a read, or a merged mate pair whose
// hit row spans both mates).  lengths2 is non-null for paired batches;
// n_kmers / n_kmers1 are the valid-kmer counts feeding the reference's
// ambiguity arithmetic (classifier.h:232-240).
extern "C" int64_t btpu_format_kraken(
    int64_t n, const uint8_t *names, const int64_t *name_offs,
    const int32_t *lengths, const int32_t *lengths2, const uint32_t *taxon,
    const uint32_t *taxa, const uint8_t *hitmask, int64_t P,
    const int32_t *n_missing, const int32_t *n_kmers, const int32_t *n_kmers1,
    int32_t comb_size, int32_t emit_all, uint8_t *out, int64_t cap) {
  char *p = (char *)out;
  char *end = (char *)out + cap;
  int64_t needed_extra = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t t = taxon[i];
    if (!emit_all && !t) continue;
    // worst case line length: name + 64 header + 12 bytes per hit run
    const uint8_t *nm = names + name_offs[i];
    int64_t nm_len = name_offs[i + 1] - name_offs[i];
    const uint32_t *row = taxa + i * P;
    const uint8_t *hm = hitmask + i * P;
    int64_t n_hits = 0;
    for (int64_t j = 0; j < P; ++j) n_hits += hm[j];
    int64_t max_len = nm_len + 64 + 14 * (n_hits ? n_hits : 1);
    if (p + max_len > end) {
      // keep counting what we still need, emit nothing more
      needed_extra += max_len;
      continue;
    }
    *p++ = t ? 'C' : 'U';
    *p++ = '\t';
    memcpy(p, nm, (size_t)nm_len);
    p += nm_len;
    *p++ = '\t';
    p = put_u32(p, t);
    *p++ = '\t';
    uint32_t l1 = (uint32_t)lengths[i];
    p = put_u32(p, l1);
    uint32_t missing = (uint32_t)n_missing[i];
    // reference unsigned arithmetic (classifier.h:232-240), wraps for
    // short reads: l - c + 1 - valid, plus the mate-2 increment against
    // the combined valid count
    uint32_t ambig = l1 - (uint32_t)comb_size + 1u - (uint32_t)n_kmers1[i];
    if (lengths2) {
      uint32_t l2 = (uint32_t)lengths2[i];
      ambig += l2 - ((uint32_t)comb_size - 1u) - (uint32_t)n_kmers[i];
    }
    if (missing) {
      *p++ = '\t';
      *p++ = 'M';
      *p++ = ':';
      p = put_u32(p, missing);
    }
    if (ambig) {
      *p++ = '\t';
      *p++ = 'A';
      *p++ = ':';
      p = put_u32(p, ambig);
    }
    if (!t) {
      memcpy(p, "\t0:0\n", 5);
      p += 5;
      continue;
    }
    // RLE over the compacted hit taxa
    uint32_t cur = 0;
    uint32_t run = 0;
    bool have = false;
    for (int64_t j = 0; j < P; ++j) {
      if (!hm[j]) continue;
      uint32_t v = row[j];
      if (have && v == cur) {
        ++run;
        continue;
      }
      if (have) {
        *p++ = '\t';
        if (cur == 0)
          *p++ = 'U';
        else if (cur == 0xFFFFFFFFu)
          *p++ = 'A';
        else
          p = put_u32(p, cur);
        *p++ = ':';
        p = put_u32(p, run);
      }
      cur = v;
      run = 1;
      have = true;
    }
    if (have) {
      *p++ = '\t';
      if (cur == 0)
        *p++ = 'U';
      else if (cur == 0xFFFFFFFFu)
        *p++ = 'A';
      else
        p = put_u32(p, cur);
      *p++ = ':';
      p = put_u32(p, run);
    }
    *p++ = '\n';
  }
  if (needed_extra) return -((int64_t)(p - (char *)out) + needed_extra + 64);
  return (int64_t)(p - (char *)out);
}

// Runs-based variant: the device already run-length-encoded each read's
// hit-taxa stream (classify/pipeline.py compact output), so the host
// formats straight from (run taxid, run length) arrays — no positional
// matrix, ~4x fewer bytes fetched from the device.  Layout: run_vals /
// run_lens are (n, maxr) row-major; n_runs[i] <= maxr actual runs.
extern "C" int64_t btpu_format_kraken_runs(
    int64_t n, const uint8_t *names, const int64_t *name_offs,
    const int32_t *lengths, const int32_t *lengths2, const uint32_t *taxon,
    const uint32_t *run_vals, const uint32_t *run_lens, const int32_t *n_runs,
    int64_t maxr, const int32_t *n_missing, const int32_t *n_kmers,
    const int32_t *n_kmers1, int32_t comb_size, int32_t emit_all,
    uint8_t *out, int64_t cap) {
  char *p = (char *)out;
  char *end = (char *)out + cap;
  int64_t needed_extra = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t t = taxon[i];
    if (!emit_all && !t) continue;
    const uint8_t *nm = names + name_offs[i];
    int64_t nm_len = name_offs[i + 1] - name_offs[i];
    int64_t nr = n_runs[i];
    if (nr > maxr) nr = maxr;
    // worst case: name + 64 header + "4294967295:4294967295\t" per run
    int64_t max_len = nm_len + 64 + 25 * (nr ? nr : 1);
    if (p + max_len > end) {
      needed_extra += max_len;
      continue;
    }
    *p++ = t ? 'C' : 'U';
    *p++ = '\t';
    memcpy(p, nm, (size_t)nm_len);
    p += nm_len;
    *p++ = '\t';
    p = put_u32(p, t);
    *p++ = '\t';
    uint32_t l1 = (uint32_t)lengths[i];
    p = put_u32(p, l1);
    uint32_t missing = (uint32_t)n_missing[i];
    uint32_t ambig = l1 - (uint32_t)comb_size + 1u - (uint32_t)n_kmers1[i];
    if (lengths2) {
      uint32_t l2 = (uint32_t)lengths2[i];
      ambig += l2 - ((uint32_t)comb_size - 1u) - (uint32_t)n_kmers[i];
    }
    if (missing) {
      *p++ = '\t';
      *p++ = 'M';
      *p++ = ':';
      p = put_u32(p, missing);
    }
    if (ambig) {
      *p++ = '\t';
      *p++ = 'A';
      *p++ = ':';
      p = put_u32(p, ambig);
    }
    if (!t) {
      memcpy(p, "\t0:0\n", 5);
      p += 5;
      continue;
    }
    const uint32_t *rv = run_vals + i * maxr;
    const uint32_t *rl = run_lens + i * maxr;
    for (int64_t j = 0; j < nr; ++j) {
      *p++ = '\t';
      uint32_t v = rv[j];
      if (v == 0)
        *p++ = 'U';
      else if (v == 0xFFFFFFFFu)
        *p++ = 'A';
      else
        p = put_u32(p, v);
      *p++ = ':';
      p = put_u32(p, rl[j]);
    }
    *p++ = '\n';
  }
  if (needed_extra) return -((int64_t)(p - (char *)out) + needed_extra + 64);
  return (int64_t)(p - (char *)out);
}
