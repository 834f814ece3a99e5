// Copied unchanged from bonsai_tpu/native/src/sortops.cpp.
// Host-side sort primitives for the DB-build pipeline.
//
// The reference builds its khash map through pointer-chasing inserts; the
// TPU rebuild's deterministic sort-and-fold formulation (db/build.py) is
// bottlenecked by numpy's comparison sorts instead.  These LSD radix
// routines (16-bit digits, skip-constant-digit passes) replace
// np.argsort / np.unique on the 10-50M-element u64 k-mer streams.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kDigitBits = 16;
constexpr size_t kBuckets = size_t(1) << kDigitBits;

// Which 16-bit digit positions actually vary across the array.
inline uint32_t varying_digits(const uint64_t *keys, int64_t n) {
  uint64_t ormask = 0, andmask = ~uint64_t(0);
  for (int64_t i = 0; i < n; ++i) {
    ormask |= keys[i];
    andmask &= keys[i];
  }
  uint64_t diff = ormask ^ andmask;
  uint32_t out = 0;
  for (int p = 0; p < 4; ++p)
    if ((diff >> (p * kDigitBits)) & 0xFFFFu) out |= 1u << p;
  return out;
}

}  // namespace

// In-place radix sort of keys[n].  Returns 0 on success.
extern "C" int btpu_radix_sort_u64(uint64_t *keys, int64_t n) {
  if (n <= 1) return 0;
  uint32_t digits = varying_digits(keys, n);
  if (!digits) return 0;
  std::vector<uint64_t> tmp(n);
  uint64_t *src = keys, *dst = tmp.data();
  std::vector<int64_t> count(kBuckets);
  for (int p = 0; p < 4; ++p) {
    if (!((digits >> p) & 1)) continue;
    int shift = p * kDigitBits;
    std::memset(count.data(), 0, kBuckets * sizeof(int64_t));
    for (int64_t i = 0; i < n; ++i) ++count[(src[i] >> shift) & 0xFFFFu];
    int64_t sum = 0;
    for (size_t b = 0; b < kBuckets; ++b) {
      int64_t c = count[b];
      count[b] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; ++i)
      dst[count[(src[i] >> shift) & 0xFFFFu]++] = src[i];
    uint64_t *t = src;
    src = dst;
    dst = t;
  }
  if (src != keys) std::memcpy(keys, src, size_t(n) * sizeof(uint64_t));
  return 0;
}

// In-place stable radix sort of (keys, vals) pairs by key.
extern "C" int btpu_radix_sort_kv(uint64_t *keys, uint32_t *vals, int64_t n) {
  if (n <= 1) return 0;
  uint32_t digits = varying_digits(keys, n);
  if (!digits) return 0;
  std::vector<uint64_t> ktmp(n);
  std::vector<uint32_t> vtmp(n);
  uint64_t *ks = keys, *kd = ktmp.data();
  uint32_t *vs = vals, *vd = vtmp.data();
  std::vector<int64_t> count(kBuckets);
  for (int p = 0; p < 4; ++p) {
    if (!((digits >> p) & 1)) continue;
    int shift = p * kDigitBits;
    std::memset(count.data(), 0, kBuckets * sizeof(int64_t));
    for (int64_t i = 0; i < n; ++i) ++count[(ks[i] >> shift) & 0xFFFFu];
    int64_t sum = 0;
    for (size_t b = 0; b < kBuckets; ++b) {
      int64_t c = count[b];
      count[b] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      int64_t pos = count[(ks[i] >> shift) & 0xFFFFu]++;
      kd[pos] = ks[i];
      vd[pos] = vs[i];
    }
    uint64_t *kt = ks;
    ks = kd;
    kd = kt;
    uint32_t *vt = vs;
    vs = vd;
    vd = vt;
  }
  if (ks != keys) {
    std::memcpy(keys, ks, size_t(n) * sizeof(uint64_t));
    std::memcpy(vals, vs, size_t(n) * sizeof(uint32_t));
  }
  return 0;
}

// Sort keys[n] and drop duplicates in place; returns the unique count.
extern "C" int64_t btpu_sort_dedup_u64(uint64_t *keys, int64_t n) {
  if (n <= 1) return n;
  btpu_radix_sort_u64(keys, n);
  int64_t m = 1;
  for (int64_t i = 1; i < n; ++i)
    if (keys[i] != keys[m - 1]) keys[m++] = keys[i];
  return m;
}

// K-way merge of sorted-unique k-mer runs with inline LCA-fold group
// statistics (db/build.py lca_fold_pairs semantics).  The build's fold
// inputs are always "accumulated sorted array + per-genome sorted-unique
// sets with one constant taxid each", so merging beats re-sorting the
// concatenation: one linear pass, no 8B*N*4-pass radix traffic.
//
// Per-run element metadata comes either from per-element arrays (the
// accumulated run) or per-run constants (genome runs): a NULL pointer in
// run_tins / run_tvals selects the constant.
//
// Emitted per unique key (matching the numpy reduceat formulation):
//   tmin  = min over group of (present ? tin : big)
//   tmax  = max over group of (present ? tin : -2)
//   n_miss, n_nz counts; mmin/mmax of missing taxids (else ~0u / 0u)
//   count = group multiplicity (ftct's genome count)
// where present = (tin != big), nz = (tval != 0), miss = nz && !present.
namespace {
int64_t merge_fold_core(
    int32_t n_runs, const uint64_t *const *run_keys, const int64_t *run_lens,
    const int32_t *const *run_tins, const int32_t *run_tin_const,
    const uint32_t *const *run_tvals, const uint32_t *run_tval_const,
    int32_t big, uint64_t *out_keys, int32_t *out_tmin, int32_t *out_tmax,
    uint32_t *out_nmiss, uint32_t *out_nnz, uint32_t *out_mmin,
    uint32_t *out_mmax, uint32_t *out_count) {
  std::vector<int64_t> pos(n_runs, 0);
  int64_t m = 0;
  for (;;) {
    uint64_t key = ~uint64_t(0);
    bool any = false;
    for (int r = 0; r < n_runs; ++r) {
      if (pos[r] < run_lens[r]) {
        uint64_t k = run_keys[r][pos[r]];
        if (!any || k < key) key = k;
        any = true;
      }
    }
    if (!any) break;
    int32_t tmin = big, tmax = -2;
    uint32_t nmiss = 0, nnz = 0, cnt = 0;
    uint32_t mmin = ~0u, mmax = 0;
    for (int r = 0; r < n_runs; ++r) {
      while (pos[r] < run_lens[r] && run_keys[r][pos[r]] == key) {
        int64_t i = pos[r]++;
        int32_t tin = run_tins[r] ? run_tins[r][i] : run_tin_const[r];
        uint32_t tv = run_tvals[r] ? run_tvals[r][i] : run_tval_const[r];
        bool present = tin != big;
        if (present) {
          if (tin < tmin) tmin = tin;
          if (tin > tmax) tmax = tin;
        }
        if (tv != 0) {
          ++nnz;
          if (!present) {
            ++nmiss;
            if (tv < mmin) mmin = tv;
            if (tv > mmax) mmax = tv;
          }
        }
        ++cnt;
      }
    }
    out_keys[m] = key;
    out_tmin[m] = tmin;
    out_tmax[m] = tmax;
    out_nmiss[m] = nmiss;
    out_nnz[m] = nnz;
    out_mmin[m] = mmin;
    out_mmax[m] = mmax;
    out_count[m] = cnt;
    ++m;
  }
  return m;
}
}  // namespace

extern "C" int64_t btpu_merge_fold_stats(
    int32_t n_runs, const uint64_t *const *run_keys, const int64_t *run_lens,
    const int32_t *const *run_tins, const int32_t *run_tin_const,
    const uint32_t *const *run_tvals, const uint32_t *run_tval_const,
    int32_t big, uint64_t *out_keys, int32_t *out_tmin, int32_t *out_tmax,
    uint32_t *out_nmiss, uint32_t *out_nnz, uint32_t *out_mmin,
    uint32_t *out_mmax, uint32_t *out_count) {
  int64_t total = 0;
  for (int r = 0; r < n_runs; ++r) total += run_lens[r];
  if (total < (int64_t(1) << 21)) {
    return merge_fold_core(n_runs, run_keys, run_lens, run_tins,
                           run_tin_const, run_tvals, run_tval_const, big,
                           out_keys, out_tmin, out_tmax, out_nmiss, out_nnz,
                           out_mmin, out_mmax, out_count);
  }
  // two-way split on a key pivot: groups never straddle the cut, so the
  // halves merge independently on two threads; part 2 lands at the tail
  // of the output buffers and is compacted with one memmove per array.
  const uint64_t *biggest = run_keys[0];
  int64_t blen = run_lens[0];
  for (int r = 1; r < n_runs; ++r)
    if (run_lens[r] > blen) {
      biggest = run_keys[r];
      blen = run_lens[r];
    }
  uint64_t pivot = biggest[blen / 2];
  std::vector<const uint64_t *> k1(n_runs), k2(n_runs);
  std::vector<int64_t> l1(n_runs), l2(n_runs);
  std::vector<const int32_t *> t1(n_runs), t2(n_runs);
  std::vector<const uint32_t *> v1(n_runs), v2(n_runs);
  int64_t cap2 = 0;
  for (int r = 0; r < n_runs; ++r) {
    // lower_bound(pivot)
    const uint64_t *kk = run_keys[r];
    int64_t lo = 0, hi = run_lens[r];
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (kk[mid] < pivot)
        lo = mid + 1;
      else
        hi = mid;
    }
    k1[r] = kk;
    l1[r] = lo;
    k2[r] = kk + lo;
    l2[r] = run_lens[r] - lo;
    t1[r] = run_tins[r];
    t2[r] = run_tins[r] ? run_tins[r] + lo : nullptr;
    v1[r] = run_tvals[r];
    v2[r] = run_tvals[r] ? run_tvals[r] + lo : nullptr;
    cap2 += l2[r];
  }
  int64_t off2 = total - cap2;  // tail region capacity == cap2
  int64_t m2 = 0;
  std::thread th([&] {
    m2 = merge_fold_core(n_runs, k2.data(), l2.data(), t2.data(),
                         run_tin_const, v2.data(), run_tval_const, big,
                         out_keys + off2, out_tmin + off2, out_tmax + off2,
                         out_nmiss + off2, out_nnz + off2, out_mmin + off2,
                         out_mmax + off2, out_count + off2);
  });
  int64_t m1 = merge_fold_core(n_runs, k1.data(), l1.data(), t1.data(),
                               run_tin_const, v1.data(), run_tval_const, big,
                               out_keys, out_tmin, out_tmax, out_nmiss,
                               out_nnz, out_mmin, out_mmax, out_count);
  th.join();
  if (m1 != off2) {
    std::memmove(out_keys + m1, out_keys + off2, m2 * sizeof(uint64_t));
    std::memmove(out_tmin + m1, out_tmin + off2, m2 * sizeof(int32_t));
    std::memmove(out_tmax + m1, out_tmax + off2, m2 * sizeof(int32_t));
    std::memmove(out_nmiss + m1, out_nmiss + off2, m2 * sizeof(uint32_t));
    std::memmove(out_nnz + m1, out_nnz + off2, m2 * sizeof(uint32_t));
    std::memmove(out_mmin + m1, out_mmin + off2, m2 * sizeof(uint32_t));
    std::memmove(out_mmax + m1, out_mmax + off2, m2 * sizeof(uint32_t));
    std::memmove(out_count + m1, out_count + off2, m2 * sizeof(uint32_t));
  }
  return m1 + m2;
}

// Sequential two-choice 4-slot cuckoo placement for the quotient table
// (db/table.py _try_build).  The slot layout is a derived probe structure
// — any valid placement probes identically — so this uses the classic
// scalar insert + bounded random-walk eviction instead of the vectorized
// greedy rounds.  Deterministic (eviction path seeded from the key).
// Returns 0 on success, 1 if the walk budget is exhausted (caller grows
// the table), matching the python fallback's grow-on-failure contract.

namespace {
inline uint64_t splitmix64_c(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}
}  // namespace

namespace {
// try the 4 slots of `bucket`; returns true if placed
inline bool try_place(int64_t *owner, uint8_t *choice, int64_t bucket,
                      int64_t key_idx, uint8_t ch) {
  int64_t base = bucket * 4;
  for (int l = 0; l < 4; ++l)
    if (owner[base + l] < 0) {
      owner[base + l] = key_idx;
      choice[base + l] = ch;
      return true;
    }
  return false;
}
}  // namespace

extern "C" int btpu_cuckoo_place(
    const uint64_t *h,  // pre-mixed key hashes, n of them
    int64_t n, int64_t nb, uint64_t bsalt, int32_t max_walk,
    int64_t *owner,     // nb*4, -1 = empty (initialized here)
    uint8_t *choice) {  // nb*4
  const uint64_t mask = uint64_t(nb - 1);
  int lgnb = 0;
  while ((int64_t(1) << lgnb) < nb) ++lgnb;
  for (int64_t s = 0; s < nb * 4; ++s) owner[s] = -1;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t hv = h[i];
    uint64_t b1 = hv & mask;
    uint64_t b2 = b1 ^ (splitmix64_c((hv >> lgnb) ^ bsalt) & mask);
    if (try_place(owner, choice, int64_t(b1), i, 0)) continue;
    if (try_place(owner, choice, int64_t(b2), i, 1)) continue;
    // random-walk eviction
    int64_t cur = i;
    uint8_t ch = 1;  // evict from b2 first
    int64_t bucket = int64_t(b2);
    bool done = false;
    for (int walk = 0; walk < max_walk; ++walk) {
      uint64_t r = splitmix64_c(hv + uint64_t(0x9E37) + uint64_t(walk));
      int lane = int(r & 3u);
      int64_t base = bucket * 4;
      int64_t victim = owner[base + lane];
      uint8_t vch = choice[base + lane];
      owner[base + lane] = cur;
      choice[base + lane] = ch;
      // displaced key moves to its other bucket
      cur = victim;
      hv = h[cur];
      uint64_t vb1 = hv & mask;
      uint64_t vb2 = vb1 ^ (splitmix64_c((hv >> lgnb) ^ bsalt) & mask);
      bucket = (vch == 0) ? int64_t(vb2) : int64_t(vb1);
      ch = (vch == 0) ? 1 : 0;
      if (try_place(owner, choice, bucket, cur, ch)) {
        done = true;
        break;
      }
    }
    if (!done) return 1;
  }
  return 0;
}
