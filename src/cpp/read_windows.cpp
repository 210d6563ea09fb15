// Serving host precompute: per-position rolling window keys + sparse-
// dictionary lookups for a read batch.
//
// The numpy forms (ops/mertable.read_mer_keys - an L-step rolling column
// scan - and ops/sparsedict.lookup_read_windows - query-sorted
// searchsorted) cost ~1.25 s per 16384x150 bp batch on one core, which
// bottlenecks pipelined serving on small hosts. This renders both in one OpenMP pass: reads are
// independent (perfect parallelism), and lookups go through a radix table
// over the keys' high bits so each probe binary-searches ~a cache line
// instead of 22 DRAM-missy levels over the whole key array.
//
// Exact-equality contract with the numpy forms is tested in
// tests/test_native.py (including garbage-key columns, which are
// reproduced bit-for-bit: consumers mask through `valid`).

#include <cstdint>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Bucket starts by key high bits: out_lo[b] = first index in keys (sorted,
// [n]) whose (key >> shift) >= b; out_lo has n_buckets + 1 entries.
void panindex_window_radix(const int64_t *keys, int64_t n, int64_t shift,
                           int64_t n_buckets, int64_t *out_lo) {
  int64_t b = 0;
  out_lo[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t hb = keys[i] >> shift;
    while (b < hb && b < n_buckets) out_lo[++b] = i;
  }
  while (b < n_buckets) out_lo[++b] = n;
}

// codes [B, L] alphabet codes; code_to_base [n_codes] (-1 = non-ACGT).
// Outputs (always written): out_keys [B, L+1] int64, out_valid [B, L+1].
// With dict_keys non-null: out_idx [B, L+1] = dictionary row or -1, using
// radix_lo (n_buckets+1 entries over high bits >= radix_shift).
void panindex_read_windows(const int32_t *codes, const int32_t *lengths,
                           int64_t B, int64_t L, int64_t m,
                           const int8_t *code_to_base, int64_t n_codes,
                           const int64_t *dict_keys, int64_t n_keys,
                           const int64_t *radix_lo, int64_t radix_shift,
                           int64_t *out_keys, uint8_t *out_valid,
                           int32_t *out_idx, int32_t n_threads) {
  const int64_t W = L + 1;
  const int64_t mask = (m >= 32) ? -1 : ((int64_t(1) << (2 * m)) - 1);
#ifdef _OPENMP
  if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel for schedule(static)
#endif
  for (int64_t r = 0; r < B; ++r) {
    const int32_t *row = codes + r * L;
    int64_t *ok_keys = out_keys + r * W;
    uint8_t *ok_valid = out_valid + r * W;
    int32_t *ok_idx = out_idx ? out_idx + r * W : nullptr;
    const int64_t len = lengths[r];
    int64_t k = 0;
    int64_t run = 0;
    for (int64_t i = 0; i < W; ++i) {
      ok_keys[i] = 0;
      ok_valid[i] = 0;
      if (ok_idx) ok_idx[i] = -1;
    }
    if (L < m) continue;
    for (int64_t i = 0; i < L; ++i) {
      int32_t c = row[i];
      int8_t base = (c >= 0 && c < n_codes) ? code_to_base[c] : int8_t(-1);
      k = ((k << 2) | (base < 0 ? 0 : base)) & mask;
      run = (base < 0) ? 0 : run + 1;
      if (i >= m - 1) {
        ok_keys[i] = k;
        uint8_t v = (run >= m) && (i < len);
        ok_valid[i] = v;
        if (ok_idx && v && n_keys > 0) {
          int64_t hb = k >> radix_shift;
          int64_t lo = radix_lo[hb], hi = radix_lo[hb + 1];
          while (lo < hi) {  // lower_bound within the bucket
            int64_t mid = (lo + hi) >> 1;
            if (dict_keys[mid] < k) lo = mid + 1; else hi = mid;
          }
          if (lo < n_keys && dict_keys[lo] == k) ok_idx[i] = int32_t(lo);
        }
      }
    }
  }
}

}  // extern "C"
