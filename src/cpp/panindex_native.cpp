// Native CPU serving engine for pangenome_index_tpu.
//
// The reference implements its serving path (find_mems/query_tags) as C++
// over encoded r-index blocks (src/find_mems.cpp, src/r-index.cpp). This is
// the equivalent engine over our flat run tables: rank via binary search +
// per-run cumulative counts, FMD bidirectional extension, the 3-step MEM
// algorithm (algorithm.hpp:653-757 semantics, including the NUL sentinel of
// step 3), and the tag interval query. OpenMP data-parallel over reads -
// mirroring the reference's intended CPU deployment - so the benchmark's
// vs_baseline is measured against a genuine native multithreaded CPU engine,
// not a Python loop.
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstring>
#include <algorithm>
#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int SIGMA = 6;
// complement in code space: '\n'<->'\n', A<->T, C<->G, N<->N
constexpr int COMP[SIGMA] = {0, 5, 3, 2, 4, 1};

struct Index {
    const int8_t* run_sym;
    const int64_t* run_start;
    const int64_t* cum;   // [r][6]
    const int64_t* C;     // [7]
    int64_t r;
    int64_t n;
};

inline int64_t run_of(const Index& ix, int64_t pos) {
    // largest j with run_start[j] <= pos
    int64_t lo = 0, hi = ix.r - 1;
    while (lo < hi) {
        int64_t mid = (lo + hi + 1) >> 1;
        if (ix.run_start[mid] <= pos) lo = mid; else hi = mid - 1;
    }
    return lo;
}

inline void rank6(const Index& ix, int64_t pos, int64_t out[SIGMA]) {
    int64_t j = run_of(ix, pos);
    const int64_t* row = ix.cum + j * SIGMA;
    for (int c = 0; c < SIGMA; ++c) out[c] = row[c];
    out[ix.run_sym[j]] += pos - ix.run_start[j];
}

struct BInt { int64_t k, kp, s; };

// kp_weight[c][d] = 1 iff comp(d) < comp(c) (see utils/alphabet.py)
inline BInt backward_extend(const Index& ix, BInt b, int c) {
    int64_t rk[SIGMA], rks[SIGMA];
    rank6(ix, b.k, rk);
    rank6(ix, b.k + b.s, rks);
    int64_t kp = b.kp;
    for (int d = 0; d < SIGMA; ++d)
        if (COMP[d] < COMP[c]) kp += rks[d] - rk[d];
    int64_t s = rks[c] - rk[c];
    if (s <= 0) return {0, 0, 0};
    return {rk[c] + ix.C[c], kp, s};
}

inline BInt forward_extend(const Index& ix, BInt b, int c) {
    BInt t = backward_extend(ix, {b.kp, b.k, b.s}, COMP[c]);
    return {t.kp, t.k, t.s};
}

}  // namespace

extern "C" {

// MEM finding over a batch of reads. codes: [n_reads][max_len] (0-padded),
// lengths: [n_reads]. Outputs per read up to `capacity` MEMs into
// out_{start,end,bwt,size} ([n_reads][capacity]) and out_count [n_reads].
void panindex_find_mems(
    const int8_t* run_sym, const int64_t* run_start, const int64_t* cum,
    const int64_t* C, int64_t r, int64_t n,
    const int32_t* codes, const int32_t* lengths,
    int64_t n_reads, int64_t max_len,
    int64_t min_len, int64_t min_occ, int64_t capacity,
    int64_t* out_start, int64_t* out_end, int64_t* out_bwt, int64_t* out_size,
    int32_t* out_count, int32_t n_threads)
{
    Index ix{run_sym, run_start, cum, C, r, n};
#ifdef _OPENMP
    if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel for schedule(dynamic, 8)
#endif
    for (int64_t i = 0; i < n_reads; ++i) {
        const int32_t* p = codes + i * max_len;
        int64_t len = lengths[i];
        int64_t* ms = out_start + i * capacity;
        int64_t* me = out_end + i * capacity;
        int64_t* mb = out_bwt + i * capacity;
        int64_t* mz = out_size + i * capacity;
        int32_t cnt = 0;
        auto code_at = [&](int64_t j) -> int { return j < len ? p[j] : 0; };
        int64_t x = 0;
        while (x < len) {
            if (len - x < min_len) break;
            // step 1
            BInt b{0, 0, ix.n};
            int64_t j = x + min_len - 1;
            bool fail = false;
            for (;;) {
                b = backward_extend(ix, b, code_at(j));
                if (b.s < min_occ || b.s <= 0) { x = j + 1; fail = true; break; }
                if (j == x || j == 0) break;
                --j;
            }
            if (fail) continue;
            // step 2
            BInt b2 = b;
            for (j = x + min_len; j < len; ++j) {
                b = forward_extend(ix, b, code_at(j));
                if (b.s < min_occ || b.s <= 0) break;
                b2 = b;
            }
            int64_t e = j;
            if (cnt < capacity) {
                ms[cnt] = x; me[cnt] = e; mb[cnt] = b2.k; mz[cnt] = b2.s;
            }
            ++cnt;
            // step 3
            BInt back{0, 0, ix.n};
            int64_t nx = x + 1;
            for (j = e; j > x; --j) {
                back = backward_extend(ix, back, code_at(j));
                if (back.s < min_occ || back.s <= 0) { nx = j + 1; break; }
            }
            x = nx > x ? nx : x + 1;
        }
        out_count[i] = cnt;
    }
}

// Batched exact-match count (query_tags path): returns [first, second] per read.
void panindex_count(
    const int8_t* run_sym, const int64_t* run_start, const int64_t* cum,
    const int64_t* C, int64_t r, int64_t n,
    const int32_t* codes, const int32_t* lengths,
    int64_t n_reads, int64_t max_len,
    int64_t* out_first, int64_t* out_second, int32_t n_threads)
{
    Index ix{run_sym, run_start, cum, C, r, n};
#ifdef _OPENMP
    if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel for schedule(dynamic, 16)
#endif
    for (int64_t i = 0; i < n_reads; ++i) {
        const int32_t* p = codes + i * max_len;
        int64_t len = lengths[i];
        int64_t first = 0, second = ix.n - 1;
        for (int64_t j = len - 1; j >= 0; --j) {
            int c = p[j];
            if (c == 0 || first > second) { first = 1; second = 0; break; }
            int64_t lo6[SIGMA], hi6[SIGMA];
            rank6(ix, first, lo6);
            rank6(ix, second + 1, hi6);
            int64_t inside = hi6[c] - lo6[c];
            if (inside == 0) { first = 1; second = 0; break; }
            first = lo6[c] + ix.C[c];
            second = first + inside - 1;
        }
        out_first[i] = first;
        out_second[i] = second;
    }
}

// Tag interval queries: for each [start_i, end_i], collect the unique packed
// graph positions of the runs the reference's compact query would decode
// (query_compressed_compact, tag_arrays.cpp:856-890, including its
// every-10th-run skip quirk when exact == 0). Results go to
// out_positions[i*capacity ..]; out_unique[i] = count (clamped to capacity).
void panindex_query_tags(
    const int64_t* pos_enc, const int64_t* bwt_start, int64_t t_runs,
    const int64_t* q_start, const int64_t* q_end, int64_t n_queries,
    int64_t capacity, int exact,
    int64_t* out_positions, int32_t* out_unique, int32_t* out_runs,
    int32_t n_threads)
{
#ifdef _OPENMP
    if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel for schedule(dynamic, 64)
#endif
    for (int64_t i = 0; i < n_queries; ++i) {
        // first_bit = #run-starts <= start (searchsorted right)
        auto sright = [&](int64_t v) {
            int64_t lo = 0, hi = t_runs;
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if (bwt_start[mid] <= v) lo = mid + 1; else hi = mid;
            }
            return lo;
        };
        int64_t first_bit = sright(q_start[i]);
        int64_t end_bit = sright(q_end[i]);
        int64_t run_nums = end_bit - first_bit + 1;
        int64_t s = exact ? (first_bit > 0 ? first_bit - 1 : 0)
                          : ((first_bit % 10 == 0) ? first_bit : first_bit - 1);
        int64_t lo = s < 0 ? 0 : s;
        int64_t hi = s + run_nums;
        if (hi > t_runs) hi = t_runs;
        int64_t* out = out_positions + i * capacity;
        int64_t cnt = 0;
        for (int64_t j = lo; j < hi && cnt < capacity; ++j) {
            int64_t v = pos_enc[j];
            bool seen = false;
            for (int64_t q = 0; q < cnt; ++q) if (out[q] == v) { seen = true; break; }
            if (!seen) out[cnt++] = v;
        }
        std::sort(out, out + cnt);
        out_unique[i] = (int32_t)cnt;
        out_runs[i] = (int32_t)run_nums;
    }
}

int panindex_version() { return 2; }  // 2: psi_walk window args (-> _v2 name)

}  // extern "C"
