// Native Gustavson SpGEMM: C = A @ B on host CSR (the AMG Galerkin-RAP
// hot path — the reference does this inside Hypre on device, hypre.c:97;
// here setup is host-side and must not expand products into giant COO
// intermediates like the NumPy fallback in ops/spgemm.py does).
//
// Two-call API so the caller owns all allocations:
//   lsb_spgemm_count: per-row output nnz -> c_offs (exclusive scan included)
//   lsb_spgemm_fill:  numeric pass writing c_cols (sorted) / c_vals
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (see native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Returns total nnz of C, or -1 on error. c_offs must hold m+1 entries.
long long lsb_spgemm_count(long long m,
                           const long long* a_offs, const int32_t* a_cols,
                           const long long* b_offs, const int32_t* b_cols,
                           long long b_ncols, long long* c_offs) {
    if (m < 0 || b_ncols < 0) return -1;
    std::vector<long long> marker(static_cast<size_t>(b_ncols), -1);
    c_offs[0] = 0;
    for (long long i = 0; i < m; ++i) {
        long long cnt = 0;
        for (long long t = a_offs[i]; t < a_offs[i + 1]; ++t) {
            const int32_t k = a_cols[t];
            for (long long u = b_offs[k]; u < b_offs[k + 1]; ++u) {
                const int32_t j = b_cols[u];
                if (marker[j] != i) {
                    marker[j] = i;
                    ++cnt;
                }
            }
        }
        c_offs[i + 1] = c_offs[i] + cnt;
    }
    return c_offs[m];
}

// Numeric pass; c_offs from lsb_spgemm_count. Columns sorted per row.
int lsb_spgemm_fill(long long m,
                    const long long* a_offs, const int32_t* a_cols,
                    const double* a_vals,
                    const long long* b_offs, const int32_t* b_cols,
                    const double* b_vals,
                    long long b_ncols, const long long* c_offs,
                    int32_t* c_cols, double* c_vals) {
    if (m < 0 || b_ncols < 0) return 1;
    std::vector<long long> marker(static_cast<size_t>(b_ncols), -1);
    std::vector<double> acc(static_cast<size_t>(b_ncols), 0.0);
    for (long long i = 0; i < m; ++i) {
        long long head = c_offs[i];
        for (long long t = a_offs[i]; t < a_offs[i + 1]; ++t) {
            const int32_t k = a_cols[t];
            const double av = a_vals[t];
            for (long long u = b_offs[k]; u < b_offs[k + 1]; ++u) {
                const int32_t j = b_cols[u];
                if (marker[j] != i) {
                    marker[j] = i;
                    acc[j] = av * b_vals[u];
                    c_cols[head++] = j;
                } else {
                    acc[j] += av * b_vals[u];
                }
            }
        }
        if (head != c_offs[i + 1]) return 2;  // count/fill mismatch
        std::sort(c_cols + c_offs[i], c_cols + c_offs[i + 1]);
        for (long long t = c_offs[i]; t < c_offs[i + 1]; ++t)
            c_vals[t] = acc[c_cols[t]];
    }
    return 0;
}

}  // extern "C"
