// Native left-looking sparse Cholesky numeric factorization — the
// setup-phase hot loop of the sparse direct solver. Mirrors
// solvers/sparse_cholesky.py::numeric_factor exactly (same pattern-driven
// left-looking column algorithm over the CSC fill pattern), in C++ for the
// CHOLMOD-role CPU factorization speed (cholmod.c:68 factors on host too).
//
// C ABI for ctypes. Inputs:
//   n            — matrix dimension
//   a_offs/a_cols/a_vals — symmetrized CSR of A
//   cp/ci        — CSC pattern of L (diagonal first per column, rows asc)
//   lrow_offs/lrow_cols  — strictly-lower row pattern of L (ascending)
// Output:
//   cx           — numeric values of L in the cp/ci layout
// Returns 0, or 1+j if column j is not positive definite.

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

int64_t lsb_chol_numeric(int64_t n, const int64_t *a_offs,
                         const int32_t *a_cols, const double *a_vals,
                         const int64_t *cp, const int64_t *ci,
                         const int64_t *lrow_offs, const int64_t *lrow_cols,
                         double *cx) {
  std::vector<double> w(n, 0.0);
  for (int64_t j = 0; j < n; ++j) {
    // Scatter A(j, j:) — the lower column by symmetry.
    for (int64_t t = a_offs[j]; t < a_offs[j + 1]; ++t)
      if (a_cols[t] >= j) w[a_cols[t]] = a_vals[t];
    // Left-looking update: for each k with L(j,k) != 0.
    for (int64_t t = lrow_offs[j]; t < lrow_offs[j + 1]; ++t) {
      int64_t k = lrow_cols[t];
      // Find row j inside column k (rows ascending; binary search).
      int64_t lo = cp[k], hi = cp[k + 1];
      while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (ci[mid] < j)
          lo = mid + 1;
        else
          hi = mid;
      }
      double ljk = cx[lo];
      for (int64_t s = lo; s < cp[k + 1]; ++s) w[ci[s]] -= ljk * cx[s];
    }
    double dj = w[j];
    if (!(dj > 0.0)) return 1 + j;
    dj = std::sqrt(dj);
    cx[cp[j]] = dj;
    w[j] = 0.0;
    for (int64_t s = cp[j] + 1; s < cp[j + 1]; ++s) {
      cx[s] = w[ci[s]] / dj;
      w[ci[s]] = 0.0;
    }
  }
  return 0;
}

// Host CSC triangular solve x = (L L^T)^{-1} b — the CPU-baseline the
// reference's default backend times (CHOLMOD solves on the host,
// cholmod.c:68 useGPU=0, cholmod-impl.h:44-63). Diagonal first in each
// column; k columns of b solved back-to-back.
void lsb_tri_solve(int64_t n, int64_t k, const int64_t *cp,
                   const int64_t *ci, const double *cx, const double *b,
                   double *x) {
  for (int64_t col = 0; col < k; ++col) {
    const double *bc = b + col * n;
    double *xc = x + col * n;
    for (int64_t i = 0; i < n; ++i) xc[i] = bc[i];
    for (int64_t j = 0; j < n; ++j) {
      double xj = xc[j] / cx[cp[j]];
      xc[j] = xj;
      for (int64_t s = cp[j] + 1; s < cp[j + 1]; ++s)
        xc[ci[s]] -= cx[s] * xj;
    }
    for (int64_t j = n - 1; j >= 0; --j) {
      double acc = xc[j];
      for (int64_t s = cp[j] + 1; s < cp[j + 1]; ++s)
        acc -= cx[s] * xc[ci[s]];
      xc[j] = acc / cx[cp[j]];
    }
  }
}

}  // extern "C"
