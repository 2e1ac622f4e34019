"""IC(0) incomplete-Cholesky preconditioner (counterpart of
`lsbench_tpu/solvers/ic0.py`).

The reference's Krylov backend preconditions with Jacobi (ginkgo.cpp:57);
the library it wraps (Ginkgo) also ships IC/ILU factorization
preconditioners, and IC(0) is the standard stronger choice for the SPD
workload. The split mirrors the sparse direct path
(`solvers/sparse_cholesky.py`):

- host numeric phase (the JAX package's NumPy arithmetic): zero-fill
  left-looking factorization restricted to tril(A)'s pattern, updates
  landing outside the pattern dropped, with Manteuffel diagonal-shift
  retry on breakdown (IC(0) of an SPD matrix can fail; A + αD succeeds for
  α large enough);
- device apply: z = (L Lᵀ)⁻¹ r by the level schedule's `pack_tri` /
  `apply_tri`, one launch of the triangular-sweep kernel per sweep on the
  card (`ops/tri_sweep.py`), the plain sweep on the CPU.
"""

from __future__ import annotations

import numpy as np

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.solvers.sparse_cholesky import (apply_tri, pack_tri,
                                                       symmetrize)


def ic0_factor(A: CsrMatrix, shift: float = 0.0, max_tries: int = 8
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zero-fill incomplete Cholesky L on tril(A)'s pattern.

    Returns CSC arrays (cp, ci, cx) of L with its diagonal, rows ascending
    within each column (the layout `pack_tri` takes). `A` is symmetrized
    first (the reference builds from one triangle assuming symmetry,
    cholmod-impl.h:5-18). On breakdown, retries factorizing A + αD with α
    escalating from max(shift, 1e-3) by 10x.
    """
    S = symmetrize(A)
    n = S.nrows
    offs, cols, vals = S.offs, S.cols, S.vals

    # Under symmetry, CSC column j of tril(A) = row j's entries at
    # cols ≥ j (values equal by symmetry, order ascending).
    upper_start = np.searchsorted(
        np.repeat(np.arange(n), np.diff(offs)) * (n + 1) + cols,
        np.arange(n) * (n + 1) + np.arange(n))
    # Column pointers of L: entries of row j with col >= j.
    col_len = offs[1:] - upper_start
    if np.any(col_len <= 0):
        raise np.linalg.LinAlgError("IC(0) requires a full diagonal")
    cp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(col_len, out=cp[1:])
    keep = np.zeros(offs[-1], dtype=bool)
    for j in range(n):
        keep[upper_start[j]:offs[j + 1]] = True
    ci = cols[keep].astype(np.int64)
    a_low = vals[keep].copy()
    diag_ok = ci[cp[:-1]] == np.arange(n)
    if not np.all(diag_ok):
        raise np.linalg.LinAlgError("IC(0) requires a full diagonal")

    diag0 = a_low[cp[:-1]].copy()
    alpha = float(shift)
    for attempt in range(max_tries):
        cx = _ic0_numeric(n, offs, cols, vals, cp, ci, a_low, diag0, alpha)
        if cx is not None:
            return cp, ci, cx
        alpha = max(alpha * 10.0, 1e-3) if attempt else max(shift, 1e-3)
    raise np.linalg.LinAlgError(
        f"IC(0) broke down even with diagonal shift {alpha:.1e}")


def _ic0_numeric(n, offs, cols, vals, cp, ci, a_low, diag0, alpha):
    """One factorization attempt at diagonal shift α; None on breakdown."""
    cx = np.zeros_like(a_low)
    w = np.zeros(n)
    for j in range(n):
        pj = ci[cp[j]:cp[j + 1]]
        w[pj] = a_low[cp[j]:cp[j + 1]]
        w[j] += alpha * abs(diag0[j])
        touched = []
        # Row j's strictly-lower pattern: the k < j with A[j,k] != 0, whose
        # columns update column j (L's row pattern is A's at zero fill).
        for k in cols[offs[j]:offs[j + 1]]:
            k = int(k)
            if k >= j:
                break  # cols ascending within the row
            ck = ci[cp[k]:cp[k + 1]]
            s = int(np.searchsorted(ck, j))
            if s == ck.size or ck[s] != j:
                continue  # (j,k) dropped: cannot happen at zero fill
            ljk = cx[cp[k] + s]
            seg = ck[s:]
            # Scatter the whole tail; entries outside pj are DROPPED when
            # w[pj] is read back: the zero-fill restriction.
            w[seg] -= ljk * cx[cp[k] + s: cp[k + 1]]
            touched.append(seg)
        dj = w[j]
        if not (dj > 0.0) or not np.isfinite(dj):
            w[pj] = 0.0
            for seg in touched:
                w[seg] = 0.0
            return None
        dj = np.sqrt(dj)
        col = w[pj] / dj
        col[0] = dj
        cx[cp[j]:cp[j + 1]] = col
        w[pj] = 0.0
        for seg in touched:
            w[seg] = 0.0
    return cx


def ic0_precond(A: CsrMatrix, dtype, device, shift: float = 0.0, **_):
    """(state, apply) for the preconditioner contract: z = (L Lᵀ)⁻¹ r with
    L = IC(0)(A), both sweeps on `device` in `dtype`. `state` is the
    `TriPack`; its `check()` reads the kernel's error word (once per
    solve, `preconditioners.check`)."""
    cp, ci, cx = ic0_factor(A, shift=shift)
    state, _ = pack_tri(cp, ci, cx, A.nrows, dtype, device)

    def apply(state, r):
        return apply_tri(state, r).to(r.dtype)

    return state, apply
