"""Host-side sparse × sparse products for AMG setup (counterpart of
`lsbench_tpu/ops/spgemm.py`).

Galerkin coarse operators (RAP) are built once, on the host, during setup.
The product is the native Gustavson kernel (`native/spgemm.cpp`, this
package's copy of the JAX package's source) with a NumPy expansion
taken only when that library cannot be built or loaded. A native product
that fails raises: it is never hidden behind the fallback.
"""

from __future__ import annotations

import numpy as np

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.native import NativeUnavailable


def spgemm(A: CsrMatrix, B: CsrMatrix) -> CsrMatrix:
    """C = A @ B on the host, columns sorted within rows."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    try:
        from lsbench_tpu_torch.native.spgemm import spgemm_native
        c_offs, c_cols, c_vals = spgemm_native(
            A.nrows, A.offs, A.cols, A.vals, B.offs, B.cols, B.vals, B.ncols)
        return CsrMatrix(nrows=A.nrows, ncols=B.ncols, offs=c_offs,
                         cols=c_cols, vals=c_vals)
    except NativeUnavailable:
        pass
    # For each nnz (i, k, v) of A, expand the k-th row of B.
    a_rows = A.row_indices()
    counts = (B.offs[A.cols + 1] - B.offs[A.cols]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        # Structurally empty product: one stored zero (from_coo needs nnz>0).
        return CsrMatrix.from_coo([0], [0], [0.0], nrows=A.nrows, ncols=B.ncols)
    out_i = np.repeat(a_rows, counts)
    out_va = np.repeat(A.vals, counts)
    starts = B.offs[A.cols].astype(np.int64)
    ends = np.cumsum(counts)
    flat = np.arange(total, dtype=np.int64) - np.repeat(ends - counts, counts) \
        + np.repeat(starts, counts)
    return CsrMatrix.from_coo(out_i, B.cols[flat], out_va * B.vals[flat],
                              nrows=A.nrows, ncols=B.ncols)


def rap(R: CsrMatrix, A: CsrMatrix, P: CsrMatrix) -> CsrMatrix:
    """Galerkin triple product R A P (coarse-grid operator)."""
    return spgemm(spgemm(R, A), P)


def drop_small(A: CsrMatrix, tol: float) -> CsrMatrix:
    """Drop entries with |a_ij| <= tol * max|row| (keeps the diagonal)."""
    if tol <= 0:
        return A
    r = A.row_indices()
    rowmax = np.zeros(A.nrows)
    np.maximum.at(rowmax, r, np.abs(A.vals))
    keep = (np.abs(A.vals) > tol * rowmax[r]) | (r == A.cols)
    return CsrMatrix.from_coo(r[keep], A.cols[keep], A.vals[keep],
                              nrows=A.nrows, ncols=A.ncols,
                              sum_duplicates=False)
