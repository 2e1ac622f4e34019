"""Host-side CSR matrix core (NumPy).

Counterpart of `lsbench_tpu/matrix/csr.py`: the same 0-based container with
the same assembly semantics (entries sorted by (row, col), duplicates
summed — the reference's lsbench-csr.c:54-63). Device layouts are derived
from it in `matrix/bsr.py`; it never touches a device itself.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CsrMatrix:
    """0-based host CSR. `offs` has length nrows+1; cols sorted within rows."""

    nrows: int
    ncols: int
    offs: np.ndarray  # int64 (nrows+1,)
    cols: np.ndarray  # int32  (nnz,)
    vals: np.ndarray  # float64 (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.offs[-1])

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    @staticmethod
    def from_coo(
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        nrows: int | None = None,
        ncols: int | None = None,
        sum_duplicates: bool = True,
    ) -> "CsrMatrix":
        """Assemble CSR from 0-based COO triplets: sorted by (row, col),
        duplicates summed; the shape defaults to max-index+1, and empty
        rows are represented correctly."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        if rows.shape != cols.shape or rows.shape != vals.shape:
            raise ValueError("rows/cols/vals must have identical shapes")
        if rows.size == 0:
            raise ValueError("matrix has zero entries")
        if rows.min() < 0 or cols.min() < 0:
            raise ValueError("negative indices in COO input")

        if nrows is None:
            nrows = int(rows.max()) + 1
        if ncols is None:
            ncols = int(cols.max()) + 1
        if rows.max() >= nrows or cols.max() >= ncols:
            raise ValueError("index exceeds given matrix shape")

        key = rows * ncols + cols
        order = np.argsort(key, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]

        if sum_duplicates:
            key = key[order]
            key_change = np.empty(rows.size, dtype=bool)
            key_change[0] = True
            key_change[1:] = key[1:] != key[:-1]
            seg = np.cumsum(key_change) - 1
            uniq = int(seg[-1]) + 1
            vals = np.bincount(seg, weights=vals, minlength=uniq)
            rows = rows[key_change]
            cols = cols[key_change]

        offs = np.zeros(nrows + 1, dtype=np.int64)
        offs[1:] = np.cumsum(np.bincount(rows, minlength=nrows))
        return CsrMatrix(nrows, ncols, offs, cols.astype(np.int32), vals)

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.row_indices(), self.cols.copy(), self.vals.copy()

    def row_indices(self) -> np.ndarray:
        """Expand offs to a per-nnz row index array."""
        return np.repeat(np.arange(self.nrows, dtype=np.int64), np.diff(self.offs))

    def diagonal(self) -> np.ndarray:
        d = np.zeros(min(self.shape), dtype=np.float64)
        r = self.row_indices()
        on_diag = r == self.cols
        d[r[on_diag]] = self.vals[on_diag]
        return d

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Host f64 reference SpMV (the oracle for the device kernels)."""
        x = np.asarray(x, dtype=np.float64)
        prod = self.vals * x[self.cols]
        out = np.zeros(self.nrows, dtype=np.float64)
        np.add.at(out, self.row_indices(), prod)
        return out

    def permuted(self, perm: np.ndarray) -> "CsrMatrix":
        """Symmetric permutation B = A[perm, perm]."""
        perm = np.asarray(perm, dtype=np.int64)
        if perm.shape != (self.nrows,) or self.nrows != self.ncols:
            raise ValueError("permutation must match a square matrix")
        inv = np.empty_like(perm)
        inv[perm] = np.arange(self.nrows)
        r, c, v = self.to_coo()
        return CsrMatrix.from_coo(inv[r], inv[c], v, nrows=self.nrows,
                                  ncols=self.ncols, sum_duplicates=False)
