"""Padded-CSR (ELL) layout (counterpart of `lsbench_tpu/matrix/ell.py`, the
same arrays bit for bit).

Every row is padded to the widest row's count k: `vals`/`cols` are dense
(n_pad, k) arrays and SpMV is one gather, one multiply and one row sum
(`ops/spmv.py`). Padding slots hold col=0 / val=0, so their gathers stay
in bounds and add nothing. Rows are padded to a multiple of `row_align`
and k to a multiple of `width_align`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class EllMatrix:
    vals: torch.Tensor  # (n_pad, k) — padded entries (0 in padding)
    cols: torch.Tensor  # (n_pad, k) int32 — column of each entry (0 in padding)
    nrows: int
    ncols: int
    nnz: int

    @property
    def n_pad(self) -> int:
        return self.vals.shape[0]

    @property
    def k(self) -> int:
        return self.vals.shape[1]

    @property
    def bytes_streamed(self) -> int:
        """Bytes of values and column indices read per SpMV."""
        return self.vals.numel() * (self.vals.element_size() + 4)

    @staticmethod
    def from_csr(A: CsrMatrix, dtype=torch.float64, row_align: int = 8,
                 width_align: int = 1, device="cuda") -> "EllMatrix":
        n_pad = _round_up(A.nrows, row_align)
        counts = np.diff(A.offs)
        k = _round_up(max(int(counts.max()), 1), width_align)
        cols = np.zeros((n_pad, k), dtype=np.int32)
        vals = np.zeros((n_pad, k), dtype=np.float64)
        # Each nnz goes to (row, its index within the row).
        r = A.row_indices()
        slot = np.arange(A.nnz) - A.offs[r]
        cols[r, slot] = A.cols
        vals[r, slot] = A.vals
        return EllMatrix(vals=torch.from_numpy(vals).to(dtype),
                         cols=torch.from_numpy(cols), nrows=A.nrows,
                         ncols=A.ncols, nnz=A.nnz).to(device)

    def astype(self, dtype) -> "EllMatrix":
        return dataclasses.replace(self, vals=self.vals.to(dtype))

    def to(self, device) -> "EllMatrix":
        return dataclasses.replace(self, vals=self.vals.to(device),
                                   cols=self.cols.to(device))
