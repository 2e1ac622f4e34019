"""The plain reference: an f64 CSR matvec and the residual it judges by.

It imports nothing of the program under test and takes nothing the program
made: the matrix comes from the benchmark's own generator
(`solvebench/matrices/`), the vectors from the benchmark's traffic. The
matvec is y = A·X for a block of columns X (n, k), computed in float64
with plain PyTorch ops in blocks of rows, so that it runs on the card
after the window (or on the CPU in the tests) without holding more than
one block's gather at a time. Within a row the products are summed in
column order by one reduction over a fixed axis, so the result does not
depend on the run.
"""

from __future__ import annotations

import numpy as np
import torch

ROW_BLOCK = 1 << 15  # rows per block


class CsrReference:
    """A from its CSR arrays (host NumPy), padded per row to the widest
    row (padding: value 0, column 0)."""

    def __init__(self, offs: np.ndarray, cols: np.ndarray, vals: np.ndarray):
        self.n = offs.size - 1
        self.nnz = int(offs[-1])
        lens = np.diff(offs)
        self.width = int(lens.max())
        slot = np.arange(self.width)
        mask = slot[None, :] < lens[:, None]
        self.cols = np.zeros((self.n, self.width), dtype=np.int64)
        self.vals = np.zeros((self.n, self.width), dtype=np.float64)
        self.cols[mask] = cols
        self.vals[mask] = vals

    def matvec(self, X: torch.Tensor) -> torch.Tensor:
        """f64 Y = A·X for X of shape (n,) or (n, k), on X's device."""
        one = X.dim() == 1
        X = (X[:, None] if one else X).to(torch.float64)
        Y = torch.empty_like(X)
        for r0 in range(0, self.n, ROW_BLOCK):
            r1 = min(r0 + ROW_BLOCK, self.n)
            c = torch.from_numpy(self.cols[r0:r1]).to(X.device)
            v = torch.from_numpy(self.vals[r0:r1]).to(X.device)
            Y[r0:r1] = (v[:, :, None] * X[c]).sum(dim=1)
        return Y[:, 0] if one else Y


def relres(ref: CsrReference, X: torch.Tensor, B: torch.Tensor) -> np.ndarray:
    """‖b − A·x‖ / ‖b‖ of each column, in float64."""
    X = X if X.dim() == 2 else X[:, None]
    B = B if B.dim() == 2 else B[:, None]
    R = B.to(torch.float64) - ref.matvec(X)
    rn = torch.linalg.vector_norm(R, dim=0)
    bn = torch.linalg.vector_norm(B.to(torch.float64), dim=0)
    return (rn / bn).cpu().numpy()
