"""Gather SpMV over the padded-row (ELL) layout (counterpart of
`lsbench_tpu/ops/spmv.py`).

The JAX package leaves these to XLA: no Pallas kernel stands behind them, so
their port is plain torch ops (a gather, a multiply and a row sum) on
whatever device the operands lie, with no kernel of this package and no
launch counter.
"""

from __future__ import annotations

import torch

from lsbench_tpu_torch.matrix.ell import EllMatrix


def spmv_ell_padded(A: EllMatrix, x_pad: torch.Tensor) -> torch.Tensor:
    """y = A @ x keeping the padded row dimension: (n_pad,). Padding slots
    gather x[0] and carry val 0, so they add nothing."""
    xa = x_pad.to(A.vals.dtype)
    gathered = torch.index_select(xa, 0, A.cols.view(-1)).view_as(A.cols)
    return (A.vals * gathered).sum(dim=1)


def spmv_ell(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a padded-row (ELL) matrix: x (ncols,) → y (nrows,)."""
    if x.shape != (A.ncols,):
        raise ValueError(f"x: expected shape ({A.ncols},), got "
                         f"{tuple(x.shape)}")
    return spmv_ell_padded(A, x)[: A.nrows]
