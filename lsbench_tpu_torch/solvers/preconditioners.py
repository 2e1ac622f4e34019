"""Preconditioners for the Krylov solvers (counterpart of
`lsbench_tpu/solvers/preconditioners.py`).

A preconditioner is `(state, apply)` with `apply(state, r) -> z`. The slice
ports `none` (identity) and `jacobi`; the others (block_jacobi, ic0,
chebyshev, amg, amg_classical) are ROADMAP Queue 1 items and raise
NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix


def identity_precond(A: CsrMatrix, dtype, device, **_):
    del A, dtype, device
    return None, lambda state, r: r


def jacobi_precond(A: CsrMatrix, dtype, device, **_):
    """z = D^{-1} r. Safe for zero diagonals (identity rows there)."""
    d = A.diagonal()
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 1.0)
    inv_dev = torch.as_tensor(inv, dtype=dtype, device=device)
    return inv_dev, lambda inv_dev, r: inv_dev * r


PRECONDITIONERS = {
    "none": identity_precond,
    "jacobi": jacobi_precond,
}
NOT_PORTED = ("block_jacobi", "ic0", "chebyshev", "amg", "amg_classical")


def get_preconditioner(name: str):
    key = name.lower()
    if key in PRECONDITIONERS:
        return PRECONDITIONERS[key]
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"preconditioner '{name}' is not yet ported to lsbench_tpu_torch "
            "(ROADMAP.md Queue 1)")
    raise KeyError(
        f"unknown preconditioner '{name}'. Available: {sorted(PRECONDITIONERS)}")
