"""Preconditioners for the Krylov solvers (counterpart of
`lsbench_tpu/solvers/preconditioners.py`).

A preconditioner is `(state, apply)` with `apply(state, r) -> z`. Ported:
`none` (identity), `jacobi`, and one AMG V-cycle (`amg`, `amg_classical`,
`solvers/amg.py`); block_jacobi, ic0 and chebyshev are ROADMAP Queue 1
items and raise NotImplementedError.
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


def _amg_precond(A: CsrMatrix, dtype, device, **amg_params):
    from lsbench_tpu_torch.solvers.amg import amg_precond
    return amg_precond(A, dtype, device, **amg_params)


# Defaults of `amg_classical`, the JAX package's: classical AMG (PMIS) with
# direct interpolation improved by 3 damped (ω=0.5) Jacobi passes toward the
# ideal -A_FF⁻¹A_FC, truncated to 8 entries per row, θ=0.5.
AMG_CLASSICAL = dict(coarsening="classical", theta=0.5, interp="jacobi",
                     interp_passes=3, interp_omega=0.5, pmax=8)


def _amg_classical_precond(A: CsrMatrix, dtype, device, **amg_params):
    """Classical-AMG V-cycle — the Hypre/AmgX-family preconditioner."""
    return _amg_precond(A, dtype, device, **{**AMG_CLASSICAL, **amg_params})


PRECONDITIONERS = {
    "none": identity_precond,
    "jacobi": jacobi_precond,
    "amg": _amg_precond,
    "amg_classical": _amg_classical_precond,
}
NOT_PORTED = ("block_jacobi", "ic0", "chebyshev")


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
