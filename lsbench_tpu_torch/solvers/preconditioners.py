"""Preconditioners for the Krylov solvers (counterpart of
`lsbench_tpu/solvers/preconditioners.py`).

A preconditioner is `(state, apply)` with `apply(state, r) -> z`: `none`
(identity), `jacobi`, `block_jacobi`, `chebyshev`, one AMG V-cycle (`amg`,
`amg_classical`, `solvers/amg.py`) and IC(0) (`ic0`, `solvers/ic0.py`),
the JAX package's whole set. A solver calls `check(state)` once per
solve: it raises if the preconditioner's kernel reported a fault on the
card (IC(0)'s triangular sweeps).
"""

from __future__ import annotations

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.utils.precision import full_f32


def identity_precond(A: CsrMatrix, dtype, device, **_):
    del A, dtype, device
    return None, lambda state, r: r


def jacobi_precond(A: CsrMatrix, dtype, device, **_):
    """z = D^{-1} r. Safe for zero diagonals (identity rows there)."""
    d = A.diagonal()
    inv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 1.0)
    inv_dev = torch.as_tensor(inv, dtype=dtype, device=device)
    return inv_dev, lambda inv_dev, r: inv_dev * r


def block_jacobi_precond(A: CsrMatrix, dtype, device, block_size: int = 32):
    """z = blockdiag(A)⁻¹ r with dense diagonal blocks of `block_size`,
    taken in the solver's current ordering (identity rows pad the last
    block). The blocks are extracted and inverted in f64 on the host once,
    then uploaded in `dtype`; the apply is one batched (nb, k, k) × (nb, k)
    product on the device, in full f32 for f32 (the JAX package computes it
    outside any Pallas kernel)."""
    n = A.nrows
    k = block_size
    nb = -(-n // k)
    blocks = np.zeros((nb, k, k), dtype=np.float64)
    blocks[:, np.arange(k), np.arange(k)] = 1.0  # identity in padding
    r, c, v = A.to_coo()
    same = (r // k) == (c // k)
    rb, cb, vb = r[same], c[same], v[same]
    blocks[rb // k, rb % k, cb % k] = vb
    inv_blocks = torch.as_tensor(np.linalg.inv(blocks), dtype=dtype,
                                 device=device)

    def apply(inv_blocks, r_vec):
        rp = torch.zeros(nb * k, dtype=inv_blocks.dtype, device=r_vec.device)
        rp[:n] = r_vec
        with full_f32():
            z = torch.bmm(inv_blocks, rp.view(nb, k, 1))
        return z.view(-1)[:n].to(r_vec.dtype)

    return inv_blocks, apply


def chebyshev_precond(A: CsrMatrix, dtype, device, degree: int = 4,
                      lower: float = 0.30, **_):
    """Fixed-degree Chebyshev polynomial approximation of A⁻¹ on
    [lower·ρ, 1.1·ρ] of D⁻¹A, ρ from the host power iteration. The apply
    is degree − 1 SpMVs plus vector ops, no dot products: the SpMV is
    `build_matvec(A, resolve_layout("auto", dtype))`, the SELL f32 kernel
    for f32 and the SELL f64 kernel for f64. A fixed polynomial is a fixed
    SPD operator, so CG theory holds exactly."""
    from lsbench_tpu_torch.solvers.amg import estimate_rho_dinv_a
    from lsbench_tpu_torch.solvers.cg import build_matvec, resolve_layout

    d = A.diagonal()
    dinv_np = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 1.0)
    rho = estimate_rho_dinv_a(A, dinv_np)
    lmax = 1.1 * rho
    lmin = lower * rho
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma = theta / delta

    apply_mv, op = build_matvec(A, resolve_layout("auto", dtype), device)
    state = (op, torch.as_tensor(dinv_np, dtype=dtype, device=device))
    deg = int(degree)

    def apply(state, r):
        op, dinv = state
        rho_k = 1.0 / sigma
        res = r
        dvec = (dinv * res) / theta
        z = torch.zeros_like(r)
        for _ in range(deg - 1):
            z = z + dvec
            res = res - apply_mv(op, dvec).to(r.dtype)
            rho_k1 = 1.0 / (2.0 * sigma - rho_k)
            dvec = ((rho_k1 * rho_k) * dvec
                    + (2.0 * rho_k1 / delta) * (dinv * res))
            rho_k = rho_k1
        return z + dvec

    return state, apply


def _ic0_precond(A: CsrMatrix, dtype, device, **params):
    from lsbench_tpu_torch.solvers.ic0 import ic0_precond
    return ic0_precond(A, dtype, device, **params)


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
    "block_jacobi": block_jacobi_precond,
    "chebyshev": chebyshev_precond,
    "amg": _amg_precond,
    "amg_classical": _amg_classical_precond,
    "ic0": _ic0_precond,
}
# Names of the JAX package's preconditioners that are not ported yet: none.
NOT_PORTED = ()


def check(state) -> None:
    """Raise if the preconditioner's device work reported a fault: a state
    with a `check` method (IC(0)'s `TriPack`) reads its kernel's error word,
    one device sync. Solvers call this once per solve."""
    if hasattr(state, "check"):
        state.check()


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
