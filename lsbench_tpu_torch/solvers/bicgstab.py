"""Preconditioned BiCGSTAB — the Ginkgo-backend role (counterpart of
`lsbench_tpu/solvers/bicgstab.py` and of the recurrence in
`lsbench_tpu/solvers/batched_bicgstab.py`).

The reference's Ginkgo path solves with Bicgstab<double> + Jacobi, stopping
on the implicit residual norm ≤ 1e-4 × the initial residual
(ginkgo.cpp:55-64). `batched_bicgstab_loop` is the one recurrence of the
port: k independent columns, each with its own scalars, every matvec one
SpMM; `bicgstab_loop` runs it on a single column. It keeps the JAX
package's stop rule, its breakdown guards (the guarded divisions, the stall
test) and its keep-the-previous-iterate rule, written as a Python loop whose
stop test reads the device once per iteration, as `cg_loop` does.

One addition of the port's: a shadow restart. In f32 on large systems the
shadow dot rho = (r̂0, r) sinks to rounding noise within a few hundred
iterations; from there the JAX recurrence diverges before a value turns
non-finite, from every right-hand side of RCM poisson_2d(512) (n=262k).
When |rho| ≤ eps·‖r̂0‖‖r‖ (eps of the loop's dtype) a column restarts
from its current residual: r̂0 = r, p = r.
In f64 the test fires only at an exact breakdown (rho = 0), where the JAX
loop stops instead.

At fp64 the solver takes the JAX package's TPU branch on every device: it
delegates to `bicgstab_ir` (f32 BiCGSTAB on the f32 SpMV + f64 residual
refinement on the sliced-ELL f64 product), reported as `fp32_ir_auto`. At
fp32 it runs `bicgstab_loop` on the sliced-ELL f32 kernel directly.
"""

from __future__ import annotations

import sys

import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ops.launches import host_read
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu_torch.solvers.cg import CgSolver, as_dtype


def _cdots(u, v):
    """Per-column dot products: (n,k),(n,k) -> (k,)."""
    return (u * v).sum(dim=0)


def _safe_div(num, den):
    """num / den where den != 0, else 0 (elementwise)."""
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def batched_bicgstab_loop(matmat, pc_cols, B, rtol, maxiter, dtype):
    """k independent preconditioned BiCGSTAB recurrences, one SpMM per
    half-step. Returns (X, iters, rnorm (k,), r0norm (k,)); a column stops
    when ‖r‖ ≤ rtol·‖r0‖ (x0 = 0, r0 = b, Ginkgo's initial_resnorm
    baseline).

    The recurrences divide by rho, omega and (r̂0, v); in f32 any of them
    can underflow near convergence or on hard systems. The divisions are
    guarded, and a column whose step still breaks down (non-finite
    residual, rho = 0 before convergence, a stall with alpha = omega = 0)
    keeps its previous iterate and freezes while the others go on."""
    B = B.to(dtype)
    k = B.shape[1]
    rr0 = _cdots(B, B)
    tol2 = (rtol ** 2) * rr0
    eps = torch.finfo(dtype).eps
    one = torch.ones((k,), dtype=dtype, device=B.device)

    X, R = torch.zeros_like(B), B
    R0, r0n = B, torch.sqrt(rr0)             # shadow residual and its norm
    Pv, V = torch.zeros_like(B), torch.zeros_like(B)
    rho = alpha = omega = one
    rr = rr0
    brk = torch.zeros((k,), dtype=torch.bool, device=B.device)
    it = 0
    while it < maxiter and host_read(((rr > tol2) & ~brk).any()):
        active = (rr > tol2) & ~brk
        rho_new = _cdots(R0, R)
        # Shadow restart (see the module docstring): r̂0 = r, p = r.
        restart = active & (rho_new.abs() <= eps * r0n * torch.sqrt(rr))
        R0 = torch.where(restart[None, :], R, R0)
        r0n = torch.where(restart, torch.sqrt(rr), r0n)
        rho_new = torch.where(restart, rr, rho_new)
        beta = torch.where(restart, 0.0,
                           _safe_div(rho_new * alpha, rho * omega))
        P_n = R + beta[None, :] * (Pv - omega[None, :] * V)
        Ph = pc_cols(P_n)
        V_n = matmat(Ph)
        alpha_n = _safe_div(rho_new, _cdots(R0, V_n))
        Sv = R - alpha_n[None, :] * V_n
        Sh = pc_cols(Sv)
        T = matmat(Sh)
        tt = _cdots(T, T)
        omega_n = torch.where(tt > 0,
                              _cdots(T, Sv) / torch.where(tt > 0, tt, 1.0),
                              torch.zeros_like(tt))
        X_n = X + alpha_n[None, :] * Ph + omega_n[None, :] * Sh
        R_n = Sv - omega_n[None, :] * T
        rr_new = _cdots(R_n, R_n)
        stalled = (alpha_n == 0) & (omega_n == 0)
        good = (torch.isfinite(rr_new) & ((rho_new != 0) | (rr <= tol2))
                & ~stalled)
        take = active & good                 # (k,) columns that step
        X, R, Pv, V = (torch.where(take[None, :], a, b_) for a, b_ in
                       ((X_n, X), (R_n, R), (P_n, Pv), (V_n, V)))
        rho, alpha, omega, rr = (torch.where(take, a, b_) for a, b_ in
                                 ((rho_new, rho), (alpha_n, alpha),
                                  (omega_n, omega), (rr_new, rr)))
        brk = brk | (active & ~good)
        it += 1
    return X, it, torch.sqrt(rr), torch.sqrt(rr0)


def bicgstab_loop(matvec, precond_apply, b, rtol, maxiter, dtype):
    """Preconditioned BiCGSTAB on one right-hand side: `batched_bicgstab_loop`
    on the column b. Returns (x, iters, rnorm, r0norm)."""
    X, it, rnorm, r0norm = batched_bicgstab_loop(
        lambda V: matvec(V[:, 0])[:, None],
        lambda R: precond_apply(R[:, 0])[:, None],
        b.to(dtype)[:, None], rtol, maxiter, dtype)
    return X[:, 0], it, rnorm[0], r0norm[0]


@register_solver("bicgstab")
class BicgstabSolver(CgSolver):
    """Jacobi-preconditioned BiCGSTAB (nonsymmetric systems). fp64 runs as
    `bicgstab_ir` (mode fp32_ir_auto); fp32 on the f32 BSR kernels."""

    _loop = staticmethod(bicgstab_loop)

    def __init__(self, A: CsrMatrix, dtype=torch.float64, precond="jacobi",
                 rtol=1e-4, maxiter=None, layout="auto", ordering="none",
                 precond_params=None, device="cuda", **params):
        self._delegate = None
        if as_dtype(dtype) == torch.float64:
            # The JAX package's TPU branch: f32 BiCGSTAB + f64 residual
            # refinement, stopping on the true f64 residual ≤ rtol·‖b‖ (a
            # stronger criterion than Ginkgo's implicit resnorm).
            Solver.__init__(self, A, **params)
            print("bicgstab: fp64 executes as f32 BiCGSTAB + f64 iterative "
                  "refinement (mode fp32_ir_auto).", file=sys.stderr)
            from lsbench_tpu_torch.solvers.refine import BicgstabIrSolver
            self._delegate = BicgstabIrSolver(
                A, rtol=rtol, maxiter=maxiter,
                inner_rtol=min(1e-5, float(rtol) * 0.1), precond=precond,
                layout=layout, ordering=ordering,
                precond_params=precond_params, device=device, **params)
            self.setup_breakdown = self._delegate.setup_breakdown
            return
        super().__init__(A, dtype=dtype, precond=precond, rtol=rtol,
                         maxiter=maxiter, layout=layout, ordering=ordering,
                         precond_params=precond_params, device=device,
                         **params)

    def solve(self, b) -> SolveResult:
        if self._delegate is None:
            return super().solve(b)
        res = self._delegate.solve(b)
        res.extra["precision_mode"] = "fp32_ir_auto"
        return res

    def matvec_op(self):
        if self._delegate is None:
            return super().matvec_op()
        return self._delegate.matvec_op()
