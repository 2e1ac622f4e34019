"""Restarted GMRES(m), the general nonsymmetric Krylov solver (counterpart
of `lsbench_tpu/solvers/gmres.py`).

`gmres_loop` is the JAX package's: right-preconditioned (the residual the
stop test sees is the true one), the Arnoldi basis a dense (m+1, n) matrix
orthogonalized by CGS2 (classical Gram-Schmidt, two passes: two basis
products per pass instead of j sequential dots), the (m+1, m) least-squares
problem solved once per restart cycle by QR and a triangular solve on the
device, and the restart loop's stop rule `restarts < max_restarts and
‖r‖ > rtol·‖b‖` on a residual recomputed from x. The m inner steps of a
cycle read nothing on the host; the stop test reads ‖r‖ once per cycle.

One addition of the port's: a stagnation stop. The loop also ends after a
cycle that did not lower the recomputed ‖r‖. In f32 that residual has a
floor of about eps₃₂·|A||x|, which lies above `gmres_ir`'s inner tolerance
1e-5 on Poisson systems from poisson_2d(64) up; there the JAX loop runs on
to `max_restarts` (87,382 cycles per refinement pass at n=262k), while the
port stops at the floor and the f64 residual refines from there
(`tests/test_torch_gmres.py` pins both on poisson_2d(64)). In f64 the stop
fires only where the residual stops falling.

At fp64 the solver takes the JAX package's TPU branch on every device, as
`bicgstab` does: it delegates to `gmres_ir` (f32 GMRES on the SELL f32
kernel + f64 residual refinement on `spmv_sell_f64`), reported as
`fp32_ir_auto`. At fp32 it runs `gmres_loop` on the SELL f32 kernel.
"""

from __future__ import annotations

import math
import sys

import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu_torch.solvers.cg import CgSolver, as_dtype
from lsbench_tpu_torch.utils.precision import full_f32

EPS_BREAK = 1e-30  # floor of a basis norm and of R's diagonal


def gmres_loop(matvec, precond_apply, b, rtol, max_restarts, m, dtype):
    """Restarted right-preconditioned GMRES(m). Returns (x, inner_iters,
    rnorm, bnorm), inner_iters = restarts · m; rnorm and bnorm are 0-d
    tensors of `dtype`."""
    b = b.to(dtype)
    n = b.shape[0]
    dev = b.device
    bnorm = torch.sqrt(torch.dot(b, b))
    tol = float(rtol * bnorm)  # in `dtype`, as the JAX loop compares

    def arnoldi_cycle(x):
        r = b - matvec(x)
        beta = torch.sqrt(torch.dot(r, r))
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        V[0] = r / torch.where(beta > 0, beta, 1.0)
        H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        for j in range(m):
            w = matvec(precond_apply(V[j]))
            # CGS2 against rows 0..j: the JAX package's masked (m+1, n)
            # products, taken over the rows the mask keeps (the others
            # are zero).
            Vj = V[: j + 1]
            with full_f32():
                h1 = Vj @ w
                w = w - Vj.T @ h1
                h2 = Vj @ w
                w = w - Vj.T @ h2
            hnext = torch.sqrt(torch.dot(w, w))
            V[j + 1] = w / torch.clamp(hnext, min=EPS_BREAK)
            H[: j + 1, j] = h1 + h2
            H[j + 1, j] = hnext
        # Least squares: min ‖beta e1 − H y‖.
        e1 = torch.zeros(m + 1, dtype=dtype, device=dev)
        e1[0] = beta
        with full_f32():
            q, rr = torch.linalg.qr(H, mode="reduced")
            rr = rr + EPS_BREAK * torch.eye(m, dtype=dtype, device=dev)
            y = torch.linalg.solve_triangular(rr, (q.T @ e1)[:, None],
                                              upper=True)[:, 0]
            u = V[:m].T @ y
        return x + precond_apply(u)

    x = torch.zeros_like(b)
    rnorm = bnorm
    rn, rn_prev = float(rnorm), float("inf")
    restarts = 0
    # The JAX package's stop rule, plus the port's stagnation stop: the
    # loop also ends after a cycle that did not lower ‖r‖ (module
    # docstring). One host read per cycle.
    while restarts < max_restarts and rn > tol and rn < rn_prev:
        rn_prev = rn
        x = arnoldi_cycle(x)
        r = b - matvec(x)
        rnorm = torch.sqrt(torch.dot(r, r))
        rn = float(rnorm)
        restarts += 1
    return x, restarts * m, rnorm, bnorm


def max_restarts_for(A: CsrMatrix, maxiter, restart: int) -> int:
    """The JAX package's cap: ceil(maxiter / restart) cycles, maxiter
    defaulting to max(10·n, 1000)."""
    cap = int(maxiter) if maxiter is not None else max(10 * A.nrows, 1000)
    return max(1, math.ceil(cap / restart))


@register_solver("gmres")
class GmresSolver(CgSolver):
    """Jacobi-preconditioned GMRES(restart). fp64 runs as `gmres_ir` (mode
    fp32_ir_auto); fp32 on the SELL f32 kernel."""

    def __init__(self, A: CsrMatrix, dtype=torch.float64, precond="jacobi",
                 rtol=1e-8, maxiter=None, restart=30, layout="auto",
                 ordering="none", precond_params=None, device="cuda",
                 **params):
        self.restart = int(restart)
        self.max_restarts = max_restarts_for(A, maxiter, self.restart)
        self._delegate = None
        if as_dtype(dtype) == torch.float64:
            # The JAX package's TPU branch: f32 Arnoldi + f64 residual
            # refinement (gmres.py:99), decided for every device.
            Solver.__init__(self, A, **params)
            print("gmres: fp64 executes as f32 Arnoldi + f64 iterative "
                  "refinement (mode fp32_ir_auto).", file=sys.stderr)
            from lsbench_tpu_torch.solvers.refine import GmresIrSolver
            self._delegate = GmresIrSolver(
                A, rtol=rtol, maxiter=maxiter, restart=self.restart,
                precond=precond, layout=layout, ordering=ordering,
                precond_params=precond_params, device=device, **params)
            self.setup_breakdown = self._delegate.setup_breakdown
            return
        super().__init__(A, dtype=dtype, precond=precond, rtol=rtol,
                         maxiter=maxiter, layout=layout, ordering=ordering,
                         precond_params=precond_params, device=device,
                         **params)

    def _loop(self, mv, pc, b, rtol, maxiter, dtype):
        del maxiter  # the cap is max_restarts cycles of `restart` steps
        return gmres_loop(mv, pc, b, rtol, self.max_restarts, self.restart,
                          dtype)

    def solve(self, b) -> SolveResult:
        if self._delegate is None:
            return super().solve(b)
        res = self._delegate.solve(b)
        res.extra["precision_mode"] = "fp32_ir_auto"
        return res
