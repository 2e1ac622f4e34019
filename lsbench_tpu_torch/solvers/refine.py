"""Mixed-precision iterative refinement (counterpart of
`lsbench_tpu/solvers/refine.py`): f64 accuracy at f32 iteration cost.

Inner Krylov solve in f32 on the f32 SpMV of the chosen layout (the
sliced-ELL `spmv_sell` where the JAX package takes its uniform or
class-padded BSR, K1 or K5); once per refinement pass, the f64
residual r = b − A·x on the sliced-ELL f64 product `spmv_sell_f64`, an
exact native-FP64 matvec where the TPU ran the double-float BSR kernel K2.
Each pass gains ~6 digits, so 2–4 passes reach the reference's direct-solve
tolerance 1e-10. The layout names and gates are the JAX package's TPU
branch on every device. Inner methods: CG (`cg_ir`), BiCGSTAB
(`bicgstab_ir`, what fp64 `bicgstab` delegates to) and restarted GMRES
(`gmres_ir`, what fp64 `gmres` delegates to).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.sell import SellMatrix
from lsbench_tpu_torch.ops.launches import host_read, span
from lsbench_tpu_torch.ops.spmv_sell import spmv_sell_f64
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu_torch.solvers.bicgstab import bicgstab_loop
from lsbench_tpu_torch.solvers.cg import (CgGraphs, build_matvec, cg_loop,
                                          permutation, resolve_layout,
                                          solving)
from lsbench_tpu_torch.solvers.gmres import gmres_loop, max_restarts_for
from lsbench_tpu_torch.solvers.preconditioners import build as build_precond


def f64_residual_matvec(Ap: CsrMatrix, op, device):
    """The f64 SpMV of the refinement residual: `spmv_sell_f64` (the
    redesigned K2) on Ap's sliced ELL. With a SellMatrix inner operator it
    shares that structure (`cols`, `slice_off`) and uploads only the f64
    values; otherwise it builds its own."""
    if isinstance(op, SellMatrix):
        op64 = op.with_f64(Ap)
    else:
        op64 = SellMatrix.from_csr(Ap, dtypes=(torch.float64,), device=device)
    return lambda x: spmv_sell_f64(op64, x)


def column_residual(mv, bp: torch.Tensor):
    """residual(X, cols) = bp − A·X on the listed columns, (n, len(cols)):
    one `mv` launch per column."""
    def residual(X, cols):
        return torch.stack([bp[:, j] - mv(X[:, j].contiguous())
                            for j in cols], dim=1)
    return residual


def refine_columns(bp: torch.Tensor, correct, residual, rtol: float,
                   max_refine: int, x: torch.Tensor | None = None,
                   unit_f32: bool = True):
    """Iterative refinement of x for A·x = bp, (n, k), with the stop rule
    of the JAX package's (vmapped) while-loop per column: a column takes
    another pass while passes < max_refine, rr > rtol²·‖b‖² and rr still
    falls; a finished column keeps its iterate and is left out of later
    residuals. `correct(r)` returns the correction for residual r;
    `residual(X, cols)` returns bp − A·X on those columns. With `unit_f32`
    each correction is computed in f32 on the residual scaled to unit norm
    per column, while x and the residual stay in bp's dtype (f64). x is
    the starting iterate (zero if None). Returns (x, passes per column,
    rr, ‖b‖² per column)."""
    k = bp.shape[1]
    bb = torch.sum(bp * bp, dim=0)
    tol2 = (rtol ** 2) * bb
    if x is None:
        x, r, rr = torch.zeros_like(bp), bp, bb
    else:
        r = residual(x, range(k))
        rr = torch.sum(r * r, dim=0)
    rr_prev = torch.full_like(rr, float("inf"))
    passes = np.zeros(k, dtype=np.int64)
    for _ in range(max_refine):
        active = (rr > tol2) & (rr < rr_prev)
        live = torch.nonzero(active).flatten().tolist()
        if not live:
            break
        if unit_f32:
            scale = torch.sqrt(rr)
            safe = torch.where(scale > 0, scale, 1.0)
            r32 = r.float() * (1.0 / safe).float()[None, :]
            d = (correct(r32) * safe.float()[None, :]).to(bp.dtype)
        else:
            d = correct(r)
        x = torch.where(active[None, :], x + d, x)
        r = r.clone()
        r[:, live] = residual(x, live)
        rr_prev = torch.where(active, rr, rr_prev)
        rr = torch.where(active, torch.sum(r * r, dim=0), rr)
        passes[live] += 1
    return x, passes, rr, bb


class KrylovIrSolver(Solver):
    """f32 inner Krylov solve + f64 residual refinement.

    Subclasses provide `_inner_loop(mv32, pc, rhs32) -> (d32, iters)`: an
    f32 solve of A d ≈ rhs32 to `inner_rtol`. One whose inner loop is
    `cg_loop` holds the loop's `_graphs` (`CgGraphs`), and its set-up and
    each solve run in their `solving`.
    """

    _graphs: CgGraphs | None = None

    def __init__(self, A: CsrMatrix, rtol=1e-10, inner_rtol=1e-5,
                 maxiter=None, max_refine=6, precond="jacobi",
                 layout="auto", ordering="none", dtype=None,
                 precond_params=None, device="cuda", **params):
        super().__init__(A, **params)
        del dtype  # precision structure is fixed: f32 inner / f64 outer
        self.device = torch.device(device)
        self.rtol = float(rtol)
        self.inner_rtol = float(inner_rtol)
        self.maxiter = int(maxiter) if maxiter is not None else max(10 * A.nrows, 1000)
        self.max_refine = int(max_refine)
        self.layout = resolve_layout(layout, torch.float32)

        with solving(self._graphs, self.device):
            t0 = time.perf_counter()
            Ap, self._perm, self._inv = permutation(ordering, A, self.device)
            self.setup_breakdown["ordering_s"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            apply32, self._op = build_matvec(Ap, self.layout, self.device)
            self._mv = lambda v: apply32(self._op, v)
            self.stream_bytes = getattr(self._op, "bytes_streamed", None)
            self._resid_mv = f64_residual_matvec(Ap, self._op, self.device)
            self.setup_breakdown["layout_s"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            self._pstate, papply = build_precond(
                precond, Ap, torch.float32, self.device, precond_params,
                self.setup_breakdown)
            self._pc = lambda r: papply(self._pstate, r)
            self.setup_breakdown["precond_s"] = time.perf_counter() - t0

    def _inner_loop(self, mv32, pc, rhs32):
        raise NotImplementedError

    def solve(self, b) -> SolveResult:
        b = torch.as_tensor(b, device=self.device).to(torch.float64)
        with solving(self._graphs, self.device) as keep:
            bp = b if self._perm is None else b[self._perm]
            bnorm = torch.sqrt(torch.dot(bp, bp))
            tol2 = (self.rtol * bnorm) ** 2

            x = torch.zeros_like(bp)
            r = bp
            rr = torch.dot(bp, bp)
            iters = passes = 0
            while passes < self.max_refine and host_read(rr > tol2):
                with span("lsbench.ir.pass"):
                    # Scale for f32 range safety, solve A d ≈ r in f32;
                    # only the residual and the x update stay f64. The f64
                    # residual is carried: one f64 SpMV per pass.
                    scale = torch.sqrt(rr)
                    safe = torch.where(scale > 0, scale, 1.0)
                    rhs32 = (r.to(torch.float32)
                             * (1.0 / safe).to(torch.float32))
                    d32, inner_iters = self._inner_loop(self._mv, self._pc,
                                                        rhs32)
                    # A non-finite correction (inner breakdown) must not
                    # poison x: drop it and let the pass cap end the loop.
                    d32 = torch.where(torch.isfinite(d32), d32, 0.0)
                    x = x + (d32 * safe.to(torch.float32)).to(torch.float64)
                    r = bp - self._resid_mv(x)
                    rr = torch.dot(r, r)
                iters += inner_iters
                passes += 1
            if self._inv is not None:
                x = x[self._inv]
            x = keep(x)
            rnorm, bnorm = host_read(torch.sqrt(rr)), host_read(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        return SolveResult(x=x, iters=iters, relres=relres,
                           converged=relres <= self.rtol or bnorm == 0.0,
                           extra={"refine_passes": passes})


@register_solver("cg_ir")
class CgIrSolver(KrylovIrSolver):
    """f32 CG inner solve + f64 residual refinement (SPD systems)."""

    def __init__(self, A: CsrMatrix, **params):
        self._graphs = CgGraphs()
        super().__init__(A, **params)

    def _inner_loop(self, mv32, pc, rhs32):
        d32, inner_iters, _, _ = cg_loop(
            mv32, pc, rhs32, self.inner_rtol, self.maxiter, torch.float32,
            graphs=self._graphs)
        return d32, inner_iters


@register_solver("gmres_ir")
class GmresIrSolver(KrylovIrSolver):
    """f32 restarted-GMRES inner solve + f64 residual refinement: the f32
    Arnoldi loop on the f32 SpMV, f64 accuracy from the outer residual."""

    def __init__(self, A: CsrMatrix, restart=30, max_restarts=None,
                 maxiter=None, **params):
        self.restart = int(restart)
        self.max_restarts = (int(max_restarts) if max_restarts is not None
                             else max_restarts_for(A, maxiter, self.restart))
        super().__init__(A, maxiter=maxiter, **params)

    def _inner_loop(self, mv32, pc, rhs32):
        d32, inner_iters, _, _ = gmres_loop(
            mv32, pc, rhs32, self.inner_rtol, self.max_restarts,
            self.restart, torch.float32)
        return d32, inner_iters


@register_solver("bicgstab_ir")
class BicgstabIrSolver(KrylovIrSolver):
    """f32 BiCGSTAB inner solve + f64 residual refinement."""

    def _inner_loop(self, mv32, pc, rhs32):
        d32, inner_iters, _, _ = bicgstab_loop(
            mv32, pc, rhs32, self.inner_rtol, self.maxiter, torch.float32)
        return d32, inner_iters
