"""Mixed-precision iterative refinement (counterpart of
`lsbench_tpu/solvers/refine.py`): f64 accuracy at f32 iteration cost.

Inner Krylov solve in f32 on the f32 BSR SpMV kernel; once per refinement
pass, the f64 residual r = b − A·x on the f64-accurate BSR kernel. Each pass
gains ~6 digits, so 2–4 passes reach the reference's direct-solve tolerance
1e-10. The port takes the JAX package's TPU branch on every device, so both
packages run the same layouts: with a uniform inner BsrMatrix the residual
shares its hi blocks (`spmv_bsr_df64_lo`), otherwise (class-padded inner
layout) it streams a full BsrDf64.

`gmres_ir` and `bicgstab_ir` are ROADMAP Queue 1 items.
"""

from __future__ import annotations

import time

import torch

from lsbench_tpu_torch.matrix.bsr import BsrDf64, BsrMatrix
from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ops.spmv_bsr import spmv_bsr_df64, spmv_bsr_df64_lo
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu_torch.solvers.cg import (build_matvec, cg_loop, permutation,
                                          resolve_layout)
from lsbench_tpu_torch.solvers.preconditioners import get_preconditioner


class KrylovIrSolver(Solver):
    """f32 inner Krylov solve + f64 residual refinement.

    Subclasses provide `_inner_loop(mv32, pc, rhs32) -> (d32, iters)`: an
    f32 solve of A d ≈ rhs32 to `inner_rtol`.
    """

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

        t0 = time.perf_counter()
        Ap, self._perm, self._inv = permutation(ordering, A, self.device)
        self.setup_breakdown["ordering_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        apply32, self._op = build_matvec(Ap, self.layout, self.device)
        self._mv = lambda v: apply32(self._op, v)
        op64 = BsrDf64.from_csr(Ap, device="cpu")
        if (isinstance(self._op, BsrMatrix)
                and self._op.blocks.shape == op64.blocks_hi.shape
                and torch.equal(self._op.block_cols.cpu(), op64.block_cols)):
            # The hi array equals the f32 operator's blocks bit for bit, so
            # only the lo array goes to the device.
            lo = op64.blocks_lo.to(self.device)
            self._resid_mv = lambda x: spmv_bsr_df64_lo(self._op, lo, x)
        else:
            op64 = op64.to(self.device)
            self._resid_mv = lambda x: spmv_bsr_df64(op64, x)
        self.setup_breakdown["layout_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        pstate, papply = get_preconditioner(precond)(
            Ap, torch.float32, self.device, **(precond_params or {}))
        self._pc = lambda r: papply(pstate, r)
        self.setup_breakdown["precond_s"] = time.perf_counter() - t0

    def _inner_loop(self, mv32, pc, rhs32):
        raise NotImplementedError

    def solve(self, b) -> SolveResult:
        b = torch.as_tensor(b, device=self.device).to(torch.float64)
        bp = b if self._perm is None else b[self._perm]
        bnorm = torch.sqrt(torch.dot(bp, bp))
        tol2 = (self.rtol * bnorm) ** 2

        x = torch.zeros_like(bp)
        r = bp
        rr = torch.dot(bp, bp)
        iters = passes = 0
        while passes < self.max_refine and bool(rr > tol2):
            # Scale for f32 range safety, solve A d ≈ r in f32; only the
            # residual and the x update stay f64. The f64 residual is
            # carried: one f64 SpMV per pass.
            scale = torch.sqrt(rr)
            safe = torch.where(scale > 0, scale, 1.0)
            rhs32 = r.to(torch.float32) * (1.0 / safe).to(torch.float32)
            d32, inner_iters = self._inner_loop(self._mv, self._pc, rhs32)
            # A non-finite correction (inner breakdown) must not poison x:
            # drop it and let the pass cap end the loop.
            d32 = torch.where(torch.isfinite(d32), d32, 0.0)
            x = x + (d32 * safe.to(torch.float32)).to(torch.float64)
            r = bp - self._resid_mv(x)
            rr = torch.dot(r, r)
            iters += inner_iters
            passes += 1
        if self._inv is not None:
            x = x[self._inv]
        rnorm, bnorm = float(torch.sqrt(rr)), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        return SolveResult(x=x, iters=iters, relres=relres,
                           converged=relres <= self.rtol or bnorm == 0.0,
                           extra={"refine_passes": passes})


@register_solver("cg_ir")
class CgIrSolver(KrylovIrSolver):
    """f32 CG inner solve + f64 residual refinement (SPD systems)."""

    def _inner_loop(self, mv32, pc, rhs32):
        d32, inner_iters, _, _ = cg_loop(
            mv32, pc, rhs32, self.inner_rtol, self.maxiter, torch.float32)
        return d32, inner_iters
