"""Batched multi-RHS BiCGSTAB — `--nrhs k` for the Ginkgo role (counterpart
of `lsbench_tpu/solvers/batched_bicgstab.py`).

k right-hand sides are k independent BiCGSTAB recurrences: each column
carries its own scalars (rho, alpha, omega) as (k,) vectors while every
matvec is one SpMM (`spmm_sell`, the redesigned K3) over the shared
sliced-ELL stream. The recurrence,
its guards and its shadow restart live in `bicgstab.batched_bicgstab_loop`,
shared with the one-RHS `bicgstab_loop`: a broken or stalled column freezes
while the others go on. The refinement structure (f32 inner, f64 residual
per pass, worst-column report) is block_cg's.
"""

from __future__ import annotations

import time

import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.solvers.base import register_solver
from lsbench_tpu_torch.solvers.bicgstab import batched_bicgstab_loop
from lsbench_tpu_torch.solvers.block_cg import (MultiRhsIrSolver,
                                                column_precond)
from lsbench_tpu_torch.solvers.preconditioners import build as build_precond


@register_solver("batched_bicgstab")
class BatchedBicgstabSolver(MultiRhsIrSolver):
    """f32 batched BiCGSTAB inner + f64 residual refinement per column (the
    `--solver bicgstab/ginkgo --nrhs k` route)."""

    def __init__(self, A: CsrMatrix, rtol=1e-4, inner_rtol=1e-5,
                 maxiter=None, max_refine=6, precond="jacobi",
                 layout="auto", ordering="none", dtype=None,
                 precond_params=None, device="cuda", **params):
        del dtype, layout  # fixed structure: f32 SpMM inner / f64 outer
        super().__init__(A, rtol, min(float(inner_rtol), float(rtol) * 0.1),
                         maxiter, max_refine, ordering, device, **params)
        t0 = time.perf_counter()
        self._pstate, papply = build_precond(
            precond, self._Ap, torch.float32, self.device, precond_params,
            self.setup_breakdown)
        self._pc_cols = column_precond(precond, self._pstate, papply)
        self.setup_breakdown["precond_s"] = time.perf_counter() - t0

    def _inner_loop(self, R32):
        D32, iters, _, _ = batched_bicgstab_loop(
            self._mm, self._pc_cols, R32, self.inner_rtol, self.maxiter,
            torch.float32)
        return D32, iters
