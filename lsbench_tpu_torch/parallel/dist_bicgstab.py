"""Distributed BiCGSTAB over the row partition — the Ginkgo role, sharded
(counterpart of `lsbench_tpu/parallel/dist_bicgstab.py`).

Same recurrence as the single-device solver (implicit-residual stop at
rtol × initial, ginkgo.cpp:55-64) with the `dist_cg.py` distribution:
Jacobi preconditioner, the halo-exchange SpMV, and the scalar reductions
fused — one all_reduce each for rho, r0·v, (t·t, t·s) and the new ‖r‖².

One addition of the port's, as in its single-device recurrence
(`solvers/bicgstab.py`): a shadow restart. When |rho| ≤ eps·‖r̂0‖‖r‖ (eps of
the loop's dtype) the loop restarts from its current residual: r̂0 = r,
p = r. The test reads only reduced values (rho and ‖r‖²), so all ranks
restart together; it is applied on the device with `torch.where`, no host
read. In f32 it keeps the recurrence alive where rho sinks to rounding
noise on large systems; in f64 it fires only near an exact breakdown,
where the JAX loop stops or stalls instead.
"""

from __future__ import annotations

import time

import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.parallel.dist_cg import local_inv_diag
from lsbench_tpu_torch.parallel.dist_spmv import (RowPartitioned,
                                                  RowShard, fused_psum)
from lsbench_tpu_torch.parallel.mesh import RowMesh
from lsbench_tpu_torch.parallel.perm import resolve_dist_ordering
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, true_relres
from lsbench_tpu_torch.solvers.cg import as_dtype


def dist_bicgstab_loop(mesh: RowMesh, matvec, papply, b_l, rtol, maxiter,
                       guarded: bool = False):
    """Preconditioned BiCGSTAB on this rank's rows, in b_l's dtype, with
    the shadow restart. `guarded` adds the JAX inner loop's breakdown
    guards (a zero rho·omega or r̂0·v gives a zero step instead of an inf;
    the f32 inner solve of `DistributedBicgstabIr`). Returns (x_l, iters,
    rr, r0n2), the reduced ‖r‖² and ‖b‖²."""
    r0 = b_l  # the shadow residual r̂0
    (r0n2,) = fused_psum(mesh, torch.dot(r0, r0))
    tol2 = (rtol ** 2) * r0n2
    eps = torch.finfo(b_l.dtype).eps
    one = torch.ones((), dtype=b_l.dtype, device=b_l.device)
    x, r = torch.zeros_like(b_l), b_l
    p, v = torch.zeros_like(b_l), torch.zeros_like(b_l)
    rho = alpha = omega = one
    rr, r0n = r0n2, torch.sqrt(r0n2)
    it = 0
    while it < maxiter and bool(rr > tol2):
        (rho_new,) = fused_psum(mesh, torch.dot(r0, r))
        restart = rho_new.abs() <= eps * r0n * torch.sqrt(rr)
        r0 = torch.where(restart, r, r0)
        r0n = torch.where(restart, torch.sqrt(rr), r0n)
        rho_new = torch.where(restart, rr, rho_new)
        ratio = (rho_new / rho) * (alpha / omega)
        if guarded:
            ratio = torch.where(rho * omega != 0, ratio, 0.0)
        beta = torch.where(restart, 0.0, ratio)
        p = r + beta * (p - omega * v)
        ph = papply(p)
        v = matvec(ph)
        (r0v,) = fused_psum(mesh, torch.dot(r0, v))
        alpha = rho_new / r0v
        if guarded:
            alpha = torch.where(r0v != 0, alpha, 0.0)
        s = r - alpha * v
        sh = papply(s)
        t = matvec(sh)
        tt, ts = fused_psum(mesh, torch.dot(t, t), torch.dot(t, s))
        omega = torch.where(tt > 0, ts / tt, torch.zeros_like(tt))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        (rr,) = fused_psum(mesh, torch.dot(r, r))
        rho = rho_new
        it += 1
    return x, it, rr, r0n2


class DistributedBicgstab(RowPartitioned, Solver):
    """Jacobi-preconditioned BiCGSTAB over the row partition, in `dtype`
    (f64 by default: the JAX CLI's `ginkgo`/`bicgstab --devices N`)."""

    name = "dist_bicgstab"

    def __init__(self, A: CsrMatrix, mesh: RowMesh, dtype=torch.float64,
                 rtol=1e-4, maxiter=None, strategy="auto",
                 row_align: int = 8, local_spmv: str = "auto",
                 ordering: str = "none", **params):
        super().__init__(A, **params)
        t0 = time.perf_counter()
        A, self._ord = resolve_dist_ordering(A, ordering)
        self.setup_breakdown["ordering_s"] = time.perf_counter() - t0
        self.mesh = mesh
        self.dtype = as_dtype(dtype)
        self.rtol = float(rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))

        t0 = time.perf_counter()
        dm = self._matvec(A, self.dtype, strategy=strategy,
                          local_spmv=local_spmv, row_align=row_align)
        self.setup_breakdown["layout_s"] = time.perf_counter() - t0
        self.strategy = dm.strategy
        self.local_spmv = dm.local_spmv
        self.plan = dm.plan
        self.n = A.nrows
        self.n_pad = dm.n_pad
        self._mv = dm.matvec
        self._rows = RowShard(mesh, self.n, dm.nloc, self._ord)
        self._inv_diag = local_inv_diag(A, self.n_pad, mesh, dm.nloc,
                                        self.dtype)

    def _run(self, b):
        inv_diag = self._inv_diag
        return dist_bicgstab_loop(self.mesh, self._mv,
                                  lambda r: inv_diag * r,
                                  self._rows.local(b, self.dtype), self.rtol,
                                  self.maxiter)

    def solve(self, b) -> SolveResult:
        x_l, iters, rr, r0n2 = self._run(b)
        rnorm, bnorm = float(torch.sqrt(rr)), float(torch.sqrt(r0n2))
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        x = self._rows.gather(x_l)
        true_rel = true_relres(self.A, x, b)
        return SolveResult(x=x, iters=iters, relres=relres,
                           converged=true_rel <= self.rtol or bnorm == 0.0,
                           extra={**self._layout_extra(halo=False),
                                  "true_relres": true_rel})

    def solve_fn(self):
        return lambda b: self._run(b)[0]
