"""Distributed mixed-precision Krylov: f32 inner solves + f64 refinement
(counterpart of the 1-D part of `lsbench_tpu/parallel/dist_cg_ir.py`).

The distributed twin of `solvers/refine.py::KrylovIrSolver`:

- the inner Krylov method iterates entirely in f32 on the halo-exchange
  SELL f32 kernel (`parallel/dist_spmv.py`), with fused all_reduces;
- once per refinement pass, the f64 residual r = b − A·x is computed with
  the SELL f64 kernel (native FP64, where the TPU ran the double-float
  BSR kernel) and reduced with one more all_reduce;
- each pass gains ~6 digits; 2–4 passes reach the reference's direct
  tolerance 1e-10 (cusparse.c:184) at f32 per-iteration cost.

The inner method is pluggable: CG for SPD systems (`DistributedCgIr`),
BiCGSTAB (`DistributedBicgstabIr`, the Ginkgo role with fp64 semantics)
and restarted GMRES (`DistributedGmresIr`) for nonsymmetric ones. The
BiCGSTAB inner loop carries the port's shadow restart and the GMRES inner
loop its stagnation stop (`dist_bicgstab.py`, `dist_gmres.py`). The JAX
package runs the outer and inner loops as one `shard_map` program; here
each stop test reads one reduced scalar on the host.

The 2-D partition's classes (`DistributedKrylovIr2d` and its three
subclasses, `--precision fp32_ir --mesh RxC`) are the same loops on the
grid's operators (`dist2d.On2dGrid`): the SELL f32 kernel between a
gather over the grid column and a reduce-scatter over the grid row for
the inner iteration, the SELL f64 kernel for the residual.
"""

from __future__ import annotations

import math
import time

import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.parallel.dist_bicgstab import dist_bicgstab_loop
from lsbench_tpu_torch.parallel.dist2d import On2dGrid
from lsbench_tpu_torch.parallel.dist_cg import dist_cg_loop, local_inv_diag
from lsbench_tpu_torch.parallel.dist_gmres import dist_gmres_loop
from lsbench_tpu_torch.parallel.dist_spmv import (RowPartitioned,
                                                  RowShard, fused_psum)
from lsbench_tpu_torch.parallel.mesh import RowMesh
from lsbench_tpu_torch.parallel.perm import resolve_dist_ordering
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, true_relres

# ----------------------------------------------------------- inner methods
# Each runs on this rank's rows: `mv` is the local halo-exchange f32
# matvec, `invd_l` the local Jacobi diagonal, `rhs_l` the local f32
# right-hand side. Stop on the recursive residual relative to ‖rhs‖ (the
# f64 outer loop owns the true-residual contract). Returns (local
# solution, iteration count).


def _cg_inner(mesh, mv, invd_l, rhs_l, inner_rtol, maxiter):
    """f32 Jacobi-CG of A d = rhs to inner_rtol (fused all_reduces)."""
    x, it, _, _ = dist_cg_loop(mesh, mv, lambda r: invd_l * r, rhs_l,
                               inner_rtol, maxiter)
    return x, it


def _bicgstab_inner(mesh, mv, invd_l, rhs_l, inner_rtol, maxiter):
    """f32 Jacobi-BiCGSTAB of A d = rhs, with the JAX inner loop's
    breakdown guards and the port's shadow restart."""
    x, it, _, _ = dist_bicgstab_loop(mesh, mv, lambda r: invd_l * r, rhs_l,
                                     inner_rtol, maxiter, guarded=True)
    return x, it


def _gmres_inner(mesh, mv, invd_l, rhs_l, inner_rtol, maxiter, restart):
    """f32 restarted GMRES(m) of A d = rhs (CGS2 Arnoldi, replicated
    Hessenberg least squares, the stagnation stop), at most
    ceil(maxiter / m) cycles."""
    x, iters, _, _ = dist_gmres_loop(
        mesh, mv, lambda r: invd_l * r, rhs_l, inner_rtol,
        max(1, math.ceil(maxiter / restart)), restart)
    return x, iters


# ------------------------------------------------------------------ solver

def dist_refine_loop(mesh: RowMesh, b_l, rtol, max_refine, inner, mv64):
    """The f64 refinement on this rank's rows: per pass an f32 solve of
    A d ≈ r/‖r‖ (`inner(rhs32) -> (d32_l, iters)`), x += d·‖r‖, and the
    f64 residual r = b − A·x through `mv64` with one all_reduce. Returns
    (x_l, rr, bb, iters, passes), rr and bb the reduced ‖r‖² and ‖b‖²."""
    (bb,) = fused_psum(mesh, torch.dot(b_l, b_l))
    tol2 = (rtol ** 2) * bb
    x = torch.zeros_like(b_l)
    r, rr = b_l, bb
    iters = passes = 0
    while passes < max_refine and bool(rr > tol2):
        # One f64 SpMV per PASS, not per iteration: the residual carries
        # across passes.
        scale = torch.sqrt(rr)
        safe = torch.where(scale > 0, scale, 1.0)
        rhs32 = r.float() * (1.0 / safe).float()
        d32, inner_iters = inner(rhs32)
        # A non-finite correction (f32 breakdown) must not poison x; drop
        # it and let the pass cap end the loop.
        d32 = torch.where(torch.isfinite(d32), d32, 0.0)
        x = x + (d32 * safe.float()).double()
        r = b_l - mv64(x)
        (rr,) = fused_psum(mesh, torch.dot(r, r))
        iters += inner_iters
        passes += 1
    return x, rr, bb, iters, passes


class DistributedKrylovIr(RowPartitioned, Solver):
    """f32 distributed inner Krylov solve + f64 distributed refinement.

    Subclasses pick the inner method via `_inner(mv, invd_l, rhs32_l)`;
    everything else (the f64 residual pass, the ordering) is shared.
    """

    def __init__(self, A: CsrMatrix, mesh: RowMesh, rtol=1e-10,
                 inner_rtol=1e-5, maxiter=None, max_refine=6,
                 ordering="none", strategy="auto", local_spmv="auto",
                 row_align: int = 8, dtype=None, **params):
        super().__init__(A, **params)
        del dtype  # precision structure is fixed: f32 inner / f64 outer
        t0 = time.perf_counter()
        A, self._ord = resolve_dist_ordering(A, ordering)
        self.setup_breakdown["ordering_s"] = time.perf_counter() - t0
        self.mesh = mesh
        self.rtol = float(rtol)
        self.inner_rtol = float(inner_rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))
        self.max_refine = int(max_refine)
        self.n = A.nrows

        # Same partition for both operators (nloc depends only on n,
        # the rank count and row_align): f32 for the inner iteration, f64
        # for the residual.
        t0 = time.perf_counter()
        dm32 = self._matvec(A, torch.float32, strategy=strategy,
                            local_spmv=local_spmv, row_align=row_align)
        dm64 = self._matvec(A, torch.float64, strategy=dm32.strategy,
                            local_spmv=dm32.local_spmv, row_align=row_align)
        self.setup_breakdown["layout_s"] = time.perf_counter() - t0
        if (dm32.n_pad, dm32.nloc) != (dm64.n_pad, dm64.nloc):
            raise AssertionError("f32 and f64 partitions differ")
        self.strategy = dm32.strategy
        self.local_spmv = dm32.local_spmv
        self.plan = dm32.plan
        self.n_pad = dm32.n_pad
        self._mv32, self._mv64 = dm32.matvec, dm64.matvec
        self._rows = RowShard(mesh, self.n, dm32.nloc, self._ord)
        # Jacobi preconditioner for the f32 inner iteration.
        self._invd = local_inv_diag(A, self.n_pad, mesh, dm32.nloc,
                                    torch.float32)

    def _inner(self, mv, invd_l, rhs_l):
        """Return (d32_l, iters): an f32 solve of A d ≈ rhs to inner_rtol."""
        raise NotImplementedError

    def _run(self, b):
        return dist_refine_loop(
            self.mesh, self._rows.local(b, torch.float64), self.rtol,
            self.max_refine,
            lambda rhs32: self._inner(self._mv32, self._invd, rhs32),
            self._mv64)

    def solve(self, b) -> SolveResult:
        x_l, rr, bb, iters, passes = self._run(b)
        rnorm, bnorm = float(torch.sqrt(rr)), float(torch.sqrt(bb))
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        x = self._rows.gather(x_l)
        true_rel = true_relres(self.A, x, b)
        return SolveResult(x=x, iters=iters, relres=relres,
                           converged=true_rel <= self.rtol or bnorm == 0.0,
                           extra={"refine_passes": passes,
                                  **self._layout_extra(),
                                  "true_relres": true_rel,
                                  "precision_mode": "fp32_ir_auto"})

    def solve_fn(self):
        return lambda b: self._run(b)[0]


class DistributedCgIr(DistributedKrylovIr):
    """f32 distributed CG inner solve + f64 distributed residual
    refinement: the `--devices N` route of `--solver cg_ir` and of
    `--precision fp32_ir`."""

    name = "dist_cg_ir"

    def _inner(self, mv, invd_l, rhs_l):
        return _cg_inner(self.mesh, mv, invd_l, rhs_l, self.inner_rtol,
                         self.maxiter)


class DistributedBicgstabIr(DistributedKrylovIr):
    """f32 distributed BiCGSTAB inner + f64 refinement: the Ginkgo role
    (ginkgo.cpp:55-64) over the ranks with fp64 semantics
    (lsbench.c:140-141) — `--solver bicgstab/ginkgo --precision fp32_ir
    --devices N`."""

    name = "dist_bicgstab_ir"

    def _inner(self, mv, invd_l, rhs_l):
        return _bicgstab_inner(self.mesh, mv, invd_l, rhs_l,
                               self.inner_rtol, self.maxiter)


class DistributedGmresIr(DistributedKrylovIr):
    """f32 distributed restarted-GMRES inner + f64 refinement —
    `--solver gmres --precision fp32_ir --devices N`."""

    name = "dist_gmres_ir"

    def __init__(self, A: CsrMatrix, mesh: RowMesh, restart=30, **kw):
        self.restart = int(restart)
        super().__init__(A, mesh, **kw)

    def _inner(self, mv, invd_l, rhs_l):
        return _gmres_inner(self.mesh, mv, invd_l, rhs_l, self.inner_rtol,
                            self.maxiter, self.restart)


# ------------------------------------------------- 2-D partition variants

class DistributedKrylovIr2d(On2dGrid, DistributedKrylovIr):
    """fp64 semantics over the (rows × cols) grid: the f32 inner Krylov
    solve and the once-per-pass f64 residual on the 2-D schedule
    (`dist2d.py`); subclasses pick the inner method."""


class DistributedCgIr2d(DistributedKrylovIr2d, DistributedCgIr):
    """`--solver cg_ir --mesh RxC` (and `cg --precision fp32_ir`)."""

    name = "dist_cg_ir2d"


class DistributedBicgstabIr2d(DistributedKrylovIr2d, DistributedBicgstabIr):
    """`--solver bicgstab/ginkgo --precision fp32_ir --mesh RxC`."""

    name = "dist_bicgstab_ir2d"


class DistributedGmresIr2d(DistributedKrylovIr2d, DistributedGmresIr):
    """`--solver gmres --precision fp32_ir --mesh RxC`, with the GMRES
    inner loop's stagnation stop."""

    name = "dist_gmres_ir2d"
