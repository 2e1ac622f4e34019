"""Distributed restarted GMRES(m) over the row partition (counterpart of
`lsbench_tpu/parallel/dist_gmres.py`).

Same math as the single-device solver (`solvers/gmres.py`): CGS2
orthogonalization, right Jacobi preconditioning, the (m+1, m) Hessenberg
least squares once per restart. Distribution:

- the Arnoldi basis V lives as (m+1, nloc) on each rank;
- each CGS pass is a local (j+1, nloc)·(nloc,) product and ONE
  all_reduce (3 per inner step: two CGS passes and the new vector's norm);
- H is built from reduced dots, so it is the same on every rank, and the
  small QR and triangular solve run on every rank on its own device, in
  the loop's dtype — no gather.

The port's stagnation stop (`solvers/gmres.py`) is carried over: the
restart loop also ends after a cycle that did not lower the recomputed
‖r‖. ‖r‖ is reduced, so every rank stops after the same cycle. The stop
test reads it on the host once per cycle.
"""

from __future__ import annotations

import math
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
from lsbench_tpu_torch.solvers.gmres import EPS_BREAK
from lsbench_tpu_torch.utils.precision import full_f32


def dist_gmres_loop(mesh: RowMesh, matvec, precond, b_l, rtol,
                    max_restarts, m):
    """Restarted right-preconditioned GMRES(m) on this rank's rows, in
    b_l's dtype, with the stagnation stop. Returns (x_l, inner_iters,
    rnorm, bnorm), inner_iters = restarts · m; rnorm and bnorm are reduced
    0-d tensors."""
    dtype, dev = b_l.dtype, b_l.device
    nloc = b_l.shape[0]
    (bb,) = fused_psum(mesh, torch.dot(b_l, b_l))
    bnorm = torch.sqrt(bb)
    tol = float(rtol * bnorm)  # in `dtype`, as the JAX loop compares

    def arnoldi_cycle(x):
        r = b_l - matvec(x)
        (rr,) = fused_psum(mesh, torch.dot(r, r))
        beta = torch.sqrt(rr)
        V = torch.zeros((m + 1, nloc), dtype=dtype, device=dev)
        V[0] = r / torch.where(beta > 0, beta, 1.0)
        H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        for j in range(m):
            w = matvec(precond(V[j]))
            # CGS2 against rows 0..j: the JAX loop's masked (m+1, nloc)
            # products over the rows its mask keeps.
            Vj = V[: j + 1]
            with full_f32():
                (h1,) = fused_psum(mesh, Vj @ w)
                w = w - Vj.T @ h1
                (h2,) = fused_psum(mesh, Vj @ w)
                w = w - Vj.T @ h2
            (hn2,) = fused_psum(mesh, torch.dot(w, w))
            hnext = torch.sqrt(hn2)
            V[j + 1] = w / torch.clamp(hnext, min=EPS_BREAK)
            H[: j + 1, j] = h1 + h2
            H[j + 1, j] = hnext
        # Replicated least squares: min ‖beta e1 − H y‖ (H is the same on
        # every rank).
        e1 = torch.zeros(m + 1, dtype=dtype, device=dev)
        e1[0] = beta
        with full_f32():
            q, R = torch.linalg.qr(H, mode="reduced")
            R = R + EPS_BREAK * torch.eye(m, dtype=dtype, device=dev)
            y = torch.linalg.solve_triangular(R, (q.T @ e1)[:, None],
                                              upper=True)[:, 0]
            u = V[:m].T @ y
        return x + precond(u)

    x = torch.zeros_like(b_l)
    rnorm = bnorm
    rn, rn_prev = float(rnorm), float("inf")
    restarts = 0
    while restarts < max_restarts and rn > tol and rn < rn_prev:
        rn_prev = rn
        x = arnoldi_cycle(x)
        r = b_l - matvec(x)
        (rr,) = fused_psum(mesh, torch.dot(r, r))
        rnorm = torch.sqrt(rr)
        rn = float(rnorm)
        restarts += 1
    return x, restarts * m, rnorm, bnorm


class DistributedGmres(RowPartitioned, Solver):
    """Jacobi-preconditioned GMRES(restart) over the row partition, in
    `dtype` (f64 by default: the JAX CLI's `gmres --devices N`)."""

    name = "dist_gmres"

    def __init__(self, A: CsrMatrix, mesh: RowMesh, dtype=torch.float64,
                 rtol=1e-8, maxiter=None, restart=30, strategy="auto",
                 row_align: int = 8, local_spmv: str = "auto",
                 ordering: str = "none", **params):
        super().__init__(A, **params)
        t0 = time.perf_counter()
        A, self._ord = resolve_dist_ordering(A, ordering)
        self.setup_breakdown["ordering_s"] = time.perf_counter() - t0
        self.mesh = mesh
        self.dtype = as_dtype(dtype)
        self.rtol = float(rtol)
        self.restart = int(restart)
        maxiter = (int(maxiter) if maxiter is not None
                   else max(10 * A.nrows, 1000))
        self.max_restarts = max(1, math.ceil(maxiter / self.restart))

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
        return dist_gmres_loop(self.mesh, self._mv, lambda r: inv_diag * r,
                               self._rows.local(b, self.dtype), self.rtol,
                               self.max_restarts, self.restart)

    def solve(self, b) -> SolveResult:
        x_l, iters, rnorm, bnorm = self._run(b)
        rnorm, bnorm = float(rnorm), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        x = self._rows.gather(x_l)
        true_rel = true_relres(self.A, x, b)
        return SolveResult(x=x, iters=iters, relres=relres,
                           converged=true_rel <= self.rtol or bnorm == 0.0,
                           extra={**self._layout_extra(halo=False),
                                  "true_relres": true_rel})

    def solve_fn(self):
        return lambda b: self._run(b)[0]
