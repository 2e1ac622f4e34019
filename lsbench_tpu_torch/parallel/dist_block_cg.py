"""Distributed multi-RHS (block) CG: A X = B over the row partition
(counterpart of `lsbench_tpu/parallel/dist_block_cg.py`).

`--nrhs k --devices N`: the k columns ride the same stream of the local
operator — the halo exchange moves (H, k) boundary rows and the local
SpMM is the SELL SpMM (`spmm_sell`, the redesigned K3) on the rank's
block, where the JAX package runs one Pallas MXU dot per block slot.

The iteration is the JAX package's simultaneous-column PCG (per-column
alpha/beta, converged columns frozen by masking), not the shared-subspace
BCGrQ of the single-device `block_cg`: its Householder QR has no
row-partitioned decomposition. Each iteration is one SpMM and two fused
all_reduces of (k,)-vectors; the per-column scalars are computed on every
rank from the reduced dots.

Precision: f32 inner block CG + f64 per-column residual refinement (one
SELL f64 SpMV per column per pass), reaching the direct tolerance 1e-10
at f32 SpMM cost.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.parallel.dist_cg import local_inv_diag
from lsbench_tpu_torch.parallel.dist_spmv import (RowPartitioned,
                                                  RowShard, fused_psum)
from lsbench_tpu_torch.parallel.mesh import RowMesh
from lsbench_tpu_torch.parallel.perm import resolve_dist_ordering
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, true_relres


def _cdots_psum(mesh: RowMesh, *pairs):
    """Fused per-column dots: each pair (U, V) of (nloc, k) blocks gives
    its reduced (k,) column dots, all in one all_reduce."""
    return fused_psum(mesh, *[(u * v).sum(dim=0) for u, v in pairs])


class DistributedBlockCg(RowPartitioned, Solver):
    """Simultaneous-column block PCG over the row partition, f32 + f64
    refinement."""

    name = "dist_block_cg"

    def __init__(self, A: CsrMatrix, mesh: RowMesh, nrhs: int, rtol=1e-10,
                 inner_rtol=1e-5, maxiter=None, max_refine=6,
                 ordering="none", strategy="auto", local_spmv="auto",
                 row_align: int = 8, dtype=None, **params):
        super().__init__(A, **params)
        del dtype  # fixed structure: f32 SpMM inner / f64 outer
        t0 = time.perf_counter()
        A, self._ord = resolve_dist_ordering(A, ordering)
        self.setup_breakdown["ordering_s"] = time.perf_counter() - t0
        self.mesh = mesh
        self.nrhs = int(nrhs)
        self.rtol = float(rtol)
        self.inner_rtol = float(inner_rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))
        self.max_refine = int(max_refine)
        self.n = A.nrows

        t0 = time.perf_counter()
        dm32 = self._matvec(A, torch.float32, strategy=strategy,
                            local_spmv=local_spmv, row_align=row_align)
        dm64 = self._matvec(A, torch.float64, strategy=dm32.strategy,
                            local_spmv=dm32.local_spmv, row_align=row_align)
        self.setup_breakdown["layout_s"] = time.perf_counter() - t0
        self.strategy = dm32.strategy
        self.local_spmv = dm32.local_spmv
        self.plan = dm32.plan
        self.n_pad = dm32.n_pad
        self._mm32, self._mm64 = dm32.matmat, dm64.matmat
        self._rows = RowShard(mesh, self.n, dm32.nloc, self._ord)
        self._invd = local_inv_diag(A, self.n_pad, mesh, dm32.nloc,
                                    torch.float32)[:, None]

    def _block_cg_inner(self, R):
        """Simultaneous per-column f32 PCG of A D = R to inner_rtol."""
        mesh, invd = self.mesh, self._invd
        (bn2,) = _cdots_psum(mesh, (R, R))
        tol2 = (self.inner_rtol ** 2) * bn2
        X = torch.zeros_like(R)
        Z = invd * R
        P = Z
        rz, rr = _cdots_psum(mesh, (R, Z), (R, R))
        it = 0
        while it < self.maxiter and bool((rr > tol2).any()):
            active = rr > tol2
            Q = self._mm32(P)
            (pq,) = _cdots_psum(mesh, (P, Q))
            alpha = torch.where(active, rz / torch.where(pq != 0, pq, 1.0),
                                0.0)
            X = X + P * alpha[None, :]
            R = R - Q * alpha[None, :]
            Z = invd * R
            rz_new, rr = _cdots_psum(mesh, (R, Z), (R, R))
            beta = torch.where(active,
                               rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
            P = Z + P * beta[None, :]
            rz = rz_new
            it += 1
        return X, it

    def _run(self, B):
        B = torch.as_tensor(B)
        if B.ndim == 1:
            B = B[:, None]
        if tuple(B.shape) != (self.n, self.nrhs):
            raise ValueError(f"B has shape {tuple(B.shape)}, expected "
                             f"({self.n}, {self.nrhs})")
        B_l = self._rows.local(B, torch.float64)
        (bn2,) = _cdots_psum(self.mesh, (B_l, B_l))
        tol2 = (self.rtol ** 2) * bn2
        X = torch.zeros_like(B_l)
        R, rr = B_l, bn2
        iters = passes = 0
        while passes < self.max_refine and bool((rr > tol2).any()):
            scale = torch.sqrt(rr)                                  # (k,)
            safe = torch.where(scale > 0, scale, 1.0)
            R32 = (R.float() * (1.0 / safe).float()[None, :]).contiguous()
            D32, inner_iters = self._block_cg_inner(R32)
            D32 = torch.where(torch.isfinite(D32), D32, 0.0)
            X = X + (D32 * safe.float()[None, :]).double()
            R = B_l - self._mm64(X)
            (rr,) = _cdots_psum(self.mesh, (R, R))
            iters += inner_iters
            passes += 1
        return X, rr, bn2, iters, passes

    def solve(self, B) -> SolveResult:
        squeeze = np.asarray(B).ndim == 1
        X_l, rr, bn2, iters, passes = self._run(B)
        rnorm = torch.sqrt(rr).cpu().numpy()
        bnorm = torch.sqrt(bn2).cpu().numpy()
        relres_cols = np.where(bnorm > 0, rnorm / np.maximum(bnorm, 1e-300),
                               0.0)
        X = self._rows.gather(X_l)
        x = X[:, 0] if squeeze else X
        true_rel = true_relres(self.A, x, B)
        return SolveResult(x=x, iters=iters, relres=float(relres_cols.max()),
                           converged=true_rel <= self.rtol,
                           extra={"refine_passes": passes,
                                  "nrhs": self.nrhs,
                                  "method": "simultaneous",
                                  "relres_cols": relres_cols.tolist(),
                                  **self._layout_extra(),
                                  "true_relres": true_rel,
                                  "precision_mode": "fp32_ir"})

    def solve_fn(self):
        return lambda B: self._run(B)[0]
