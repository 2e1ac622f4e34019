"""Distributed (block-row partitioned) preconditioned CG (counterpart of
`lsbench_tpu/parallel/dist_cg.py`).

The matrix is partitioned by contiguous row blocks over the ranks; vectors
are too. Per iteration:

- search-direction exchange: a halo ring (O(H) per rank, banded matrices —
  `parallel/dist_spmv.py`) or an all_gather (O(n), any structure),
- the local SpMV on the owned block (the SELL kernels on the halo path),
- ONE fused all_reduce for the scalar reductions (`fused_psum`).

The JAX loop is one `while_loop` over psum'd scalars; here the stop test
reads the reduced `rr` on the host once per iteration, as the port's
single-device `cg_loop` does. Every rank reads the same value, so all take
the same branch. Padded rows are zero (b = 0, inverse diagonal 1), so they
contribute nothing to the dots.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.parallel.dist_spmv import (RowPartitioned,
                                                  RowShard, fused_psum)
from lsbench_tpu_torch.parallel.mesh import RowMesh
from lsbench_tpu_torch.parallel.perm import resolve_dist_ordering
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, true_relres
from lsbench_tpu_torch.solvers.cg import as_dtype
from lsbench_tpu_torch.utils.precision import full_f32


def dist_cg_loop(mesh: RowMesh, matvec, papply, b_l, rtol, maxiter):
    """PCG on this rank's rows, in b_l's dtype: the JAX package's shard_map
    body, with its fused reductions. Returns (x_l, iters, rr, bb), rr and
    bb the reduced ‖r‖² and ‖b‖² (0-d tensors)."""
    (bb,) = fused_psum(mesh, torch.dot(b_l, b_l))
    tol2 = (rtol ** 2) * bb
    x = torch.zeros_like(b_l)
    r = b_l
    z = papply(r)
    p = z
    rz, rr = fused_psum(mesh, torch.dot(r, z), torch.dot(r, r))
    it = 0
    while it < maxiter and bool(rr > tol2):
        Ap = matvec(p)
        (pAp,) = fused_psum(mesh, torch.dot(p, Ap))
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = papply(r)
        rz_new, rr = fused_psum(mesh, torch.dot(r, z), torch.dot(r, r))
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it, rr, bb


def local_inv_diag(A: CsrMatrix, n_pad: int, mesh: RowMesh, nloc: int,
                   dtype) -> torch.Tensor:
    """This rank's slice of the padded inverse diagonal (1 on zero
    diagonals and on the pad rows)."""
    d = np.ones(n_pad)
    diag = A.diagonal()
    d[: A.nrows] = np.where(diag != 0.0, diag, 1.0)
    lo = mesh.rank * nloc
    return torch.as_tensor(1.0 / d[lo: lo + nloc], dtype=dtype,
                           device=mesh.device)


class DistributedCg(RowPartitioned, Solver):
    """CG over the row partition, on one card per rank or on CPU ranks."""

    name = "dist_cg"

    def __init__(self, A: CsrMatrix, mesh: RowMesh, dtype=torch.float64,
                 rtol=1e-8, maxiter=None, strategy="auto", row_align: int = 8,
                 precond: str = "jacobi", block_size: int = 16,
                 local_spmv: str = "auto", ordering: str = "none", **params):
        super().__init__(A, **params)
        # Host-side symmetric reordering (cusparse.c:66-96 role): densifies
        # the band, shrinking the halo and the local blocks' column spread.
        t0 = time.perf_counter()
        A, self._ord = resolve_dist_ordering(A, ordering)
        self.setup_breakdown["ordering_s"] = time.perf_counter() - t0
        self.mesh = mesh
        self.dtype = as_dtype(dtype)
        self.rtol = float(rtol)
        self.maxiter = int(maxiter) if maxiter is not None else max(10 * A.nrows, 1000)

        t0 = time.perf_counter()
        dm = self._matvec(A, self.dtype, strategy=strategy,
                          local_spmv=local_spmv, row_align=row_align)
        self.setup_breakdown["layout_s"] = time.perf_counter() - t0
        self.strategy = dm.strategy
        self.plan = dm.plan
        self.local_spmv = dm.local_spmv
        self.n = A.nrows
        self.n_pad = dm.n_pad
        self._mv = dm.matvec
        self._rows = RowShard(mesh, self.n, dm.nloc, self._ord)

        # "jacobi": pointwise 1/diag. "block_jacobi": dense diagonal blocks
        # inverted at setup; blocks never cross rank boundaries (block_size
        # divides nloc, a multiple of row_align), so the apply is purely
        # local (no collective).
        self.precond = precond
        nloc = dm.nloc
        if precond == "block_jacobi":
            k = int(block_size)
            while nloc % k:
                k //= 2  # row_align=8 guarantees k ∈ {8,4,2,1} divides nloc
            nb = self.n_pad // k
            blocks = np.zeros((nb, k, k))
            blocks[:, np.arange(k), np.arange(k)] = 1.0
            r_, c_, v_ = A.to_coo()
            same = (r_ // k) == (c_ // k)
            rb, cb_, vb = r_[same], c_[same], v_[same]
            blocks[rb // k, rb % k, cb_ % k] = vb
            lo = mesh.rank * nloc // k
            inv = torch.as_tensor(np.linalg.inv(blocks[lo: lo + nloc // k]),
                                  dtype=self.dtype, device=mesh.device)

            def papply(r_vec):
                with full_f32():
                    z = torch.bmm(inv, r_vec.view(-1, k, 1))
                return z.view(-1)
        elif precond == "jacobi":
            inv_diag = local_inv_diag(A, self.n_pad, mesh, nloc, self.dtype)

            def papply(r_vec):
                return inv_diag * r_vec
        else:
            raise ValueError(f"unknown distributed preconditioner '{precond}'"
                             " (jacobi | block_jacobi)")
        self._pc = papply

    def _run(self, b):
        b_l = self._rows.local(b, self.dtype)
        return dist_cg_loop(self.mesh, self._mv, self._pc, b_l, self.rtol,
                            self.maxiter)

    def solve(self, b) -> SolveResult:
        x_l, iters, rr, bb = self._run(b)
        relres = float(torch.sqrt(rr / torch.where(bb > 0, bb, 1.0)))
        x = self._rows.gather(x_l)
        # Honest convergence: judge against the host fp64 TRUE residual,
        # not the (possibly f32) recurrence.
        true_rel = true_relres(self.A, x, b)
        return SolveResult(x=x, iters=iters, relres=relres,
                           converged=true_rel <= self.rtol,
                           extra={**self._layout_extra(),
                                  "true_relres": true_rel})

    def solve_fn(self):
        # The rank's block of x, as the JAX package's solve_fn returns the
        # row-sharded x without gathering it.
        return lambda b: self._run(b)[0]
