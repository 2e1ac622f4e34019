"""Multi-RHS (block) CG: solve A X = B for k right-hand sides at once
(counterpart of `lsbench_tpu/solvers/block_cg.py`).

Every inner matvec is one SpMM (`spmm_sell`, the redesigned kernel K3) over
the f32 sliced ELL of the operator, so the k columns share one stream of
its entries; the JAX package streams its uniform 8×128 BSR blocks there
(`spmm_bsr`). Two inner iterations, as in the JAX package:

- method="shared" (default): BCGrQ, true block CG in one block-Krylov
  subspace with split Jacobi (Ã = S·A·S, S = diag(|d|)^{-1/2}); the residual
  block is kept factored as Q·rho with Q orthonormal (Householder QR or
  two-pass CholQR), and the k×k step uses an eigh pseudo-inverse so a
  rank-deficient direction block does not blow up.
- method="simultaneous": k independent PCG recurrences over the columns,
  converged columns frozen by masking; the fallback for a preconditioner
  that does not split (anything but none/jacobi, e.g. amg).

Precision: f32 inner solve + one f64 residual per refinement pass (the
sliced-ELL f64 product that replaces K2, on the SpMM's own SELL structure,
one launch per column), reported
as `fp32_ir`. The k×k algebra and the (n,k)·(k,k) products run in full f32
(`full_f32`, JAX's Precision.HIGHEST) through torch.linalg and torch.matmul,
as the JAX package leaves them to XLA. Each stop test reads the device once
per iteration; `eigh` on a CUDA matrix adds one more synchronization.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.sell import SellMatrix
from lsbench_tpu_torch.ops.spmv_sell import spmm_sell
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu_torch.solvers.cg import full_f32, permutation
from lsbench_tpu_torch.solvers.preconditioners import (check as check_precond,
                                                       get_preconditioner)
from lsbench_tpu_torch.solvers.refine import f64_residual_matvec


def _cdots(u, v):
    """Per-column dot products: (n,k),(n,k) -> (k,)."""
    return (u * v).sum(dim=0)


def _cholqr2(Y, eps_rel=1e-6):
    """Two-pass CholQR: Y = Q @ C with Q ~orthonormal. The trace-scaled
    shift keeps the Cholesky factor alive under rank collapse (a deficient
    column comes back as some unit vector, not a breakdown)."""
    k = Y.shape[1]
    eye = torch.eye(k, dtype=Y.dtype, device=Y.device)

    def one_pass(Yc):
        G = Yc.T @ Yc
        shift = eps_rel * (torch.trace(G) / k) + 1e-30
        C = torch.linalg.cholesky_ex(G + shift * eye).L.T  # upper: Yc = Q C
        Cinv = torch.linalg.solve_triangular(C, eye, upper=True)
        return Yc @ Cinv, C

    Q1, C1 = one_pass(Y)
    Q2, C2 = one_pass(Q1)
    return Q2, C2 @ C1


def _householder_qr(Y):
    return torch.linalg.qr(Y, mode="reduced")


def block_cg_shared_loop(matmat, ihalf, B, rtol, maxiter, dtype,
                         qr="householder"):
    """Shared-subspace block CG (BCGrQ) with split Jacobi.

    Solves A D = B for all columns in one block-Krylov space, iterating on
    Ã = S A S (S = diag(ihalf)) with the residual block R̃ = Q·rho:

        Z   = Ã D
        xi  = (Dᵀ Z)⁺                       (eigh pseudo-inverse, k×k)
        Y  += D (xi rho)
        (Q, gamma) = qr(Q − Z xi)
        rho = gamma rho
        D   = Q + D gammaᵀ

    qr="householder" keeps collapsed columns alive through the reflectors'
    completion (fresh unit directions); qr="cholqr2" is only safe for
    well-conditioned full-rank blocks. Per-column stop on the columns of rho
    (‖R̃ e_j‖ = ‖rho e_j‖). Returns (X, block_iters, rnorm (k,), bnorm (k,))
    in the unscaled variables."""
    B = B.to(dtype)
    ih = ihalf.to(dtype)[:, None]
    orthonormalize = _cholqr2 if qr == "cholqr2" else _householder_qr
    with full_f32():
        Bt = B * ih
        Q, rho = orthonormalize(Bt)
        bnorm2 = (rho * rho).sum(dim=0)
        tol2 = (rtol ** 2) * bnorm2
        Y = torch.zeros_like(Bt)
        D = Q
        it = 0
        while it < maxiter and bool(((rho * rho).sum(dim=0) > tol2).any()):
            Z = matmat(D * ih) * ih
            M = D.T @ Z
            # Symmetrized, as jnp.linalg.eigh does by default.
            lam, V = torch.linalg.eigh(0.5 * (M + M.T))
            lam_max = torch.clamp(lam[-1], min=1e-30)
            inv_lam = torch.where(lam > 1e-5 * lam_max, 1.0 / lam,
                                  torch.zeros_like(lam))
            xi = (V * inv_lam[None, :]) @ V.T
            Y = Y + D @ (xi @ rho)
            Q, gamma = orthonormalize(Q - Z @ xi)
            rho = gamma @ rho
            D = Q + D @ gamma.T
            it += 1
        X = Y * ih
        rnorm = torch.sqrt((rho * rho).sum(dim=0))
    return X, it, rnorm, torch.sqrt(bnorm2)


def block_cg_loop(matmat, pc_cols, B, rtol, maxiter, dtype):
    """Simultaneous PCG over columns. matmat: (n,k)->(n,k) SpMM; pc_cols:
    (n,k)->(n,k) columnwise preconditioner. Returns (X, iters, rnorm (k,),
    bnorm (k,)). Converged columns are frozen by alpha/beta masking."""
    B = B.to(dtype)
    bnorm2 = _cdots(B, B)
    tol2 = (rtol ** 2) * bnorm2
    X = torch.zeros_like(B)
    R = B
    P = Z = pc_cols(R)
    rz, rr = _cdots(R, Z), _cdots(R, R)
    it = 0
    while it < maxiter and bool((rr > tol2).any()):
        active = rr > tol2
        Q = matmat(P)
        pq = _cdots(P, Q)
        zero = torch.zeros_like(pq)
        alpha = torch.where(active, rz / torch.where(pq != 0, pq, 1.0), zero)
        X = X + P * alpha[None, :]
        R = R - Q * alpha[None, :]
        Z = pc_cols(R)
        rz_new, rr = _cdots(R, Z), _cdots(R, R)
        beta = torch.where(active, rz_new / torch.where(rz != 0, rz, 1.0),
                           zero)
        P = Z + P * beta[None, :]
        rz = rz_new
        it += 1
    return X, it, torch.sqrt(rr), torch.sqrt(bnorm2)


def column_precond(precond: str, state, papply):
    """The preconditioner applied to each column of an (n,k) block: by
    broadcasting for none/jacobi, else one apply per column."""
    key = precond.lower()
    if key == "none":
        return lambda R: R
    if key == "jacobi":
        return lambda R: state[:, None] * R
    return lambda R: torch.stack(
        [papply(state, R[:, j]) for j in range(R.shape[1])], dim=1)


class MultiRhsIrSolver(Solver):
    """f32 inner solve of A D = R over k columns on the SELL SpMM + one f64
    residual per refinement pass (`spmv_sell_f64` per column, sharing the
    SpMM's structure). Subclasses provide
    `_inner_loop(R32) -> (D32, iters)`. solve(B) takes (n, k) or a 1-D b
    (k = 1, returned 1-D); relres/converged report the worst column."""

    def __init__(self, A: CsrMatrix, rtol, inner_rtol, maxiter, max_refine,
                 ordering, device, **params):
        super().__init__(A, **params)
        self.device = torch.device(device)
        self.rtol = float(rtol)
        self.inner_rtol = float(inner_rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))
        self.max_refine = int(max_refine)
        self._pstate = None  # the preconditioner's state, where it has one

        t0 = time.perf_counter()
        self._Ap, self._perm, self._inv = permutation(ordering, A, self.device)
        self.setup_breakdown["ordering_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._op = SellMatrix.from_csr(self._Ap, dtypes=(torch.float32,),
                                       device=self.device)
        # The SpMM reads X row-major in place; the QR of the shared loop
        # returns column-major blocks, which this one copy makes row-major
        # (a no-op on the other loops' blocks).
        self._mm = lambda V: spmm_sell(self._op, V.contiguous())
        self._resid_mv = f64_residual_matvec(self._Ap, self._op, self.device)
        self.setup_breakdown["layout_s"] = time.perf_counter() - t0

    def _inner_loop(self, R32):
        raise NotImplementedError

    def _mm64(self, X):
        """f64 residual SpMM: one `spmv_sell_f64` launch per column, once
        per pass."""
        return torch.stack([self._resid_mv(X[:, j].contiguous())
                            for j in range(X.shape[1])], dim=1)

    def solve(self, B) -> SolveResult:
        B = torch.as_tensor(B, device=self.device).to(torch.float64)
        squeeze = B.dim() == 1
        if squeeze:
            B = B[:, None]
        Bp = B if self._perm is None else B[self._perm]
        bnorm2 = _cdots(Bp, Bp)
        tol2 = (self.rtol ** 2) * bnorm2

        X = torch.zeros_like(Bp)
        R, rr = Bp, bnorm2
        iters = passes = 0
        while passes < self.max_refine and bool((rr > tol2).any()):
            scale = torch.sqrt(rr)
            safe = torch.where(scale > 0, scale, 1.0)
            R32 = R.to(torch.float32) * (1.0 / safe).to(torch.float32)[None, :]
            D32, inner_iters = self._inner_loop(R32)
            D32 = torch.where(torch.isfinite(D32), D32, 0.0)
            X = X + (D32 * safe.to(torch.float32)[None, :]).to(torch.float64)
            R = Bp - self._mm64(X)
            rr = _cdots(R, R)
            iters += inner_iters
            passes += 1
        check_precond(self._pstate)
        if self._inv is not None:
            X = X[self._inv]
        rnorm = np.sqrt(rr.cpu().numpy())
        bnorm = np.sqrt(bnorm2.cpu().numpy())
        relres_cols = np.where(bnorm > 0,
                               rnorm / np.maximum(bnorm, 1e-300), 0.0)
        relres = float(relres_cols.max())
        return SolveResult(x=X[:, 0] if squeeze else X, iters=iters,
                           relres=relres, converged=relres <= self.rtol,
                           extra={"refine_passes": passes,
                                  "nrhs": int(B.shape[1]),
                                  "relres_cols": relres_cols.tolist(),
                                  # Structurally f32 SpMM inner + f64
                                  # residual outer, whatever the precision
                                  # asked; the record's label shows it.
                                  "precision_mode": "fp32_ir"})


@register_solver("block_cg")
class BlockCgSolver(MultiRhsIrSolver):
    """Block CG with f32 SpMM inner + f64 residual outer (the `--solver cg
    --nrhs k` route)."""

    def __init__(self, A: CsrMatrix, rtol=1e-10, inner_rtol=1e-5,
                 maxiter=None, max_refine=6, precond="jacobi",
                 layout="auto", ordering="none", dtype=None,
                 precond_params=None, method="shared", qr="householder",
                 device="cuda", **params):
        del dtype, layout  # fixed structure: f32 SpMM inner / f64 outer
        if method not in ("shared", "simultaneous"):
            raise ValueError(f"unknown block_cg method '{method}' "
                             "(shared | simultaneous)")
        # The shared recurrence needs a split (symmetric) preconditioner;
        # only diagonal ones split explicitly.
        if method == "shared" and precond not in ("jacobi", "none"):
            method = "simultaneous"
        if qr not in ("householder", "cholqr2"):
            raise ValueError(f"unknown block_cg qr '{qr}' "
                             "(householder | cholqr2)")
        self.method, self.qr = method, qr
        super().__init__(A, rtol, inner_rtol, maxiter, max_refine, ordering,
                         device, **params)
        t0 = time.perf_counter()
        if method == "shared":
            # S = diag(|d|)^{-1/2}; zero diagonals keep identity scaling.
            d = np.abs(self._Ap.diagonal())
            ih = np.where(d > 0.0, 1.0 / np.sqrt(np.where(d == 0, 1.0, d)),
                          1.0)
            if precond == "none":
                ih = np.ones_like(ih)
            self._ihalf = torch.as_tensor(ih, dtype=torch.float32,
                                          device=self.device)
        else:
            self._pstate, papply = get_preconditioner(precond)(
                self._Ap, torch.float32, self.device,
                **(precond_params or {}))
            self._pc_cols = column_precond(precond, self._pstate, papply)
        self.setup_breakdown["precond_s"] = time.perf_counter() - t0

    def _inner_loop(self, R32):
        if self.method == "shared":
            D32, iters, _, _ = block_cg_shared_loop(
                self._mm, self._ihalf, R32, self.inner_rtol, self.maxiter,
                torch.float32, qr=self.qr)
        else:
            D32, iters, _, _ = block_cg_loop(
                self._mm, self._pc_cols, R32, self.inner_rtol, self.maxiter,
                torch.float32)
        return D32, iters

    def solve(self, B) -> SolveResult:
        res = super().solve(B)
        res.extra["method"] = self.method
        return res
