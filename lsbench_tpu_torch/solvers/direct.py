"""Direct Cholesky solvers, the CHOLMOD and cuSOLVER role (counterpart of
`lsbench_tpu/solvers/direct.py`).

Reference protocols:
- CHOLMOD, the default backend: ordering and factorization once at setup
  (cholmod-impl.h:25-26), the timed solve is the triangular solves
  (cholmod-impl.h:44-63) → `refactor_each_solve=False` (alias `cholmod`);
- cuSOLVER `csrlsvchol`: factor and solve in every trial
  (cusparse.c:183-194) after a host permutation (cusparse.c:66-96) →
  `refactor_each_solve=True` (alias `cusolver`).

Both classes keep the JAX package's structure and decisions:
- above `max_dense_n` they delegate to `sparse_cholesky` and say so in
  `extra["delegated"]`;
- fp64 `cholesky` takes the JAX package's TPU branch on every device: it
  runs as `cholesky_ir` (an f32 factor refined by f64 residuals, recorded
  as fp32_ir_auto), so that a kernel of the port is on the path and both
  packages report the same precision labels;
- `cholesky_ir` factors in f32 on the host. In the factor-once protocol
  it forms the explicit f32 inverse there (the refinement certifies x, so
  the inverse only has to precondition the correction) and applies it on
  the device with one full-f32 product per pass; the `cusolver` protocol
  factors the f32 matrix on the device in every solve
  (`torch.linalg.cholesky`) and applies two `torch.linalg.solve_triangular`
  per pass. The f64 residual of each pass is `spmv_sell_f64`, one launch
  per column, where the TPU ran `spmv_bsr_df64`.
The f32 `cholesky` (`--precision fp32`) is the JAX package's dense path in
f32: a device factor, two triangular solves and two refinement passes
against the raw operator (the plain ELL product).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.ell import EllMatrix
from lsbench_tpu_torch.matrix.sell import SellMatrix
from lsbench_tpu_torch.ops.spmv import spmv_ell
from lsbench_tpu_torch.ops.spmv_sell import spmv_sell_f64
from lsbench_tpu_torch.solvers.base import (SolveResult, Solver,
                                            register_solver, to_numpy,
                                            true_relres)
from lsbench_tpu_torch.solvers.cg import as_dtype, permutation
from lsbench_tpu_torch.solvers.refine import column_residual, refine_columns
from lsbench_tpu_torch.solvers.sparse_cholesky import SparseCholeskySolver
from lsbench_tpu_torch.utils.precision import full_f32


def _tri(L: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ v by two triangular solves; v (n,) or (n, k)."""
    v2 = v[:, None] if v.ndim == 1 else v
    with full_f32():
        y = torch.linalg.solve_triangular(L, v2, upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[:, 0] if v.ndim == 1 else x


def _symmetric_dense(Ap: CsrMatrix) -> np.ndarray:
    """(Ap + Apᵀ)/2 dense in f64: the symmetric part CHOLMOD's stype=-1
    build factors (cholmod-impl.h:5-18)."""
    d = Ap.to_dense()
    return (d + d.T) * 0.5


@register_solver("cholesky")
class CholeskySolver(Solver):

    def __init__(self, A: CsrMatrix, dtype=torch.float64, ordering="amd",
                 refactor_each_solve=False, max_dense_n=20000, device="cuda",
                 **params):
        super().__init__(A, **params)
        if A.nrows != A.ncols:
            raise ValueError("Cholesky requires a square matrix")
        self.device = torch.device(device)
        self.dtype = as_dtype(dtype)
        self.refactor = bool(refactor_each_solve)
        self.ordering = ordering
        self._delegate = None
        self._delegate_mode = None
        if A.nrows > max_dense_n:
            # The reference's default backend refuses no size
            # (cholmod-impl.h:20-26): above the dense guard, the sparse path.
            print(f"cholesky: n={A.nrows} > dense guard {max_dense_n}; "
                  "delegating to sparse_cholesky (host sparse factor; host "
                  "or device blocked triangular solves).", file=sys.stderr)
            self._delegate = SparseCholeskySolver(
                A, dtype=self.dtype, ordering=ordering, device=device,
                **params)
            self._delegate_mode = "sparse_cholesky"
            self.setup_breakdown = self._delegate.setup_breakdown
            return
        if self.dtype == torch.float64:
            print("cholesky: fp64 executes as f32 factor + f64 iterative "
                  "refinement (mode fp32_ir_auto).", file=sys.stderr)
            self._delegate = CholeskyIrSolver(
                A, ordering=ordering, max_dense_n=max_dense_n,
                refactor_each_solve=refactor_each_solve, device=device,
                **params)
            self.setup_breakdown = self._delegate.setup_breakdown
            return

        t0 = time.perf_counter()
        Ap, self._perm, self._inv = permutation(ordering, A, self.device)
        self.setup_breakdown["ordering_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._dense = torch.as_tensor(_symmetric_dense(Ap), dtype=self.dtype,
                                      device=self.device)
        # The factor is of the symmetrized matrix; two refinement passes
        # against the raw operator restore its residual.
        self._ell = EllMatrix.from_csr(Ap, dtype=self.dtype,
                                       device=self.device)
        self._L = None if self.refactor else self._factor()
        self.setup_breakdown["factor_s"] = time.perf_counter() - t0

    def _factor(self) -> torch.Tensor:
        with full_f32():
            return torch.linalg.cholesky(self._dense)

    def _mv(self, X: torch.Tensor) -> torch.Tensor:
        if X.ndim == 1:
            return spmv_ell(self._ell, X)
        return torch.stack([spmv_ell(self._ell, X[:, j])
                            for j in range(X.shape[1])], dim=1)

    def _dense_solve(self, b) -> torch.Tensor:
        L = self._factor() if self.refactor else self._L
        b = torch.as_tensor(b, device=self.device)
        bp = (b if self._perm is None else b[self._perm]).to(self.dtype)
        x = _tri(L, bp)
        for _ in range(2):
            x = x + _tri(L, bp - self._mv(x))
        return x if self._inv is None else x[self._inv]

    def solve(self, b) -> SolveResult:
        if self._delegate is not None:
            res = self._delegate.solve(b)
            if self._delegate_mode is not None:
                res.extra["delegated"] = self._delegate_mode
            else:
                res.extra["precision_mode"] = "fp32_ir_auto"
            return res
        x = self._dense_solve(b)
        relres = true_relres(self.A, x, b)
        extra = {}
        if x.ndim == 2:
            extra["nrhs"] = int(x.shape[1])
        return SolveResult(x=x, iters=1, relres=relres,
                           converged=bool(np.isfinite(relres)), extra=extra)

    def solve_fn(self):
        if self._delegate is not None:
            return self._delegate.solve_fn()
        return self._dense_solve


@register_solver("cholesky_ir")
class CholeskyIrSolver(Solver):
    """Mixed-precision direct solve: an f32 Cholesky factor refined to fp64
    accuracy (Wilkinson): d = (LLᵀ)⁻¹ r in f32, x += d, r = b − A·x in f64
    (`spmv_sell_f64`). Each pass gains ~κ·ε_f32, so the reference's 1e-10
    direct tolerance (cusparse.c:184) takes a few passes."""

    def __init__(self, A: CsrMatrix, rtol=1e-10, max_refine=12,
                 ordering="amd", max_dense_n=20000, dtype=None,
                 refactor_each_solve=False, device="cuda", **params):
        super().__init__(A, **params)
        del dtype  # the precision structure is fixed: f32 factor, f64 residual
        if A.nrows != A.ncols:
            raise ValueError("Cholesky requires a square matrix")
        self.device = torch.device(device)
        self._delegate = None
        if A.nrows > max_dense_n:
            print(f"cholesky_ir: n={A.nrows} > dense guard {max_dense_n}; "
                  "delegating to sparse_cholesky.", file=sys.stderr)
            self._delegate = SparseCholeskySolver(
                A, dtype=torch.float64, ordering=ordering, rtol=rtol,
                max_refine=max_refine, device=device, **params)
            self.setup_breakdown = self._delegate.setup_breakdown
            return
        self.rtol = float(rtol)
        self.max_refine = int(max_refine)
        self.ordering = ordering
        self.refactor = bool(refactor_each_solve)

        t0 = time.perf_counter()
        Ap, self._perm, self._inv = permutation(ordering, A, self.device)
        self.setup_breakdown["ordering_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        sym32 = _symmetric_dense(Ap).astype(np.float32)
        if self.refactor:
            # Every timed solve factors on the device; setup factors nothing.
            self._sym32 = torch.as_tensor(sym32, device=self.device)
            self._M = None
        else:
            # The host factor (LAPACK), as the reference's CHOLMOD factors
            # on the CPU (cholmod.c:68), and the explicit f32 inverse
            # A⁻¹ = L⁻ᵀ L⁻¹ from two host triangular solves against I in
            # f64, then rounded.
            import scipy.linalg as sla
            L64 = np.linalg.cholesky(sym32.astype(np.float64))
            ainv64 = sla.cho_solve((L64, True), np.eye(L64.shape[0]),
                                   overwrite_b=True, check_finite=False)
            self._M = torch.as_tensor(ainv64.astype(np.float32),
                                      device=self.device)
            del ainv64
        self.setup_breakdown["factor_s"] = time.perf_counter() - t0
        self._op64 = SellMatrix.from_csr(Ap, dtypes=(torch.float64,),
                                         device=self.device)

    def _refine(self, b2: torch.Tensor):
        """The refinement loop (`refine_columns`) on (n, k) f64 b2, already
        permuted. Returns (x, passes per column, ‖r‖ and ‖b‖ per column)."""
        if self.refactor:
            with full_f32():
                L = torch.linalg.cholesky(self._sym32)
            correct = lambda r32: _tri(L, r32)  # noqa: E731
        else:
            def correct(r32):
                with full_f32():
                    return torch.matmul(self._M, r32)
        residual = column_residual(lambda v: spmv_sell_f64(self._op64, v), b2)
        x, passes, rr, bb = refine_columns(b2, correct, residual, self.rtol,
                                           self.max_refine)
        return x, passes, torch.sqrt(rr), torch.sqrt(bb)

    def _solve_any(self, b):
        b = torch.as_tensor(b, device=self.device).to(torch.float64)
        b2 = b[:, None] if b.ndim == 1 else b
        bp = b2 if self._perm is None else b2[self._perm]
        x, passes, rnorm, bnorm = self._refine(bp)
        if self._inv is not None:
            x = x[self._inv]
        return (x[:, 0] if b.ndim == 1 else x), passes, rnorm, bnorm

    def solve(self, b) -> SolveResult:
        if self._delegate is not None:
            res = self._delegate.solve(b)
            res.extra["delegated"] = "sparse_cholesky"
            return res
        x, passes, rnorm, bnorm = self._solve_any(b)
        rnorm, bnorm = to_numpy(rnorm), to_numpy(bnorm)
        relres_cols = np.where(bnorm > 0, rnorm / np.maximum(bnorm, 1e-300),
                               0.0)
        relres = float(relres_cols.max())
        extra = {"refine_passes": int(passes.max())}
        if x.ndim == 2:
            extra["nrhs"] = int(x.shape[1])
            extra["relres_cols"] = relres_cols.tolist()
        return SolveResult(x=x, iters=int(passes.max()), relres=relres,
                           converged=relres <= self.rtol or bnorm.max() == 0.0,
                           extra=extra)

    def solve_fn(self):
        if self._delegate is not None:
            return self._delegate.solve_fn()
        return lambda b: self._solve_any(b)[0]
