"""Preconditioned conjugate gradient (counterpart of `lsbench_tpu/solvers/cg.py`).

The iteration is the JAX package's `cg_loop` — same state, same update
order, same stop rule (`it < maxiter and rr > tol2`) — written as a Python
loop. The stop test reads `rr` on the host, which synchronizes with the
device once per iteration; capturing the loop body in a CUDA graph to
remove that sync is a later step (ROADMAP). The matvec is one of the BSR
SpMV kernels (`ops/spmv_bsr.py`), after an optional RCM reordering that
densifies the blocks.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from lsbench_tpu_torch.matrix.bsr import (BsrClassed, BsrDf64, BsrMatrix,
                                          classed_layout_wins)
from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ops.spmv_bsr import (spmv_bsr, spmv_bsr_classed,
                                            spmv_bsr_df64)
from lsbench_tpu_torch.ordering import get_ordering
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu_torch.solvers.preconditioners import get_preconditioner

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name."""
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


def cg_loop(matvec, precond_apply, b, rtol, maxiter, dtype):
    """PCG on tensors. Returns (x, iters, rnorm, bnorm); rnorm and bnorm
    are 0-d tensors of `dtype`. The JAX package batches its dots with
    `_fused_dots` for XLA to fuse; eager PyTorch fuses nothing, so each dot
    is one `torch.dot`."""
    b = b.to(dtype)
    bnorm = torch.sqrt(torch.dot(b, b))
    tol2 = (rtol * bnorm) ** 2

    x = torch.zeros_like(b)
    r = b
    z = precond_apply(r)
    p = z
    rz, rr = torch.dot(r, z), torch.dot(r, r)
    it = 0
    while it < maxiter and bool(rr > tol2):
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond_apply(r)
        rz_new, rr = torch.dot(r, z), torch.dot(r, r)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it, torch.sqrt(rr), bnorm


def resolve_layout(layout: str, dtype) -> str:
    """"auto" takes the JAX package's TPU branch on every device: the f32
    BSR kernel for f32, the f64-accurate BSR kernel for f64."""
    if layout != "auto":
        return layout
    return "bsr" if as_dtype(dtype) == torch.float32 else "bsr_df64"


@contextlib.contextmanager
def full_f32():
    """Run f32 matrix products and triangular solves in full f32 whatever
    the global TF32 switches say (JAX's `Precision.HIGHEST`)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _dense_matvec(op: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    with full_f32():
        return torch.matmul(op, v.to(op.dtype))


def build_matvec(A: CsrMatrix, layout: str, device, dtype=torch.float32):
    """Return (apply_fn, op) for the chosen layout; `apply_fn(op, v)` runs
    the SpMV. `dtype` is the dense layout's; the BSR layouts fix their own.

    "dense" (small coarse AMG levels) is one library matrix-vector product
    on the dense operator, outside any kernel of this package, as the JAX
    package leaves it to XLA."""
    if layout == "dense":
        op = torch.as_tensor(A.to_dense(), dtype=as_dtype(dtype), device=device)
        return _dense_matvec, op
    if layout == "bsr":
        if classed_layout_wins(A):
            layout = "bsr_classed"
        else:
            op = BsrMatrix.from_csr(A, dtype=torch.float32, device=device)
            return spmv_bsr, op
    if layout == "bsr_classed":
        op = BsrClassed.from_csr(A, dtype=torch.float32, device=device)
        return spmv_bsr_classed, op
    if layout == "bsr_df64":
        op = BsrDf64.from_csr(A, device=device)
        return spmv_bsr_df64, op
    if layout in ("ell", "bsr_xla"):
        raise NotImplementedError(
            f"layout '{layout}' is not yet ported to lsbench_tpu_torch "
            "(ROADMAP.md Queue 1)")
    raise ValueError(f"unknown layout '{layout}'")


def permutation(ordering: str, A: CsrMatrix, device):
    """(A reordered, perm, inverse perm) with the permutations as device
    index tensors, or None for the identity."""
    perm = get_ordering(ordering, A)
    if np.array_equal(perm, np.arange(A.nrows)):
        return A, None, None
    inv = np.empty_like(perm)
    inv[perm] = np.arange(A.nrows)
    return (A.permuted(perm), torch.as_tensor(perm, device=device),
            torch.as_tensor(inv, device=device))


@register_solver("cg")
class CgSolver(Solver):
    """Jacobi-preconditioned CG with optional RCM reordering and a BSR
    SpMV kernel. `_loop` is the Krylov iteration (BicgstabSolver swaps it)."""

    _loop = staticmethod(cg_loop)

    def __init__(self, A: CsrMatrix, dtype=torch.float64, precond="jacobi",
                 rtol=1e-8, maxiter=None, layout="auto", ordering="none",
                 precond_params=None, device="cuda", **params):
        super().__init__(A, **params)
        self.device = torch.device(device)
        self.dtype = as_dtype(dtype)
        self.rtol = float(rtol)
        self.maxiter = int(maxiter) if maxiter is not None else max(10 * A.nrows, 1000)
        self.layout = resolve_layout(layout, self.dtype)
        self.ordering = ordering

        t0 = time.perf_counter()
        Ap, self._perm, self._inv = permutation(ordering, A, self.device)
        self.setup_breakdown["ordering_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        apply_mv, self._op = build_matvec(Ap, self.layout, self.device)
        self.setup_breakdown["layout_s"] = time.perf_counter() - t0
        self._dt = torch.float32 if self.layout == "bsr" else self.dtype
        self._mv = lambda v: apply_mv(self._op, v).to(self._dt)
        self._pstate, papply = get_preconditioner(precond)(
            Ap, self._dt, self.device, **(precond_params or {}))
        self._pc = lambda r: papply(self._pstate, r)

    def solve(self, b) -> SolveResult:
        b = torch.as_tensor(b, device=self.device)
        bp = b if self._perm is None else b[self._perm]
        x, iters, rnorm, bnorm = self._loop(self._mv, self._pc, bp, self.rtol,
                                            self.maxiter, self._dt)
        if self._inv is not None:
            x = x[self._inv]
        rnorm, bnorm = float(rnorm), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        return SolveResult(x=x, iters=iters, relres=relres,
                           converged=relres <= self.rtol or bnorm == 0.0)
