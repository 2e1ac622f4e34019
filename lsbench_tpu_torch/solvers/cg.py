"""Preconditioned conjugate gradient (counterpart of `lsbench_tpu/solvers/cg.py`).

The iteration is the JAX package's `cg_loop` — same state, same update
order, same stop rule (`it < maxiter and rr > tol2`) — written as a Python
loop. The stop test reads `rr` on the host (`host_read`), which
synchronizes with the device once per iteration; capturing the loop body
in a CUDA graph to remove that sync is a later step (ROADMAP). The body
is the span `lsbench.cg.iter` (`ops/launches.py`). `build_matvec` gives
the SpMV of each layout, after an optional reordering: the sliced-ELL
kernels that replace K1 and K5 (f32) and K2 (f64) on the solver paths
(`ops/spmv_sell.py`), and the JAX package's XLA-only layouts as plain
torch ops: `ell` (`ops/spmv.py`), `bsr_xla` (`BsrMatrix.matvec_xla`) and
`dense`. The BSR kernels K1, K5 and K2 stay on the ops API
(`ops/spmv_bsr.py`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lsbench_tpu_torch.matrix.bsr import BsrMatrix
from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.ell import EllMatrix
from lsbench_tpu_torch.matrix.sell import SellMatrix
from lsbench_tpu_torch.ops.launches import host_read, span
from lsbench_tpu_torch.ops.spmv import spmv_ell
from lsbench_tpu_torch.ops.spmv_sell import spmv_sell, spmv_sell_f64
from lsbench_tpu_torch.ordering import get_ordering
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu_torch.solvers.preconditioners import (check as check_precond,
                                                       build as build_precond)
from lsbench_tpu_torch.utils.precision import full_f32

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
    while it < maxiter and host_read(rr > tol2):
        with span("lsbench.cg.iter"):
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
    """"auto" takes the JAX package's TPU branch on every device: "bsr" for
    f32, "bsr_df64" (f64-accurate) for f64."""
    if layout != "auto":
        return layout
    return "bsr" if as_dtype(dtype) == torch.float32 else "bsr_df64"


def _dense_matvec(op: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    with full_f32():
        return torch.matmul(op, v.to(op.dtype))


def build_matvec(A: CsrMatrix, layout: str, device, dtype=torch.float32):
    """Return (apply_fn, op) for the chosen layout; `apply_fn(op, v)` runs
    the SpMV. `dtype` is the operator's for "dense", "ell" and "bsr_xla";
    the kernel layouts fix their own.

    The names are the JAX package's, so that the CLI, the record and the
    AMG layout model stay comparable; on the card the BSR layouts are
    sliced ELL:
      "bsr"          f32 SellMatrix and `spmv_sell` (the redesigned K1: the
                     uniform 8×128 BSR; where the JAX package's
                     `classed_layout_wins(A)` picks its class-padded layout
                     instead, the port's product is the same);
      "bsr_classed"  the same (the redesigned K5);
      "bsr_df64"     f64 SellMatrix and `spmv_sell_f64` (the redesigned K2).
    "dense" (small coarse AMG levels), "ell" and "bsr_xla" are the JAX
    package's XLA-only layouts: plain torch ops on the device, outside any
    kernel of this package."""
    if layout == "dense":
        op = torch.as_tensor(A.to_dense(), dtype=as_dtype(dtype), device=device)
        return _dense_matvec, op
    if layout == "ell":
        return spmv_ell, EllMatrix.from_csr(A, dtype=as_dtype(dtype),
                                            device=device)
    if layout == "bsr_xla":
        op = BsrMatrix.from_csr(A, dtype=as_dtype(dtype), device=device,
                                with_sel=True)
        return BsrMatrix.matvec_xla, op
    if layout in ("bsr", "bsr_classed"):
        return spmv_sell, SellMatrix.from_csr(A, dtypes=(torch.float32,),
                                              device=device)
    if layout == "bsr_df64":
        return spmv_sell_f64, SellMatrix.from_csr(A, dtypes=(torch.float64,),
                                                  device=device)
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
    """Jacobi-preconditioned CG with an optional reordering and the SpMV of
    the chosen layout. `_loop` is the Krylov iteration (BicgstabSolver
    swaps it)."""

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
        apply_mv, self._op = build_matvec(Ap, self.layout, self.device,
                                           dtype=self.dtype)
        self.setup_breakdown["layout_s"] = time.perf_counter() - t0
        self._dt = torch.float32 if self.layout == "bsr" else self.dtype
        # The f32 kernels take f32 x (an f64 CG on an f32 operator casts).
        mv_dt = (torch.float32 if self.layout in ("bsr", "bsr_classed")
                 else self._dt)
        self._mv = lambda v: apply_mv(self._op, v.to(mv_dt)).to(self._dt)
        self._mv_dtype = mv_dt
        # The bytes the layout streams per SpMV, for the roofline report.
        self.stream_bytes = getattr(self._op, "bytes_streamed", None)
        self._pstate, papply = build_precond(
            precond, Ap, self._dt, self.device, precond_params,
            self.setup_breakdown)
        self._pc = lambda r: papply(self._pstate, r)

    def solve(self, b) -> SolveResult:
        b = torch.as_tensor(b, device=self.device)
        bp = b if self._perm is None else b[self._perm]
        x, iters, rnorm, bnorm = self._loop(self._mv, self._pc, bp, self.rtol,
                                            self.maxiter, self._dt)
        check_precond(self._pstate)
        if self._inv is not None:
            x = x[self._inv]
        rnorm, bnorm = float(rnorm), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        return SolveResult(x=x, iters=iters, relres=relres,
                           converged=relres <= self.rtol or bnorm == 0.0)
