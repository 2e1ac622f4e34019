"""Preconditioned conjugate gradient (counterpart of `lsbench_tpu/solvers/cg.py`).

The iteration is the JAX package's `cg_loop` — same state, same update
order, same stop rule (`it < maxiter and rr > tol2`) — written as a Python
loop over a state of tensors updated in place (`CgState`): `cg_start`
makes the start from b, `cg_step` is one iteration body. The stop test
reads `rr` on the host (`host_read`) once per iteration. On a CUDA device
a solver's `CgGraphs` captures the start and the body as CUDA graphs and
replays them, so the host enqueues one graph where it enqueued each
kernel; the stop test stays outside the graphs, and every kernel and the
order of operations are the eager loop's, so x is bit for bit the eager
x. The body is the span `lsbench.cg.iter` (`ops/launches.py`), around a
replay too. `build_matvec` gives
the SpMV of each layout, after an optional reordering: the sliced-ELL
kernels that replace K1 and K5 (f32) and K2 (f64) on the solver paths
(`ops/spmv_sell.py`), and the JAX package's XLA-only layouts as plain
torch ops: `ell` (`ops/spmv.py`), `bsr_xla` (`BsrMatrix.matvec_xla`) and
`dense`. The BSR kernels K1, K5 and K2 stay on the ops API
(`ops/spmv_bsr.py`).
"""

from __future__ import annotations

import time
import warnings
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from lsbench_tpu_torch.matrix.bsr import BsrMatrix
from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.ell import EllMatrix
from lsbench_tpu_torch.matrix.sell import SellMatrix
from lsbench_tpu_torch.ops import launches
from lsbench_tpu_torch.ops.launches import host_read, span
from lsbench_tpu_torch.ops.spmv import spmv_ell
from lsbench_tpu_torch.ops.spmv_sell import spmv_sell, spmv_sell_f64
from lsbench_tpu_torch.ordering import get_ordering
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu_torch.solvers.preconditioners import (check as check_precond,
                                                       build as build_precond)
from lsbench_tpu_torch.utils.debug import debug_nans_enabled
from lsbench_tpu_torch.utils.precision import full_f32

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name."""
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


START, ITER = "lsbench.cg.start", "lsbench.cg.iter"


class CgState:
    """The CG loop's tensors, updated in place: the vectors x, r and p, and
    the 0-d rz, rr, bnorm and tol2, all of `dtype`."""

    __slots__ = ("x", "r", "p", "rz", "rr", "bnorm", "tol2")

    def __init__(self, n: int, dtype, device):
        for name in ("x", "r", "p"):
            setattr(self, name, torch.empty(n, dtype=dtype, device=device))
        for name in ("rz", "rr", "bnorm", "tol2"):
            setattr(self, name, torch.empty((), dtype=dtype, device=device))


def cg_start(s: CgState, precond_apply, rtol: float) -> None:
    """The loop's start from b, which `s.r` holds: ‖b‖, tol2, x = 0,
    z = M⁻¹r, p = z, rz and rr."""
    s.bnorm.copy_(torch.sqrt(torch.dot(s.r, s.r)))
    s.tol2.copy_((rtol * s.bnorm) ** 2)
    s.x.zero_()
    z = precond_apply(s.r)
    s.p.copy_(z)
    s.rz.copy_(torch.dot(s.r, z))
    s.rr.copy_(torch.dot(s.r, s.r))


def cg_step(s: CgState, matvec, precond_apply) -> None:
    """One iteration body, each expression's operations those of
    x = x + α·p, r = r − α·Ap and p = z + β·p (p·β + z rounds as
    z + β·p)."""
    Ap = matvec(s.p)
    alpha = s.rz / torch.dot(s.p, Ap)
    s.x.add_(alpha * s.p)
    s.r.sub_(alpha * Ap)
    z = precond_apply(s.r)
    rz_new = torch.dot(s.r, z)
    s.rr.copy_(torch.dot(s.r, s.r))
    beta = rz_new / s.rz
    s.p.mul_(beta).add_(z)
    s.rz.copy_(rz_new)


def _same(t):
    return t


class CgGraphs:
    """The CUDA graphs of one solver's CG loop: the start (`cg_start`) and
    the iteration body (`cg_step`), on one `CgState` made for the loop's
    (n, dtype, device, rtol, matvec, precond_apply); another loop makes a
    new state and captures anew. Each step runs eagerly the first time
    (loading every kernel and library handle it needs), is captured the
    second time and replayed from then on; both captures share one private
    memory pool, which holds the body's temporaries for good. A replay
    adds its capture's launches to the kernel counters
    (`launches.replayed`).

    The graphs engage (`solving`) where the code can tell that they hold:
    a CUDA device and the NaN switch off (its check reads the device). A
    capture that raises leaves the graphs to the eager loop for good, with
    the reason in `failed`.

    The solver does all its device work, its set-up and each solve, on the
    graphs' stream, one per device for every solver. The eager work and
    the captures share its cuBLAS workspace (PyTorch keeps one per stream,
    of several MiB), where captures on a side stream of their own would
    add one. PyTorch's caching allocator keeps each stream's cached blocks
    apart: set-up and solves on one stream share one cache, and the first
    entry hands back what the caller's stream holds cached and unused
    (`empty_cache`, as `torch.cuda.graph` does before each capture), which
    the solver's stream could not use."""

    _streams: dict = {}   # device index → the stream the solves run on

    def __init__(self):
        self.failed: str | None = None
        self.on = False           # inside a `solving` that engaged
        self._stream = None       # set on the first `solving` that engaged
        self._key = None
        self._state: CgState | None = None
        self._pool = None
        self._graphs: dict = {}   # name → (CUDAGraph, launches, key)
        self._warm: set = set()   # steps run once on the state

    def engages(self, device) -> bool:
        return (self.failed is None and device.type == "cuda"
                and not debug_nans_enabled())

    @contextmanager
    def solving(self, device):
        """The context of the solver's device work: its set-up and each
        solve. Where the graphs engage, the body runs on the graphs'
        stream, after the caller's stream's work and before its next, and
        `cg_loop` takes the graphs; it gives `keep(t)`, which hands t back
        to the caller's stream. Elsewhere keep(t) is t and nothing
        changes."""
        if not self.engages(device):
            yield _same
            return
        caller = torch.cuda.current_stream(device)
        if self._stream is None:
            idx = caller.device_index
            if idx not in self._streams:
                self._streams[idx] = torch.cuda.Stream(caller.device)
            self._stream = self._streams[idx]
            torch.cuda.empty_cache()
        stream = self._stream

        def keep(t):
            t.record_stream(caller)
            return t
        stream.wait_stream(caller)
        self.on = True
        try:
            with torch.cuda.stream(stream):
                yield keep
        finally:
            self.on = False
            caller.wait_stream(stream)

    def state(self, b: torch.Tensor, dtype, rtol, matvec,
              precond_apply) -> CgState:
        key = (b.shape[0], dtype, b.device, rtol, matvec, precond_apply)
        if key != self._key:
            self._graphs.clear()
            self._warm.clear()
            self._state = CgState(b.shape[0], dtype, b.device)
            self._pool = torch.cuda.graph_pool_handle()
            self._key = key
        return self._state

    def run(self, name: str, fn) -> None:
        """fn(state): eagerly the first time, then as graph `name`."""
        if self.failed is not None or name not in self._warm:
            fn(self._state)
            self._warm.add(name)
            return
        entry = self._graphs.get(name)
        if entry is None:
            entry = self._capture(name, fn)
            if entry is None:
                fn(self._state)
                return
        graph, delta, key = entry
        graph.replay()
        launches.replayed(key, delta)

    def _capture(self, name: str, fn):
        before = launches.read()
        graph = torch.cuda.CUDAGraph()
        # Not `torch.cuda.graph`, whose gc.collect() and empty_cache()
        # before each capture add set-up time: the cache was handed back
        # once, on entering the graphs' stream (`solving`).
        try:
            graph.capture_begin(pool=self._pool)
            try:
                fn(self._state)
            finally:
                graph.capture_end()
        except RuntimeError as e:  # CUDA refused the capture: run eager
            launches.take_back(before)
            self.failed = f"{name}: {type(e).__name__}: {e}"
            launches.count("graph_fallbacks")
            warnings.warn(f"CUDA graph capture failed, the CG loop runs "
                          f"eager: {self.failed}", RuntimeWarning)
            return None
        entry = (graph, launches.take_back(before), f"graph_replays:{name}")
        self._graphs[name] = entry
        launches.count("graph_captures")
        return entry


def solving(graphs: CgGraphs | None, device):
    """`graphs.solving(device)`, or a context that changes nothing where a
    solver has no graphs; it gives `keep` (`CgGraphs.solving`)."""
    return nullcontext(_same) if graphs is None else graphs.solving(device)


def cg_loop(matvec, precond_apply, b, rtol, maxiter, dtype, graphs=None):
    """PCG on tensors. Returns (x, iters, rnorm, bnorm); rnorm and bnorm
    are 0-d tensors of `dtype`. The JAX package batches its dots with
    `_fused_dots` for XLA to fuse; eager PyTorch fuses nothing, so each dot
    is one `torch.dot`. Inside the `solving` of a solver's `graphs`
    (`CgGraphs`) that engaged, the start and the body replay as CUDA
    graphs; nothing returned aliases their state."""
    graphed = graphs is not None and graphs.on
    if graphed:
        s = graphs.state(b, dtype, rtol, matvec, precond_apply)
        run = graphs.run
    else:
        s = CgState(b.shape[0], dtype, b.device)
        run = lambda name, fn: fn(s)   # noqa: E731
    s.r.copy_(b)
    run(START, lambda s: cg_start(s, precond_apply, rtol))
    step = lambda s: cg_step(s, matvec, precond_apply)   # noqa: E731
    it = 0
    while it < maxiter and host_read(s.rr > s.tol2):
        with span(ITER):
            run(ITER, step)
        it += 1
    rnorm = torch.sqrt(s.rr)
    if not graphed:
        return s.x, it, rnorm, s.bnorm
    return s.x.clone(), it, rnorm, s.bnorm.clone()


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
    and GmresSolver swap it); where it is CG's, the solver holds the
    loop's `CgGraphs`."""

    _graphs: CgGraphs | None = None

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

        if type(self)._loop is CgSolver._loop:
            self._graphs = CgGraphs()
        with solving(self._graphs, self.device):
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

    def _loop(self, mv, pc, b, rtol, maxiter, dtype):
        return cg_loop(mv, pc, b, rtol, maxiter, dtype, graphs=self._graphs)

    def solve(self, b) -> SolveResult:
        b = torch.as_tensor(b, device=self.device)
        with solving(self._graphs, self.device) as keep:
            bp = b if self._perm is None else b[self._perm]
            x, iters, rnorm, bnorm = self._loop(
                self._mv, self._pc, bp, self.rtol, self.maxiter, self._dt)
            check_precond(self._pstate)
            if self._inv is not None:
                x = x[self._inv]
            x = keep(x)
            rnorm, bnorm = float(rnorm), float(bnorm)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        return SolveResult(x=x, iters=iters, relres=relres,
                           converged=relres <= self.rtol or bnorm == 0.0)
