"""Preconditioned conjugate gradient (counterpart of `lsbench_tpu/solvers/cg.py`).

The iteration is the JAX package's `cg_loop` — same state, same update
order, same stop rule (`it < maxiter and rr > tol2`) — written as a Python
loop over a state of tensors updated in place (`CgState`): `cg_start`
makes the start from b, `cg_step` is one iteration body. The eager loop
reads the stop test on the host (`host_read`) once per iteration, each
body the span `lsbench.cg.iter` (`ops/launches.py`). On a CUDA device a
solver's `CgGraphs` captures the start as a CUDA graph, and the body into
a block graph of up to `SLOTS` slots, each a conditional (if) node that runs
`cg_step` only where the stop rule, evaluated on the device by one guard
kernel, says go on (`ops/graph_if.py`); the host replays a block and reads the
iteration count once per block (the span `lsbench.cg.block`). Where the
if-nodes fail, the body is replayed as a graph of its own, one per
iteration, with the stop test read before each. Every kernel and the order of
operations are the eager loop's, so x is bit for bit the eager x.
`build_matvec` gives
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
from lsbench_tpu_torch.ops import graph_if, launches
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


START, ITER, BLOCK = "lsbench.cg.start", "lsbench.cg.iter", "lsbench.cg.block"

# The most guarded iterations in a block graph, one host read each block: a
# skipped slot costs its guard and its node, ~8 µs on an H100 (PERF.md §6,
# the sweep of 8, 16, 32).
SLOTS = 16


class CgState:
    """The CG loop's tensors, updated in place: the vectors x, r and p, and
    the 0-d rz, rr, bnorm and tol2, all of `dtype`; and the iteration count
    `it` (0-d int64), which only the block graph keeps."""

    __slots__ = ("x", "r", "p", "rz", "rr", "bnorm", "tol2", "it")

    def __init__(self, n: int, dtype, device):
        for name in ("x", "r", "p"):
            setattr(self, name, torch.empty(n, dtype=dtype, device=device))
        for name in ("rz", "rr", "bnorm", "tol2"):
            setattr(self, name, torch.empty((), dtype=dtype, device=device))
        self.it = torch.zeros((), dtype=torch.int64, device=device)


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


def eager_iterations(s: CgState, step, maxiter: int, it: int = 0) -> int:
    """The eager loop from `it` iterations done: the stop test read on the
    host before each iteration, each body the span `lsbench.cg.iter`;
    returns the iterations done."""
    while it < maxiter and host_read(s.rr > s.tol2):
        with span(ITER):
            step(s)
        it += 1
    return it


def block_slots(first: int) -> int:
    """The block's slots, from the iterations of the first pass on a
    state: one more, so that a pass as long takes one block and one read
    and skips one slot; at most `SLOTS`, and `SLOTS` where that pass made
    none (b = 0)."""
    return min(SLOTS, first + 1) if first else SLOTS


def block_goes_on(it: int, enqueued: int, maxiter: int) -> bool:
    """The host's rule after a block, from the iterations done so far in
    the pass (`it`, read from the device) and the slots enqueued: another
    block only where every slot ran and maxiter is not reached. A slot
    that did not run met the stop rule, and every later slot meets it
    too, so the pass ends after the eager loop's iteration count."""
    return it == enqueued and it < maxiter


def _same(t):
    return t


class CgGraphs:
    """The CUDA graphs of one solver's CG loop: the start (`cg_start`) and
    the block of guarded iterations (`cg_step`), on one `CgState` made for
    the loop's (n, dtype, device, rtol, maxiter, matvec, precond_apply);
    another loop makes a new state and captures anew. Each runs eagerly
    the first time (loading every kernel and library handle it needs; the
    first pass on the state is the eager loop, whose count sets the
    block's slots, `block_slots`), is captured the second time and
    replayed from then on. The captures share one private memory pool and
    the block's if-node bodies one `MemPool` of their own; the pools hold
    the temporaries for good. A replay adds its capture's launches to the
    kernel counters: the block's, one slot's body for each iteration that
    ran and its guard for each slot (`launches.replayed`).

    The graphs engage (`solving`) where the code can tell that they hold:
    a CUDA device and the NaN switch off (its check reads the device). A
    capture of the start or of a body that raises leaves the graphs to the
    eager loop for good, with the reason in `failed`. Where the if-node
    library does not load, or the block's capture raises (the reason in
    `block_failed`), the body is a graph of its own, replayed once an
    iteration after the host's stop test (`lsbench.cg.iter`).

    The solver does all its device work, its set-up and each solve, on the
    graphs' stream, one per device for every solver. The eager work and
    the captures share its cuBLAS workspace (PyTorch keeps one per stream,
    of several MiB), where captures on a side stream of their own would
    add one. PyTorch's caching allocator keeps each stream's cached blocks
    apart: set-up and solves on one stream share one cache, and the first
    entry hands back what the caller's stream holds cached and unused
    (`empty_cache`, as `torch.cuda.graph` does before each capture), which
    the solver's stream could not use."""

    _streams: dict = {}   # device index → (the stream the solves run on,
                          #   the stream the block graph is captured on)

    def __init__(self):
        self.failed: str | None = None
        self.block_failed: str | None = None
        self.on = False           # inside a `solving` that engaged
        self._stream = None       # set on the first `solving` that engaged
        self._block_stream = None
        self._slots = SLOTS       # the block's slots, from the first pass
        self._limit = None        # maxiter, 0-d int64 on the device
        self._key = None
        self._state: CgState | None = None
        self._pool = None
        self._body_pool = None    # the block's if-node bodies' MemPool
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
                self._streams[idx] = (torch.cuda.Stream(caller.device),
                                      torch.cuda.Stream(caller.device))
            self._stream, self._block_stream = self._streams[idx]
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

    def state(self, b: torch.Tensor, dtype, rtol, maxiter, matvec,
              precond_apply) -> CgState:
        key = (b.shape[0], dtype, b.device, rtol, maxiter, matvec,
               precond_apply)
        if key != self._key:
            self._graphs.clear()
            self._warm.clear()
            self._state = CgState(b.shape[0], dtype, b.device)
            self._pool = torch.cuda.graph_pool_handle()
            self._limit = torch.full((), maxiter, dtype=torch.int64,
                                     device=b.device)
            self._key = key
        return self._state

    def iterate(self, maxiter: int, step) -> int:
        """The iterations of one pass, from the state the start left;
        returns their count. The first pass on the state is the eager
        loop, and its count sets the block's slots; the next captures the
        block (after the start, so that PyTorch puts its generators' graph
        state, made at the first capture, on the solver's stream), and
        each pass from then on replays it, one read of `it` a block. Where
        if-nodes failed, from the block whose capture raised on, a graph
        an iteration after the host's stop test."""
        s = self._state
        if BLOCK not in self._warm:
            self._warm.add(BLOCK)
            try:
                graph_if.load(s.it.device)
            except (RuntimeError, OSError) as e:
                self._refused(BLOCK, e)
            it = eager_iterations(s, step, maxiter)
            self._slots = block_slots(it)
            return it
        it = enqueued = 0
        while self.block_failed is None and self.failed is None:
            with span(BLOCK):
                done = self._block(step, it)
            if done is None:           # the capture raised: nothing ran
                break
            it, enqueued = done, enqueued + self._slots
            if not block_goes_on(it, enqueued, maxiter):
                return it
        return eager_iterations(s, lambda _: self.run(ITER, step), maxiter,
                                it)

    def _block(self, step, it: int) -> int | None:
        """One replay of the block graph from `it` iterations done;
        returns the iterations done after it, or None where its capture
        raised. The block is captured on a stream of its own and each
        if-node's body on the solver's stream (`graph_if.if_node`)."""
        s = self._state
        entry = self._graphs.get(BLOCK)
        if entry is None:
            guard = (s.it, self._limit, s.rr, s.tol2)   # the stop rule's
            self._body_pool = torch.cuda.MemPool()

            def block():
                for _ in range(self._slots):
                    with graph_if.if_node(*guard, self._stream,
                                          self._body_pool):
                        step(s)
            entry = self._capture(BLOCK, block, self._slots,
                                  self._block_stream)
            if entry is None:
                return None
        graph, delta, key = entry
        graph.replay()
        done = host_read(s.it)
        launches.replayed(key, delta, done - it, self._slots)
        launches.count(f"graph_slots:{BLOCK}", self._slots)
        return done

    def run(self, name: str, fn) -> None:
        """fn(state): eagerly the first time, then as graph `name`."""
        if self.failed is not None or name not in self._warm:
            fn(self._state)
            self._warm.add(name)
            return
        entry = self._graphs.get(name)
        if entry is None:
            entry = self._capture(name, lambda: fn(self._state))
            if entry is None:
                fn(self._state)
                return
        graph, delta, key = entry
        graph.replay()
        launches.replayed(key, delta)

    def _capture(self, name: str, body, slots: int = 1, stream=None):
        """Graph `name` of body(), captured on `stream` (default: the
        current one): (graph, one slot's launches, its replay counter), or
        None where CUDA refused the capture."""
        before = launches.read()
        graph = torch.cuda.CUDAGraph()
        # Not `torch.cuda.graph`, whose gc.collect() and empty_cache()
        # before each capture add set-up time: the cache was handed back
        # once, on entering the graphs' stream (`solving`).
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=self._pool)
                try:
                    body()
                finally:
                    graph.capture_end()
        except RuntimeError as e:
            launches.take_back(before)
            self._refused(name, e)
            return None
        delta = tuple((counts, key, n // slots)
                      for counts, key, n in launches.take_back(before))
        entry = (graph, delta, f"graph_replays:{name}")
        self._graphs[name] = entry
        launches.count("graph_captures")
        return entry

    def _refused(self, name: str, e: Exception) -> None:
        """CUDA refused graph `name`: after the block's, a graph an
        iteration; after another, the eager loop, for good."""
        why = f"{name}: {type(e).__name__}: {e}"
        launches.count("graph_fallbacks")
        if name == BLOCK:
            self.block_failed = why
            warnings.warn(f"CUDA graph if-nodes failed, the CG loop replays "
                          f"a graph an iteration: {why}", RuntimeWarning)
        else:
            self.failed = why
            warnings.warn(f"CUDA graph capture failed, the CG loop runs "
                          f"eager: {why}", RuntimeWarning)


def solving(graphs: CgGraphs | None, device):
    """`graphs.solving(device)`, or a context that changes nothing where a
    solver has no graphs; it gives `keep` (`CgGraphs.solving`)."""
    return nullcontext(_same) if graphs is None else graphs.solving(device)


def cg_loop(matvec, precond_apply, b, rtol, maxiter, dtype, graphs=None):
    """PCG on tensors. Returns (x, iters, rnorm, bnorm); rnorm and bnorm
    are 0-d tensors of `dtype`. The JAX package batches its dots with
    `_fused_dots` for XLA to fuse; eager PyTorch fuses nothing, so each dot
    is one `torch.dot`. Inside the `solving` of a solver's `graphs`
    (`CgGraphs`) that engaged, the start and the iterations replay as CUDA
    graphs; nothing returned aliases their state."""
    step = lambda s: cg_step(s, matvec, precond_apply)   # noqa: E731
    if graphs is None or not graphs.on:
        s = CgState(b.shape[0], dtype, b.device)
        s.r.copy_(b)
        cg_start(s, precond_apply, rtol)
        it = eager_iterations(s, step, maxiter)
        return s.x, it, torch.sqrt(s.rr), s.bnorm

    def start(s):
        cg_start(s, precond_apply, rtol)
        s.it.zero_()
    s = graphs.state(b, dtype, rtol, maxiter, matvec, precond_apply)
    s.r.copy_(b)
    graphs.run(START, start)
    it = graphs.iterate(maxiter, step)
    return s.x.clone(), it, torch.sqrt(s.rr), s.bnorm.clone()


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
