"""Benchmark protocol (counterpart of `lsbench_tpu/harness/bench.py`):
setup/solve split, warmups, wall-clock timing, the reference CSV record.

Wall time via `time.perf_counter`, fenced with `device_fence` (PyTorch
queues CUDA work asynchronously, so the clock is read only after the
device has finished); warmups independent of trials; setup timed apart from
solve; the CSV record always emitted.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from lsbench_tpu_torch.solvers.base import Solver, true_relres
from lsbench_tpu_torch.utils import device_fence


@dataclass
class BenchRecord:
    matrix: str
    n: int
    nnz: int
    trials: int
    solver: str
    ordering: str
    elapsed: float           # wall seconds for `trials` solves (reference CSV field)
    setup_s: float = 0.0
    solve_s: float = 0.0     # per-solve average
    iters: int = 0
    relres: float = float("nan")
    converged: bool = True
    precision: str = "fp64"
    extra: dict = field(default_factory=dict)

    # Exact reference CSV schema (cusparse.c:207-209; cholmod-impl.h:68-70;
    # ginkgo.cpp:110-112).
    CSV_HEADER = "===matrix,n,nnz,trials,solver,ordering,elapsed==="

    def csv_line(self) -> str:
        return (f"{self.matrix},{self.n},{self.nnz},{self.trials},"
                f"{self.solver},{self.ordering},{self.elapsed:.6e}")

    def to_json(self) -> dict:
        d = {
            "matrix": self.matrix, "n": self.n, "nnz": self.nnz,
            "trials": self.trials, "solver": self.solver,
            "ordering": self.ordering, "elapsed": self.elapsed,
            "setup_s": self.setup_s, "solve_s": self.solve_s,
            "iters": self.iters, "relres": self.relres,
            "converged": self.converged, "precision": self.precision,
            "nnz_per_s": (self.nnz * max(self.iters, 1)
                          * self.extra.get("nrhs", 1)) / self.solve_s
            if self.solve_s > 0 else None,
        }
        d.update(self.extra)
        return d


def reference_rhs(n: int, nrhs: int = 1) -> np.ndarray:
    """The reference RHS r[i] = i (lsbench.c:158-160). For nrhs > 1 (an
    extension: lsbench is single-RHS) column 0 is that vector and the other
    columns are seeded pseudo-random, the JAX CLI's `--nrhs` block."""
    b = np.arange(n, dtype=np.float64)
    if nrhs == 1:
        return b
    rng = np.random.default_rng(0)
    return np.column_stack([b] + [rng.standard_normal(n)
                                  for _ in range(nrhs - 1)])


def run_bench(
    solver: Solver,
    b,
    trials: int,
    warmups: int = 2,
    matrix_name: str = "",
    ordering: str = "none",
    precision: str = "fp64",
    setup_s: float = 0.0,
) -> BenchRecord:
    """Run the timed-trials protocol on an already-set-up solver."""
    fn = solver.solve_fn()

    # The first call is timed apart: it carries the kernels' build and
    # load and the first launches.
    t0 = time.perf_counter()
    device_fence(fn(b))
    first_call_s = time.perf_counter() - t0
    for _ in range(max(warmups - 1, 0)):
        device_fence(fn(b))

    t0 = time.perf_counter()
    out = None
    for _ in range(trials):
        out = fn(b)
    device_fence(out)
    elapsed = time.perf_counter() - t0

    # One reporting solve for iteration count / residual (outside timing).
    res = solver.solve(b)
    relres = true_relres(solver.A, res.x, b)

    # A precision substitution (fp64 requested, run as f32 cycles or f32 +
    # f64 refinement) shows in the `precision` field itself, e.g.
    # "fp64(fp32_cycles_auto)": the reference enforces FP64
    # (lsbench.c:140-141).
    mode = res.extra.get("precision_mode")
    if mode:
        base = mode[: -len("_auto")] if mode.endswith("_auto") else mode
        if base not in precision:
            precision = f"{precision}({mode})"

    return BenchRecord(
        matrix=matrix_name, n=solver.A.nrows, nnz=solver.A.nnz,
        trials=trials, solver=solver.name, ordering=ordering,
        elapsed=elapsed, setup_s=setup_s, solve_s=elapsed / max(trials, 1),
        iters=res.iters, relres=res.relres, converged=res.converged,
        precision=precision,
        extra={"true_relres": relres,
               "first_call_s": first_call_s,
               **({"setup_breakdown": solver.setup_breakdown}
                  if solver.setup_breakdown else {}),
               **res.extra},
    )
