"""Solver registry and result types (counterpart of `lsbench_tpu/solvers/base.py`).

Solvers self-register by name, `get_solver` resolves them, and reference
backend names are aliases onto native solvers (harness/cli.py).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix


def to_numpy(x) -> np.ndarray:
    """f64 host copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def true_relres(A: CsrMatrix, x, b) -> float:
    """Host-side f64 ||b - Ax|| / ||b||, independent of the device path.
    For multi-RHS (2-D) solves, the worst column's."""
    xh, bh = to_numpy(x), to_numpy(b)
    if xh.ndim == 2:
        return max(true_relres(A, xh[:, j], bh[:, j])
                   for j in range(xh.shape[1]))
    bn = float(np.linalg.norm(bh))
    if bn == 0.0:
        return 0.0
    return float(np.linalg.norm(bh - A.matvec(xh))) / bn


@dataclass
class SolveResult:
    """One solve's outcome."""

    x: Any  # solution tensor on the solver's device
    iters: int = 0
    relres: float = float("nan")
    converged: bool = True
    extra: dict = field(default_factory=dict)


class Solver(abc.ABC):
    """A solver instance bound to one matrix and one device.

    `__init__` does all per-matrix work (ordering, layout build and upload,
    preconditioner) so that `solve` is the timed hot path.
    """

    name: str = "base"

    def __init__(self, A: CsrMatrix, dtype=None, **params):
        self.A = A
        self.params = params
        # Wall-seconds per setup phase ("ordering_s", "layout_s", ...),
        # reported in the JSON record.
        self.setup_breakdown: dict[str, float] = {}

    @abc.abstractmethod
    def solve(self, b) -> SolveResult:
        """Solve A x = b. Must be safe to call repeatedly (bench trials)."""

    def solve_fn(self) -> Callable[[Any], Any]:
        """`fn(b) -> x` for the bench loop: one full solve, the solution
        tensor only."""
        return lambda b: self.solve(b).x

    def matvec_op(self):
        """(matvec_fn, nnz, stream_bytes, x_dtype) for the roofline report,
        or None if the solver has no streaming SpMV (a direct solver, AMG).
        The JAX package's triple plus the dtype of the x that `matvec_fn`
        takes: the port's kernels do not cast."""
        mv = getattr(self, "_mv", None)
        stream = getattr(self, "stream_bytes", None)
        if mv is None or stream is None:
            return None
        return mv, self.A.nnz, stream, getattr(self, "_mv_dtype",
                                                torch.float32)


_REGISTRY: dict[str, type[Solver]] = {}
_ALIASES: dict[str, tuple[str, dict]] = {}


def register_solver(name: str):
    def deco(cls: type[Solver]):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def register_alias(alias: str, target: str, **default_params):
    """Map a reference backend name to a native solver + parameter preset."""
    _ALIASES[alias] = (target, default_params)


def get_solver(name: str) -> tuple[type[Solver], dict]:
    """Resolve a solver name (case-insensitive) to (class, default_params)."""
    key = name.lower()
    if key in _ALIASES:
        target, params = _ALIASES[key]
        return _REGISTRY[target], dict(params)
    if key in _REGISTRY:
        return _REGISTRY[key], {}
    raise KeyError(f"unknown solver '{name}'. Available: {', '.join(list_solvers())}")


def list_solvers() -> list[str]:
    return sorted(_REGISTRY) + sorted(_ALIASES)
