"""Port parity: cg_ir and fp64 cg of lsbench_tpu_torch (on the CPU, with the
kernels' plain versions) against the JAX package's solvers on the same
matrices and right-hand side. The bars: true relres ≤ 1e-10 on both sides,
‖x_port − x_jax‖/‖x_jax‖ ≤ 1e-9 (tests/test_dist_cg_ir.py's x bar), and
total inner iterations within 5%."""

import numpy as np
import pytest
import torch

from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.matrix.generate import random_spd as j_random_spd
from lsbench_tpu.matrix.generate import sem_2d as j_sem_2d
from lsbench_tpu.solvers.base import get_solver as j_get_solver

from lsbench_tpu_torch.matrix.bsr import BsrClassed, BsrMatrix
from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.solvers import get_solver

from conftest import make_rhs

MATRICES = {
    "poisson_2d(24)": lambda: j_poisson_2d(24),
    "sem_2d(8)": lambda: j_sem_2d(8),
    "random_spd(300)": lambda: j_random_spd(300),
}


def _solve(get, name, A, b, **kw):
    cls, params = get(name)
    params.update(kw)
    solver = cls(A, **params)
    return solver, solver.solve(b)


def _true_relres(JA, x, b):
    return np.linalg.norm(b - JA.matvec(x)) / np.linalg.norm(b)


def _check_parity(JA, b, port, jax_res):
    x_port = port.x.numpy()
    x_jax = np.asarray(jax_res.x)
    # sem_2d(8) stalls near relres 2e-12 on both sides (its f64 floor at
    # rtol 1e-12): the two packages must agree on convergence, not both
    # reach 1e-12.
    assert port.converged == jax_res.converged
    assert _true_relres(JA, x_port, b) <= 1e-10
    assert _true_relres(JA, x_jax, b) <= 1e-10
    assert np.linalg.norm(x_port - x_jax) / np.linalg.norm(x_jax) <= 1e-9
    assert abs(port.iters - jax_res.iters) <= 0.05 * jax_res.iters, (
        port.iters, jax_res.iters)


@pytest.mark.parametrize("name,layout", [
    *((name, "bsr") for name in sorted(MATRICES)),
    ("poisson_2d(24)", "bsr_classed"),
])
def test_cg_ir_matches_jax(name, layout):
    JA = MATRICES[name]()
    A = CsrMatrix(JA.nrows, JA.ncols, JA.offs, JA.cols, JA.vals)
    b = make_rhs(A.nrows)
    kw = dict(layout=layout, ordering="rcm", rtol=1e-12)
    solver, port = _solve(get_solver, "cg_ir", A, b, device="cpu", **kw)
    _, jax_res = _solve(j_get_solver, "cg_ir", JA, b, **kw)
    assert isinstance(solver._op,
                      BsrClassed if layout == "bsr_classed" else BsrMatrix)
    assert port.x.device.type == "cpu" and port.x.dtype == torch.float64
    assert port.extra["refine_passes"] >= 2
    _check_parity(JA, b, port, jax_res)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_fp64_cg_matches_jax(name):
    JA = MATRICES[name]()
    A = CsrMatrix(JA.nrows, JA.ncols, JA.offs, JA.cols, JA.vals)
    b = make_rhs(A.nrows)
    solver, port = _solve(get_solver, "cg", A, b, device="cpu",
                          ordering="rcm", rtol=1e-12)
    assert solver.layout == "bsr_df64"
    # The JAX package's fp64 CG off the TPU runs its f64 ELL SpMV.
    _, jax_res = _solve(j_get_solver, "cg", JA, b, ordering="rcm",
                        rtol=1e-12)
    _check_parity(JA, b, port, jax_res)


@pytest.mark.parametrize("grid", [13, 17])
def test_fp64_cg_dense_layout_matches_jax(grid):
    """fp64 CG on the dense layout runs an f64 operator: the solver hands
    `build_matvec` its dtype (with the f32 default the x stalls ~1e-7 from
    the JAX x)."""
    JA = j_poisson_2d(grid)
    A = CsrMatrix(JA.nrows, JA.ncols, JA.offs, JA.cols, JA.vals)
    b = make_rhs(A.nrows)
    kw = dict(layout="dense", rtol=1e-12)
    _, port = _solve(get_solver, "cg", A, b, device="cpu", **kw)
    _, jax_res = _solve(j_get_solver, "cg", JA, b, **kw)
    x, x_jax = port.x.numpy(), np.asarray(jax_res.x)
    assert port.converged and jax_res.converged
    assert _true_relres(JA, x, b) <= 1e-10
    assert np.linalg.norm(x - x_jax) / np.linalg.norm(x_jax) <= 1e-9


def test_unported_options_raise():
    from lsbench_tpu_torch.matrix.generate import poisson_2d
    A = poisson_2d(6)
    cls, _ = get_solver("cg")
    for kw in (dict(precond="ic0"), dict(ordering="amd")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cls(A, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown layout"):
        cls(A, device="cpu", layout="csr")
