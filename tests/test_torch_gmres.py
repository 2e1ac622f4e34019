"""Port parity for restarted GMRES (`gmres_loop`, `gmres`, `gmres_ir`) and the
`block_jacobi` and `chebyshev` preconditioners of lsbench_tpu_torch, on the
CPU with the kernels' plain versions, against the JAX package on the same
matrices and right-hand sides (the JAX package runs f64 on the CPU).

Bars: `gmres_loop` in f64 takes the same number of restart cycles and x
agrees within 1e-9 relative; in f32 at the residual floor the port's
stagnation stop ends the loop where the JAX loop runs to its cap, at the
same floor (within 1.5×); `gmres_ir` takes the same refinement passes
and reaches true relres ≤ 1e-10 on both sides; the block-Jacobi apply is
exact (1e-10) on a block-diagonal matrix; the Chebyshev apply agrees with
the JAX one within 1e-12 in f64; fp64 CG with each new preconditioner on
`layout=ell` takes the same iterations and x agrees within 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsbench_tpu.matrix.csr import CsrMatrix as JCsr
from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.matrix.generate import random_spd as j_random_spd
from lsbench_tpu.ordering.rcm import rcm_ordering as j_rcm
from lsbench_tpu.solvers import gmres as j_gmres
from lsbench_tpu.solvers import preconditioners as j_pc
from lsbench_tpu.solvers.base import get_solver as j_get_solver
from lsbench_tpu.solvers.cg import build_matvec as j_build_matvec
from lsbench_tpu.solvers.refine import GmresIrSolver as JGmresIr

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.solvers import gmres as t_gmres
from lsbench_tpu_torch.solvers import get_solver
from lsbench_tpu_torch.solvers import preconditioners as t_pc
from lsbench_tpu_torch.solvers.cg import build_matvec
from lsbench_tpu_torch.solvers.refine import GmresIrSolver

from conftest import make_rhs

CPU = torch.device("cpu")


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _nonsymmetric_150():
    """The seeded 150×150 nonsymmetric matrix of tests/test_gmres.py."""
    rng = np.random.default_rng(3)
    n = 150
    m = np.diag(8.0 + rng.random(n)) + np.triu(rng.random((n, n)), 1) * 0.4
    m[np.abs(m) < 0.35] = 0.0
    np.fill_diagonal(m, 8.0 + rng.random(n))
    return JCsr.from_dense(m)


MATRICES = {
    "poisson_2d(20)": (lambda: j_poisson_2d(20), 30),
    "nonsymmetric(150)": (_nonsymmetric_150, 25),
}


def _rcm(JA):
    return JA.permuted(j_rcm(JA))


def _true_relres(JA, x, b):
    return np.linalg.norm(b - JA.matvec(x)) / np.linalg.norm(b)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_gmres_loop_f64_matches_jax(name):
    make, m = MATRICES[name]
    JA = make()
    A = _port_csr(JA)
    b = make_rhs(JA.nrows)
    rtol, max_restarts = 1e-10, 200
    apply_mv, op = build_matvec(A, "bsr_df64", CPU)
    pstate, papply = t_pc.jacobi_precond(A, torch.float64, CPU)
    x, iters, rnorm, bnorm = t_gmres.gmres_loop(
        lambda v: apply_mv(op, v), lambda r: papply(pstate, r),
        torch.as_tensor(b), rtol, max_restarts, m, torch.float64)
    j_mv, j_op, _ = j_build_matvec(JA, jnp.float64, "ell")
    j_state, j_apply = j_pc.jacobi_precond(JA, jnp.float64)
    xj, iters_j, rnorm_j, bnorm_j = j_gmres.gmres_loop(
        lambda v: j_mv(j_op, v), lambda r: j_apply(j_state, r),
        jnp.asarray(b), rtol, max_restarts, m, jnp.float64)
    x, xj = x.numpy(), np.asarray(xj)
    assert iters == int(iters_j) and iters % m == 0
    assert iters < max_restarts * m
    assert float(rnorm) <= rtol * float(bnorm)
    assert _true_relres(JA, x, b) <= 1e-10
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= 1e-9
    np.testing.assert_allclose(float(bnorm), float(bnorm_j), rtol=1e-15)


def test_gmres_loop_f32_stagnation_stop():
    """The port's one addition to the JAX loop: in f32 the recomputed
    residual of RCM poisson_2d(64) with Jacobi has a floor above rtol 1e-5.
    The JAX loop runs on to its cap of 60 cycles there; the port stops
    after the first cycle that does not lower ‖r‖, at the same floor."""
    JA = _rcm(j_poisson_2d(64))
    A = _port_csr(JA)
    b = make_rhs(JA.nrows) / np.linalg.norm(make_rhs(JA.nrows))
    rtol, cap, m = 1e-5, 60, 30
    apply_mv, op = build_matvec(A, "bsr", CPU)
    pstate, papply = t_pc.jacobi_precond(A, torch.float32, CPU)
    x, iters, rnorm, bnorm = t_gmres.gmres_loop(
        lambda v: apply_mv(op, v), lambda r: papply(pstate, r),
        torch.as_tensor(b, dtype=torch.float32), rtol, cap, m,
        torch.float32)
    j_mv, j_op, _ = j_build_matvec(JA, jnp.float32, "ell")
    j_state, j_apply = j_pc.jacobi_precond(JA, jnp.float32)
    xj, iters_j, rnorm_j, bnorm_j = j_gmres.gmres_loop(
        lambda v: j_mv(j_op, v), lambda r: j_apply(j_state, r),
        jnp.asarray(b, dtype=jnp.float32), rtol, cap, m, jnp.float32)
    assert int(iters_j) == cap * m and float(rnorm_j) > rtol * float(bnorm_j)
    assert iters < cap * m // 2 and float(rnorm) > rtol * float(bnorm)
    floor = _true_relres(JA, np.asarray(xj, dtype=np.float64), b)
    assert _true_relres(JA, x.double().numpy(), b) <= 1.5 * floor


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_gmres_ir_matches_jax(name):
    make, m = MATRICES[name]
    JA = make()
    b = make_rhs(JA.nrows)
    kw = dict(rtol=1e-10, restart=m, ordering="rcm")
    port = GmresIrSolver(_port_csr(JA), device="cpu", **kw).solve(b)
    jres = JGmresIr(JA, **kw).solve(b)
    assert port.converged and jres.converged
    assert port.extra["refine_passes"] == jres.extra["refine_passes"]
    assert port.x.dtype == torch.float64
    assert _true_relres(JA, port.x.numpy(), b) <= 1e-10
    assert _true_relres(JA, np.asarray(jres.x), b) <= 1e-10
    assert port.iters % m == 0


def test_gmres_fp64_delegates_to_gmres_ir(capsys):
    """fp64 `gmres` runs `gmres_ir` (the JAX package's TPU branch, decided
    for every device) and says so; its result is `gmres_ir`'s."""
    JA = _nonsymmetric_150()
    A = _port_csr(JA)
    b = make_rhs(JA.nrows)
    cls, params = get_solver("gmres")
    solver = cls(A, rtol=1e-10, restart=25, device="cpu", **params)
    assert "fp32_ir_auto" in capsys.readouterr().err
    res = solver.solve(b)
    assert res.extra["precision_mode"] == "fp32_ir_auto"
    ref = GmresIrSolver(A, rtol=1e-10, restart=25, device="cpu").solve(b)
    assert torch.equal(res.x, ref.x) and res.iters == ref.iters
    # The JAX package's CPU branch runs f64 GMRES: the same solution.
    jres = j_get_solver("gmres")[0](JA, rtol=1e-10, restart=25).solve(b)
    assert _true_relres(JA, res.x.numpy(), b) <= 1e-10
    assert _true_relres(JA, np.asarray(jres.x), b) <= 1e-10


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_gmres_fp32_reaches_its_rtol(name):
    make, m = MATRICES[name]
    JA = make()
    b = make_rhs(JA.nrows)
    cls, params = get_solver("gmres")
    solver = cls(_port_csr(JA), dtype="float32", rtol=1e-5, restart=m,
                 device="cpu", **params)
    res = solver.solve(b)
    assert solver._delegate is None and res.x.dtype == torch.float32
    assert res.converged and res.iters % m == 0
    assert _true_relres(JA, res.x.double().numpy(), b) <= 1e-5
    jres = j_get_solver("gmres")[0](JA, dtype=jnp.float32, rtol=1e-5,
                                    restart=m).solve(b)
    assert res.iters == jres.iters


def test_block_jacobi_apply_exact_on_block_diagonal():
    """On a block-diagonal matrix the preconditioner is the exact inverse
    (tests/test_gmres.py's case), and it is the JAX apply."""
    rng = np.random.default_rng(8)
    k, nb = 8, 4
    m = np.zeros((k * nb, k * nb))
    for i in range(nb):
        q = rng.random((k, k))
        m[i * k:(i + 1) * k, i * k:(i + 1) * k] = q @ q.T + k * np.eye(k)
    JA = JCsr.from_dense(m)
    state, apply = t_pc.block_jacobi_precond(_port_csr(JA), torch.float64,
                                             CPU, block_size=k)
    r = rng.random(k * nb)
    z = apply(state, torch.as_tensor(r))
    assert z.dtype == torch.float64 and z.shape == (k * nb,)
    np.testing.assert_allclose(z.numpy(), np.linalg.solve(m, r), rtol=1e-10)
    j_state, j_apply = j_pc.block_jacobi_precond(JA, jnp.float64,
                                                 block_size=k)
    np.testing.assert_allclose(z.numpy(),
                               np.asarray(j_apply(j_state, jnp.asarray(r))),
                               rtol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_block_jacobi_padded_last_block_matches_jax(dtype):
    """n not a multiple of the block size: identity rows pad the last
    block, and the apply is the JAX one in either dtype."""
    JA = _rcm(j_random_spd(300, nnz_per_row=9, seed=1))
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    state, apply = t_pc.block_jacobi_precond(_port_csr(JA), dtype, CPU)
    assert state.shape == (10, 32, 32) and state.dtype == dtype
    r = np.random.default_rng(2).standard_normal(300)
    z = apply(state, torch.as_tensor(r, dtype=dtype))
    j_state, j_apply = j_pc.block_jacobi_precond(JA, jdt)
    zj = np.asarray(j_apply(j_state, jnp.asarray(r, dtype=jdt)))
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(z.numpy(), zj, rtol=tol,
                               atol=tol * np.abs(zj).max())


@pytest.mark.parametrize("degree", [2, 4])
def test_chebyshev_apply_matches_jax(degree):
    JA = _rcm(j_poisson_2d(20))
    state, apply = t_pc.chebyshev_precond(_port_csr(JA), torch.float64, CPU,
                                          degree=degree)
    j_state, j_apply = j_pc.chebyshev_precond(JA, jnp.float64, degree=degree)
    r = np.random.default_rng(4).standard_normal(JA.nrows)
    z = apply(state, torch.as_tensor(r)).numpy()
    zj = np.asarray(j_apply(j_state, jnp.asarray(r)))
    assert np.abs(z - zj).max() <= 1e-12 * np.abs(zj).max()


@pytest.mark.parametrize("precond", ["block_jacobi", "chebyshev"])
def test_fp64_cg_with_new_precond_matches_jax(precond):
    JA = _rcm(j_poisson_2d(20))
    b = make_rhs(JA.nrows)
    kw = dict(rtol=1e-10, layout="ell", precond=precond)
    cls, params = get_solver("cg")
    port = cls(_port_csr(JA), device="cpu", **{**params, **kw}).solve(b)
    j_cls, j_params = j_get_solver("cg")
    jres = j_cls(JA, **{**j_params, **kw}).solve(b)
    x, xj = port.x.numpy(), np.asarray(jres.x)
    assert port.converged and jres.converged
    assert port.iters == jres.iters
    assert _true_relres(JA, x, b) <= 1e-10
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= 1e-9


@pytest.mark.parametrize("precond", ["block_jacobi", "chebyshev"])
def test_cg_ir_with_new_precond_matches_jax(precond):
    """The paths `chip_smoke.py` drives at full width: cg_ir + RCM with
    each new preconditioner, the same passes and true relres ≤ 1e-10.
    poisson_2d(40): its second pass lands at 3.0-6.6e-10 in both packages,
    3× or more from the bar; on poisson_2d(20) and (24) it lands within
    2× of 1e-10 (4.3e-11 against 8.0e-11, 1.06e-10 against 6.4e-11 with
    Chebyshev), where the f32 rounding of the inner SpMV decides the pass
    count."""
    from lsbench_tpu.solvers.refine import CgIrSolver as JCgIr
    from lsbench_tpu_torch.solvers.refine import CgIrSolver
    JA = j_poisson_2d(40)
    b = make_rhs(JA.nrows)
    kw = dict(rtol=1e-10, ordering="rcm", precond=precond)
    port = CgIrSolver(_port_csr(JA), device="cpu", **kw).solve(b)
    jres = JCgIr(JA, **kw).solve(b)
    assert port.converged and jres.converged
    assert port.extra["refine_passes"] == jres.extra["refine_passes"]
    assert _true_relres(JA, port.x.numpy(), b) <= 1e-10
