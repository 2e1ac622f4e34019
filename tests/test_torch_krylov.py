"""Port parity for the multi-RHS solvers (`block_cg`, `batched_bicgstab`) and
the BiCGSTAB family (`bicgstab`, `bicgstab_ir`, the `ginkgo` alias) of
lsbench_tpu_torch, on the CPU with the kernels' plain versions, against the
JAX package's solvers on the same matrices and right-hand sides.

RHS blocks follow the CLI's `--nrhs k`: column 0 is r[i] = i, then k-1
columns of `default_rng(0).standard_normal`. Bars: worst-column true relres
≤ 1e-10 on both sides; x within 1e-9 relative (tests/test_dist_cg_ir.py's
bar); equal refinement passes; block iterations within max(3, 10%) (block
CG) or max(5, 15%) (BiCGSTAB, whose f32 recurrence feels the order of the
dot products' sums more than CG's).

The block-CG comparisons run at rtol 1e-11, not 1e-10: on poisson_2d(24)
the second refinement pass lands column 0 at 1.4e-10 in the JAX package
and 6.9e-11 in the port (f32 rounding of the SpMM), so at 1e-10 the pass
count is decided by that rounding (3 passes against 2). At 1e-11 no pass
of either case lands within 5× of the bar.
"""

import numpy as np
import pytest
import torch

from lsbench_tpu.matrix.csr import CsrMatrix as JCsr
from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.matrix.generate import sem_2d as j_sem_2d
from lsbench_tpu.solvers import bicgstab as j_bicgstab
from lsbench_tpu.solvers import batched_bicgstab as j_batched
from lsbench_tpu.solvers.base import get_solver as j_get_solver
from lsbench_tpu.solvers.block_cg import BlockCgSolver as JBlockCg
from lsbench_tpu.solvers.refine import BicgstabIrSolver as JBicgstabIr

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.solvers import batched_bicgstab as t_batched
from lsbench_tpu_torch.solvers import bicgstab as t_bicgstab
from lsbench_tpu_torch.solvers import get_solver
from lsbench_tpu_torch.solvers.batched_bicgstab import BatchedBicgstabSolver
from lsbench_tpu_torch.solvers.block_cg import BlockCgSolver
from lsbench_tpu_torch.solvers.refine import BicgstabIrSolver

from conftest import make_rhs


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _rhs_block(n, k):
    rng = np.random.default_rng(0)
    return np.column_stack([make_rhs(n)]
                           + [rng.standard_normal(n) for _ in range(k - 1)])


def _nonsymmetric_120():
    """The seeded 120×120 nonsymmetric matrix of test_solvers.py."""
    rng = np.random.default_rng(0)
    n = 120
    d = np.diag(10.0 + rng.random(n))
    m = (d + np.triu(rng.random((n, n)) * 0.5, 1)
         - np.tril(rng.random((n, n)) * 0.3, -1))
    m[np.abs(m) < 0.45] = 0.0
    np.fill_diagonal(m, 10.0 + rng.random(n))
    return m


def _worst_relres(A, X, B):
    return max(np.linalg.norm(B[:, j] - A.matvec(X[:, j]))
               / np.linalg.norm(B[:, j]) for j in range(B.shape[1]))


def _check_block_parity(JA, B, port, jres, iter_bar):
    X, Xj = port.x.numpy(), np.asarray(jres.x)
    assert port.converged and jres.converged
    assert port.x.dtype == torch.float64 and X.shape == B.shape
    assert _worst_relres(JA, X, B) <= 1e-10
    assert _worst_relres(JA, Xj, B) <= 1e-10
    assert np.linalg.norm(X - Xj) / np.linalg.norm(Xj) <= 1e-9
    assert port.extra["refine_passes"] == jres.extra["refine_passes"]
    assert abs(port.iters - jres.iters) <= iter_bar(jres.iters), (
        port.iters, jres.iters)
    assert port.extra["nrhs"] == B.shape[1]
    assert port.extra["precision_mode"] == "fp32_ir"
    assert max(port.extra["relres_cols"]) == port.relres


def _block_bar(it):
    return max(3, 0.10 * it)


def _bicgstab_bar(it):
    return max(5, 0.15 * it)


# (label, matrix, k, ordering, solver options). JAX on the CPU, rtol 1e-10:
# 139 block iterations / 3 passes on poisson_2d(24), 75/3 on sem_2d(8) and
# 247/3 on RCM poisson_2d(64) k=8; sem_2d(8)'s 1e-3 shift leaves
# ‖x‖ ≈ 1e3·‖b‖, and the two packages' x still agree to ~1e-11 there.
BLOCK_CASES = [
    ("poisson_2d(24)", lambda: j_poisson_2d(24), 3, "none", {}),
    ("sem_2d(8)", lambda: j_sem_2d(8), 3, "none", {}),
    ("poisson_2d(64) rcm", lambda: j_poisson_2d(64), 8, "rcm", {}),
    ("poisson_2d(24) simultaneous", lambda: j_poisson_2d(24), 3, "none",
     {"method": "simultaneous"}),
    ("poisson_2d(24) cholqr2", lambda: j_poisson_2d(24), 3, "none",
     {"qr": "cholqr2"}),
]


@pytest.mark.parametrize("label,make,k,ordering,opts", BLOCK_CASES,
                         ids=[c[0] for c in BLOCK_CASES])
def test_block_cg_matches_jax(label, make, k, ordering, opts):
    JA = make()
    B = _rhs_block(JA.nrows, k)
    kw = dict(rtol=1e-11, ordering=ordering, **opts)
    solver = BlockCgSolver(_port_csr(JA), device="cpu", **kw)
    port = solver.solve(B)
    jres = JBlockCg(JA, **kw).solve(B)
    assert port.extra["method"] == jres.extra["method"] == opts.get(
        "method", "shared")
    _check_block_parity(JA, B, port, jres, _block_bar)


def test_block_cg_rank_deficient_block():
    """Duplicate and zero columns collapse the block's rank; Householder QR
    keeps the shared recurrence alive and every column still solves
    (test_block_cg.py::test_block_cg_shared_rank_deficient_rhs)."""
    JA = j_poisson_2d(24)
    n = JA.nrows
    c = np.random.default_rng(5).standard_normal(n)
    B = np.column_stack([c, c, 2.0 * c, np.zeros(n)])
    res = BlockCgSolver(_port_csr(JA), rtol=1e-10, method="shared",
                        device="cpu").solve(B)
    X = res.x.numpy()
    assert np.all(np.isfinite(X))
    assert _worst_relres(JA, X[:, :3], B[:, :3]) <= 1e-9
    assert np.linalg.norm(X[:, 3]) <= 1e-8       # zero rhs -> zero solution
    assert res.extra["relres_cols"][3] == 0.0


def test_block_cg_1d_rhs_promotion():
    """A 1-D b solves as k=1 and comes back 1-D, through solve() and through
    the bench loop's solve_fn()."""
    JA = j_poisson_2d(16)
    b = make_rhs(JA.nrows)
    s = BlockCgSolver(_port_csr(JA), rtol=1e-10, device="cpu")
    res = s.solve(b)
    assert res.converged and res.x.shape == (JA.nrows,)
    assert res.extra["nrhs"] == 1
    x = s.solve_fn()(b)
    assert x.shape == (JA.nrows,)
    torch.testing.assert_close(x, res.x, rtol=0, atol=0)
    jx = np.asarray(JBlockCg(JA, rtol=1e-10).solve(b).x)
    assert np.linalg.norm(x.numpy() - jx) / np.linalg.norm(jx) <= 1e-9


def test_block_cg_amg_falls_back_to_simultaneous():
    """A non-diagonal preconditioner cannot split: the shared method falls
    back to the simultaneous recurrence, one AMG V-cycle per column."""
    JA = j_poisson_2d(16)
    B = _rhs_block(JA.nrows, 3)
    s = BlockCgSolver(_port_csr(JA), rtol=1e-10, precond="amg",
                      device="cpu")
    assert s.method == "simultaneous"
    res = s.solve(B)
    assert res.converged and res.extra["method"] == "simultaneous"
    assert _worst_relres(JA, res.x.numpy(), B) <= 1e-10
    jres = JBlockCg(JA, rtol=1e-10, precond="amg").solve(B)
    assert jres.extra["method"] == "simultaneous"
    # AMG contracts each column ~10× per iteration: far fewer iterations
    # than Jacobi's, on both sides.
    assert res.iters <= 30 and jres.iters <= 30


def test_block_cg_rejects_unknown_options():
    A = _port_csr(j_poisson_2d(6))
    for kw in (dict(method="nope"), dict(qr="nope")):
        with pytest.raises(ValueError):
            BlockCgSolver(A, device="cpu", **kw)


def test_batched_bicgstab_matches_jax():
    JA = j_poisson_2d(24)
    B = _rhs_block(JA.nrows, 3)
    port = BatchedBicgstabSolver(_port_csr(JA), rtol=1e-10,
                                 device="cpu").solve(B)
    jres = j_batched.BatchedBicgstabSolver(JA, rtol=1e-10).solve(B)
    _check_block_parity(JA, B, port, jres, _bicgstab_bar)


def test_batched_bicgstab_column_matches_dense_solve():
    JA = j_poisson_2d(16)
    b = make_rhs(JA.nrows)
    B = np.column_stack([b, np.ones(JA.nrows)])
    X = BatchedBicgstabSolver(_port_csr(JA), rtol=1e-10,
                              device="cpu").solve(B).x.numpy()
    np.testing.assert_allclose(X[:, 0], np.linalg.solve(JA.to_dense(), b),
                               rtol=1e-7, atol=1e-8)


def test_batched_bicgstab_breakdown_freezes_one_column():
    """A column whose preconditioner returns 0 stalls (alpha = omega = 0):
    it keeps its first iterate (0) while the other columns converge, as in
    the JAX loop."""
    JA = j_poisson_2d(12)
    D = JA.to_dense()
    B = _rhs_block(JA.nrows, 3) / 100.0
    mask = np.array([1.0, 0.0, 1.0])

    X, it, rn, r0 = t_batched.batched_bicgstab_loop(
        lambda V: torch.as_tensor(D) @ V, lambda R: R * torch.as_tensor(mask),
        torch.as_tensor(B), 1e-10, 500, torch.float64)
    import jax.numpy as jnp
    Xj, itj, rnj, _ = j_batched.batched_bicgstab_loop(
        lambda V: jnp.asarray(D) @ V, lambda R: R * jnp.asarray(mask),
        jnp.asarray(B), 1e-10, 500, jnp.float64)
    assert it == int(itj)
    X = X.numpy()
    assert np.all(X[:, 1] == 0.0) and np.all(np.asarray(Xj)[:, 1] == 0.0)
    np.testing.assert_allclose(X, np.asarray(Xj), rtol=1e-9, atol=1e-12)
    # The frozen column keeps its initial residual; the others converge.
    assert float(rn[1]) == float(r0[1])
    assert np.all(rn.numpy()[[0, 2]] <= 1e-10 * r0.numpy()[[0, 2]])
    np.testing.assert_allclose(rn.numpy(), np.asarray(rnj), rtol=1e-6,
                               atol=1e-12 * float(r0.max()))


def test_bicgstab_loop_stall_keeps_previous_iterate():
    """A zero preconditioner stalls the first step: the loop keeps x = 0 and
    stops after one iteration, as the JAX loop does."""
    import jax.numpy as jnp
    D = j_poisson_2d(8).to_dense()
    b = make_rhs(64)
    x, it, rn, r0 = t_bicgstab.bicgstab_loop(
        lambda v: torch.as_tensor(D) @ v, lambda r: 0 * r,
        torch.as_tensor(b), 1e-8, 100, torch.float64)
    xj, itj, _, _ = j_bicgstab.bicgstab_loop(
        lambda v: jnp.asarray(D) @ v, lambda r: 0 * r, jnp.asarray(b),
        1e-8, 100, jnp.float64)
    assert it == int(itj) == 1
    assert torch.all(x == 0) and float(rn) == float(r0)


# A planted breakdown: with r̂0 = b = e1 and A[0,1] = A[2,0] = 0 the first
# step gives r1 ⟂ r̂0 exactly (rho = 0 at iteration 2, in any precision).
_RHO0_A = np.array([[2.0, 0.0, 1.0], [1.0, 3.0, 0.0], [0.0, 1.0, 4.0]])
_RHO0_B = np.array([1.0, 0.0, 0.0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_bicgstab_shadow_restart_passes_exact_breakdown(dtype):
    """The port's one departure from the JAX loop: where rho = (r̂0, r)
    falls to rounding noise (here to exactly 0) the JAX loop stops at its
    previous iterate, the port restarts the shadow from r and converges."""
    import jax.numpy as jnp
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    x, it, rn, r0 = t_bicgstab.bicgstab_loop(
        lambda v: torch.as_tensor(_RHO0_A, dtype=dtype) @ v, lambda r: r,
        torch.as_tensor(_RHO0_B), 1e-6, 50, dtype)
    xj, itj, rnj, _ = j_bicgstab.bicgstab_loop(
        lambda v: jnp.asarray(_RHO0_A, jdt) @ v, lambda r: r,
        jnp.asarray(_RHO0_B), 1e-6, 50, jdt)
    # JAX: breakdown at iteration 2, x = x1 = (0.5, -0.15, 0), relres 0.158.
    assert int(itj) == 2 and float(rnj) > 0.1
    np.testing.assert_allclose(np.asarray(xj), [0.5, -0.15, 0.0], atol=1e-6)
    # Port: one restart, then the 3×3 system is solved.
    assert x.dtype == dtype and 2 < it <= 6
    assert float(rn) <= 1e-6 * float(r0)
    np.testing.assert_allclose(x.double().numpy(),
                               np.linalg.solve(_RHO0_A, _RHO0_B),
                               rtol=1e-5, atol=1e-6)


def test_batched_bicgstab_shadow_restart_is_per_column():
    """Only the column that breaks down restarts: the planted column
    converges in the port (JAX freezes it at x1), the other columns take
    the same steps as the JAX loop."""
    import jax.numpy as jnp
    B = np.column_stack([_RHO0_B, [1.0, 2.0, 3.0], [0.0, 1.0, 0.0]])
    X, it, rn, r0 = t_batched.batched_bicgstab_loop(
        lambda V: torch.as_tensor(_RHO0_A) @ V, lambda R: R,
        torch.as_tensor(B), 1e-10, 50, torch.float64)
    Xj, itj, rnj, _ = j_batched.batched_bicgstab_loop(
        lambda V: jnp.asarray(_RHO0_A) @ V, lambda R: R, jnp.asarray(B),
        1e-10, 50, jnp.float64)
    X, Xj = X.numpy(), np.asarray(Xj)
    np.testing.assert_allclose(X, np.linalg.solve(_RHO0_A, B), atol=1e-12)
    assert np.all(rn.numpy() <= 1e-10 * r0.numpy())
    assert float(rnj[0]) > 0.1                   # JAX: column 0 frozen at x1
    np.testing.assert_allclose(X[:, 1:], Xj[:, 1:], atol=1e-12)


# Single-RHS BiCGSTAB: (label, port CSR + JAX CSR).
def _bicgstab_matrices():
    m = _nonsymmetric_120()
    return {"poisson_2d(12)": (j_poisson_2d(12),),
            "nonsymmetric(120)": (JCsr.from_dense(m),)}


@pytest.mark.parametrize("name", ["poisson_2d(12)", "nonsymmetric(120)"])
@pytest.mark.parametrize("rtol", [1e-4, 1e-10])
def test_fp64_bicgstab_delegates_to_bicgstab_ir(name, rtol):
    """fp64 bicgstab runs as bicgstab_ir with inner_rtol = min(1e-5,
    0.1·rtol), on every device (the JAX package's TPU branch); it is held
    to the JAX package's BicgstabIrSolver with those arguments."""
    (JA,) = _bicgstab_matrices()[name]
    b = make_rhs(JA.nrows)
    cls, params = get_solver("bicgstab")
    s = cls(_port_csr(JA), rtol=rtol, device="cpu", **params)
    assert isinstance(s._delegate, BicgstabIrSolver)
    assert s._delegate.inner_rtol == min(1e-5, 0.1 * rtol)
    port = s.solve(b)
    assert port.extra["precision_mode"] == "fp32_ir_auto"
    jres = JBicgstabIr(JA, rtol=rtol, inner_rtol=min(1e-5, 0.1 * rtol),
                       maxiter=max(10 * JA.nrows, 1000)).solve(b)
    x, xj = port.x.numpy(), np.asarray(jres.x)
    assert port.converged and jres.converged
    tr = np.linalg.norm(b - JA.matvec(x)) / np.linalg.norm(b)
    assert tr <= rtol
    assert port.extra["refine_passes"] == jres.extra["refine_passes"]
    assert abs(port.iters - jres.iters) <= _bicgstab_bar(jres.iters), (
        port.iters, jres.iters)
    # Both stop at the f64 true residual ≤ rtol·‖b‖: x agrees to the
    # solution's accuracy, cond(A)·rtol, with cond ≈ 60 (poisson_2d(12))
    # and ≈ 2 (the diagonally dominant 120×120).
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= 100 * rtol


@pytest.mark.parametrize("name", ["poisson_2d(12)", "nonsymmetric(120)"])
def test_fp32_bicgstab_matches_jax(name):
    (JA,) = _bicgstab_matrices()[name]
    b = make_rhs(JA.nrows)
    port = get_solver("bicgstab")[0](_port_csr(JA), dtype="float32",
                                     rtol=1e-5, device="cpu").solve(b)
    jres = j_get_solver("bicgstab")[0](JA, dtype="float32",
                                       rtol=1e-5).solve(b)
    assert port.x.dtype == torch.float32
    assert port.converged and jres.converged
    assert "precision_mode" not in port.extra
    assert abs(port.iters - jres.iters) <= _bicgstab_bar(jres.iters)
    x, xj = port.x.numpy().astype(np.float64), np.asarray(jres.x, np.float64)
    # Both at f32 with relres ≤ 1e-5: x within cond(A)·1e-5.
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= 1e-3


def test_sim_bicgstab_follows_the_solver():
    """The host simulation of the `ginkgo --nrhs k` refinement (scipy's f32
    product in place of K3) takes the solver's passes and, within the
    BiCGSTAB bar, its iterations on the CLI's RHS block."""
    import io

    from lsbench_tpu_torch.harness.bench import reference_rhs
    from lsbench_tpu_torch.harness.sim_bicgstab import simulate
    from lsbench_tpu_torch.matrix.generate import poisson_2d

    out = io.StringIO()
    sim = simulate(32, 3, out=out)
    A = poisson_2d(32)
    res = BatchedBicgstabSolver(A, ordering="rcm", device="cpu").solve(
        reference_rhs(A.nrows, 3))
    assert res.converged and sim["relres"] <= 1e-4
    assert sim["passes"] == res.extra["refine_passes"]
    assert abs(sim["iters"] - res.iters) <= _bicgstab_bar(res.iters)
    assert out.getvalue().count("pass ") == sim["passes"]


def test_ginkgo_alias_preset():
    cls, params = get_solver("ginkgo")
    j_cls, j_params = j_get_solver("ginkgo")
    assert cls.name == j_cls.name == "bicgstab"
    assert params == j_params == {"precond": "jacobi", "rtol": 1e-4}
    JA = j_poisson_2d(10)
    b = make_rhs(JA.nrows)
    res = cls(_port_csr(JA), device="cpu", **params).solve(b)
    assert res.converged and res.relres <= 1e-4
    assert np.linalg.norm(b - JA.matvec(res.x.numpy())) <= 1e-4 * np.linalg.norm(b)
