"""Port parity: AMG (solvers/amg.py, solvers/classical_amg.py, ops/spgemm.py)
against the JAX package on the same matrices.

- The host hierarchy (A, P, R, dinv, dinv_l1, rho per level, the coarse A)
  is bit-identical, and so are the device layouts chosen per operator
  (where the JAX package lays an operator out as BSR, the port builds the
  sliced ELL of the same CSR: the redesigned K1 and K5).
- One cycle of each smoother, on the same hierarchy in f32, agrees to f32
  rounding.
- Solvers: the port runs on the CPU with the kernels' plain versions; the
  JAX package on the CPU with its default layout (ELL), so no Pallas kernel
  runs in interpret mode here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.matrix.generate import poisson_3d as j_poisson_3d
from lsbench_tpu.matrix.generate import sem_2d as j_sem_2d
from lsbench_tpu.ops.spgemm import spgemm as j_spgemm
from lsbench_tpu.ordering.rcm import rcm_ordering as j_rcm
from lsbench_tpu.solvers import amg as jamg
from lsbench_tpu.solvers.base import get_solver as j_get_solver

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.generate import poisson_3d, random_spd
from lsbench_tpu_torch.matrix.sell import SellMatrix
from lsbench_tpu_torch.ops.interp_well import WindowEll
from lsbench_tpu_torch.ops.spgemm import drop_small, spgemm
from lsbench_tpu_torch.solvers import amg as tamg
from lsbench_tpu_torch.solvers import get_solver
from lsbench_tpu_torch.solvers.cg import full_f32

from conftest import make_rhs

CPU = torch.device("cpu")
# The classical preset of the hypre/amgx aliases and `--precond amg_classical`.
PRESET = dict(coarsening="classical", theta=0.5, interp="jacobi",
              interp_passes=3, interp_omega=0.5, pmax=8)


def _port(M) -> CsrMatrix:
    return CsrMatrix(M.nrows, M.ncols, M.offs, M.cols, M.vals)


def _assert_csr_equal(a, b, what):
    assert a.shape == b.shape, what
    for f in ("offs", "cols", "vals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{what}.{f}")


def _solve(get, name, A, b, **kw):
    cls, params = get(name)
    params.update(kw)
    return cls(A, **params).solve(b)


def _relres(JA, x, b):
    return np.linalg.norm(b - JA.matvec(x)) / np.linalg.norm(b)


# ------------------------------------------------------------ host setup

def test_spgemm_and_drop_small_match_jax():
    rng = np.random.default_rng(0)
    a = rng.random((40, 30))
    a[a < 0.7] = 0
    b = rng.random((30, 25))
    b[b < 0.7] = 0
    A, B = CsrMatrix.from_dense(a), CsrMatrix.from_dense(b)
    C = spgemm(A, B)
    _assert_csr_equal(C, j_spgemm(A, B), "A@B")
    np.testing.assert_allclose(C.to_dense(), a @ b, atol=1e-13)
    _assert_csr_equal(A.transpose(), CsrMatrix.from_dense(a.T), "A^T")
    D = drop_small(C, 0.5)
    keep = (np.abs(C.vals) > 0.5 * np.repeat(
        np.maximum.reduceat(np.abs(C.vals), C.offs[:-1]), np.diff(C.offs)))
    keep |= C.row_indices() == C.cols
    assert D.nnz == int(keep.sum())


def test_spgemm_numpy_fallback_only_when_native_is_unavailable(monkeypatch):
    from lsbench_tpu_torch.native import NativeUnavailable
    from lsbench_tpu_torch.native import spgemm as native

    A = _port(j_poisson_2d(6))
    expect = spgemm(A, A)

    def unavailable(*_):
        raise NativeUnavailable("no toolchain")

    monkeypatch.setattr(native, "spgemm_native", unavailable)
    np.testing.assert_allclose(spgemm(A, A).to_dense(), expect.to_dense(),
                               atol=1e-13)

    def broken(*_):
        raise RuntimeError("native spgemm fill failed (rc=2)")

    monkeypatch.setattr(native, "spgemm_native", broken)
    with pytest.raises(RuntimeError, match="fill failed"):
        spgemm(A, A)


HIERARCHY_CASES = {
    "classical_direct": dict(coarsening="classical", interp="direct"),
    "classical_jacobi": PRESET,
    "classical_ext+i": dict(coarsening="classical", interp="ext+i"),
    "sa": dict(coarsening="sa"),
    "sa_pairwise": dict(coarsening="sa_pairwise"),
    "pairwise": dict(coarsening="pairwise"),
    "classical_reorder_coarse": dict(coarsening="classical",
                                     reorder_coarse=True),
}


@pytest.mark.parametrize("case", sorted(HIERARCHY_CASES))
def test_matrix_hierarchy_is_bit_identical(case):
    JA = j_poisson_2d(32)
    kw = HIERARCHY_CASES[case]
    j_mats, j_coarse = jamg.build_matrix_hierarchy(JA, jamg.AmgOptions(**kw))
    mats, coarse = tamg.build_matrix_hierarchy(_port(JA),
                                               tamg.AmgOptions(**kw))
    assert len(mats) == len(j_mats) >= 2
    for l, (m, jm) in enumerate(zip(mats, j_mats)):
        for k in ("A", "P", "R"):
            _assert_csr_equal(m[k], jm[k], f"level {l} {k}")
        for k in ("dinv", "dinv_l1"):
            np.testing.assert_array_equal(m[k], jm[k])
        assert m["rho"] == jm["rho"]
    _assert_csr_equal(coarse, j_coarse, "coarse A")


def _layout_arrays(op):
    """The arrays of a device layout, numpy, in a fixed order."""
    if isinstance(op, SellMatrix):
        return [np.asarray(op.cols), np.asarray(op.slice_off),
                np.asarray(op.vals)]
    if hasattr(op, "lcols"):
        return [np.asarray(op.vals), np.asarray(op.lcols), np.asarray(op.w0)]
    if hasattr(op, "oidx"):
        return [np.asarray(a) for a in (*op.blocks, *op.bcols, *op.oidx)]
    if hasattr(op, "block_cols"):
        return [np.asarray(op.blocks), np.asarray(op.block_cols)]
    return [np.asarray(op)]  # dense


LAYOUT_CASES = {
    # window-ELL transfers on levels 0 and 1
    "poisson_2d(64) theta=0.25": (lambda: j_poisson_2d(64),
                                  dict(coarsening="classical", theta=0.25)),
    "poisson_2d(48) RCM preset": (lambda: _rcm(j_poisson_2d(48)), PRESET),
    # dense coarse operators
    "poisson_3d(7) sa": (lambda: j_poisson_3d(7), dict(coarse_n=32)),
    "sem_2d(8) preset": (lambda: j_sem_2d(8), PRESET),
}


def _rcm(A):
    return A.permuted(j_rcm(A))


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_device_layouts_match_jax(case):
    make, kw = LAYOUT_CASES[case]
    JA = make()
    j_params, j_aps, j_L = jamg.build_hierarchy(
        JA, jamg.AmgOptions(**kw), jnp.float32, "bsr")
    j_mats, _ = jamg.build_matrix_hierarchy(JA, jamg.AmgOptions(**kw))
    params, aps, L = tamg.build_hierarchy(
        _port(JA), tamg.AmgOptions(**kw), torch.float32, "bsr", CPU)
    names = {"ArrayImpl": "Tensor", "BsrMatrix": "SellMatrix",
             "BsrClassed": "SellMatrix"}
    kinds = set()
    for lp, jlp, jm in zip(params, j_params, j_mats, strict=True):
        for k in ("a", "p", "r"):
            jname = type(jlp[k]).__name__
            assert type(lp[k]).__name__ == names.get(jname, jname), (k, jname)
            kinds.add(type(lp[k]).__name__)
            theirs = jlp[k]
            if isinstance(lp[k], SellMatrix):
                # The JAX BSR operator's CSR, laid out as the port's SELL.
                theirs = SellMatrix.from_csr(_port(jm[k.upper()]),
                                             device=CPU)
            for mine, ref in zip(_layout_arrays(lp[k]),
                                 _layout_arrays(theirs), strict=True):
                np.testing.assert_array_equal(mine, ref)
        for k in ("inv_diag", "inv_l1"):
            np.testing.assert_array_equal(lp[k].numpy(), np.asarray(jlp[k]))
    np.testing.assert_array_equal(L.numpy(), np.asarray(j_L))
    assert [ap["rho"] for ap in aps] == [ap["rho"] for ap in j_aps]
    assert kinds & {"WindowEll", "Tensor"}, kinds


# ----------------------------------------------------------------- cycle

@pytest.mark.parametrize("smoother", ["chebyshev", "jacobi", "l1_jacobi",
                                      "l1_gs"])
def test_one_cycle_matches_jax(smoother):
    """One V-cycle of each smoother on the same (RCM-ordered, coarse-RCM)
    hierarchy in f32: the JAX package on its ELL layout, the port on the
    plain versions of its BSR and window-ELL kernels."""
    JA = _rcm(j_poisson_2d(40))
    kw = dict(PRESET, smoother=smoother, degree=2, reorder_coarse=True)
    j_params, j_aps, j_L = jamg.build_hierarchy(
        JA, jamg.AmgOptions(**kw), jnp.float32, "ell")
    params, aps, L = tamg.build_hierarchy(
        _port(JA), tamg.AmgOptions(**kw), torch.float32, "bsr", CPU)
    if smoother == "l1_gs":
        Lblk, d_l1 = jamg.l1_gs_blocks(JA)
        mine = tamg.l1_gs_blocks(_port(JA))
        np.testing.assert_array_equal(mine[0], Lblk)
        np.testing.assert_array_equal(mine[1], d_l1)
    b = np.random.default_rng(3).standard_normal(JA.nrows)
    x0 = np.random.default_rng(4).standard_normal(JA.nrows)
    j_cycle = jamg.make_vcycle(j_aps, jamg.AmgOptions(**kw), jnp.float32)
    cycle = tamg.make_vcycle(aps, tamg.AmgOptions(**kw), torch.float32)
    y_jax = np.asarray(j_cycle(j_params, j_L, jnp.asarray(b, jnp.float32),
                               jnp.asarray(x0, jnp.float32)))
    with full_f32():
        y = cycle(params, L, torch.as_tensor(b, dtype=torch.float32),
                  torch.as_tensor(x0, dtype=torch.float32))
    assert y.dtype == torch.float32
    # f32 sums in another order, through a few levels: 1e-5 of max|y|.
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=0,
                               atol=1e-5 * np.abs(y_jax).max())


# ---------------------------------------------------------------- solvers

SOLVER_CASES = [(m, s) for m in ("poisson_2d(24)", "sem_2d(8)")
                for s in ("amgx", "hypre", "paralmond")]
SOLVER_MATRICES = {"poisson_2d(24)": lambda: j_poisson_2d(24),
                   "sem_2d(8)": lambda: j_sem_2d(8)}


@pytest.mark.parametrize("mname,solver", SOLVER_CASES)
def test_fixed_cycle_backends_match_jax(mname, solver):
    """The port (fp64 requested → f32 cycles, as on the JAX package's TPU
    branch) against the JAX package's f32 solve on the CPU.

    x agrees to 1e-4 relative. Where the JAX package's own f32 solve is
    farther than that from its f64 solve (hypre's two cycles on sem_2d(8),
    whose 1e-3 shift leaves ‖x‖ ≈ 1e3·‖b‖, so the second cycle runs at f32's
    rounding floor), the bar is ten times that spread. The relres of both
    (host f64, from the returned x) agree to 1e-4 relative plus the f32
    rounding floor of a residual, ε32·‖A‖∞·‖x‖/‖b‖: an f32 x carries
    rounding of ε32·|x|, which moves ‖b − Ax‖ by up to that much."""
    JA = SOLVER_MATRICES[mname]()
    b = make_rhs(JA.nrows)
    port = _solve(get_solver, solver, _port(JA), b, device="cpu")
    j32 = _solve(j_get_solver, solver, JA, b, dtype=jnp.float32)
    j64 = _solve(j_get_solver, solver, JA, b, dtype=jnp.float64)
    assert port.extra["precision_mode"] == "fp32_cycles_auto"
    assert port.extra["mode"] == j32.extra["mode"]
    assert port.extra["levels"] == j32.extra["levels"]
    assert port.iters == j32.iters
    x = port.x.numpy().astype(np.float64)
    x32, x64 = np.asarray(j32.x, np.float64), np.asarray(j64.x)
    nrm = np.linalg.norm
    spread = nrm(x32 - x64) / nrm(x64)
    assert nrm(x - x32) / nrm(x32) <= max(1e-4, 10 * spread)
    r, r32 = _relres(JA, x, b), _relres(JA, x32, b)
    a_inf = np.abs(JA.to_dense()).sum(1).max()
    floor = np.finfo(np.float32).eps * a_inf * nrm(x32) / nrm(b)
    assert abs(r - r32) <= 1e-4 * r32 + floor, (r, r32, floor)
    assert abs(port.relres - r) <= 1e-4 * r + floor


def test_converge_mode_ir_matches_jax_f64():
    JA = j_poisson_2d(24)
    b = make_rhs(JA.nrows)
    port = _solve(get_solver, "amg", _port(JA), b, rtol=1e-10, device="cpu")
    jax_res = _solve(j_get_solver, "amg", JA, b, rtol=1e-10)
    assert port.extra["precision_mode"] == "fp32_ir_auto"
    assert port.x.dtype == torch.float64
    assert port.converged and jax_res.converged
    assert _relres(JA, port.x.numpy(), b) <= 1e-10
    assert _relres(JA, np.asarray(jax_res.x), b) <= 1e-10
    assert abs(port.iters - jax_res.iters) <= 1, (port.iters, jax_res.iters)


@pytest.mark.parametrize("precond,mname", [
    ("amg_classical", "poisson_2d(24)"), ("amg_classical", "sem_2d(8)"),
    ("amg", "poisson_2d(24)")])
def test_cg_ir_with_amg_precond_matches_jax(precond, mname):
    JA = SOLVER_MATRICES[mname]()
    b = make_rhs(JA.nrows)
    kw = dict(precond=precond, ordering="rcm", rtol=1e-12)
    port = _solve(get_solver, "cg_ir", _port(JA), b, device="cpu", **kw)
    jax_res = _solve(j_get_solver, "cg_ir", JA, b, **kw)
    x, xj = port.x.numpy(), np.asarray(jax_res.x)
    assert _relres(JA, x, b) <= 1e-10 and _relres(JA, xj, b) <= 1e-10
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= 1e-9
    assert abs(port.iters - jax_res.iters) <= max(2, 0.1 * jax_res.iters), (
        port.iters, jax_res.iters)


def test_l1_gs_precond_keeps_the_rcm_path():
    """amg_precond with the ℓ1-GS smoother bands A by RCM internally and
    applies Pᵀ M⁻¹ P: the port's preconditioned CG converges like the
    JAX package's."""
    JA = j_poisson_2d(20)
    b = make_rhs(JA.nrows)
    kw = dict(precond="amg", precond_params=dict(smoother="l1_gs"),
              rtol=1e-12)
    port = _solve(get_solver, "cg_ir", _port(JA), b, device="cpu", **kw)
    jax_res = _solve(j_get_solver, "cg_ir", JA, b, **kw)
    x, xj = port.x.numpy(), np.asarray(jax_res.x)
    assert _relres(JA, x, b) <= 1e-10
    assert np.linalg.norm(x - xj) / np.linalg.norm(xj) <= 1e-9
    assert abs(port.iters - jax_res.iters) <= 2


def test_amg_3d_and_random():
    for A in (poisson_3d(7), random_spd(300, seed=2)):
        b = make_rhs(A.nrows)
        res = _solve(get_solver, "amg", A, b, rtol=1e-8, maxiter=80,
                     coarse_n=32, device="cpu")
        assert res.converged, f"n={A.nrows} relres={res.relres}"


def test_kcycle_converges_no_slower_than_v():
    A = _port(j_poisson_2d(24))
    b = make_rhs(A.nrows)
    its = {c: _solve(get_solver, "amg", A, b, rtol=1e-8, cycle=c,
                     device="cpu").iters for c in ("v", "k")}
    assert its["k"] <= its["v"], its


def test_aliases_are_the_jax_presets():
    from lsbench_tpu_torch.solvers.preconditioners import AMG_CLASSICAL
    assert AMG_CLASSICAL == PRESET
    for name in ("hypre", "amgx", "paralmond"):
        cls, params = get_solver(name)
        j_cls, j_params = j_get_solver(name)
        assert cls.name == j_cls.name == "amg"
        assert params == j_params, name


def test_window_ell_runs_in_the_cycle():
    """The transfer operators of a banded classical hierarchy go through
    the window-ELL wrapper (plain version on the CPU)."""
    A = _port(j_poisson_2d(64))
    params, aps, _ = tamg.build_hierarchy(
        A, tamg.AmgOptions(coarsening="classical", theta=0.25),
        torch.float32, "bsr", CPU)
    assert isinstance(params[0]["p"], WindowEll)
    assert isinstance(params[0]["a"], SellMatrix)
