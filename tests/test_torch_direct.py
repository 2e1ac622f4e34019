"""Port parity: the direct solvers (`solvers/direct.py`,
`solvers/sparse_cholesky.py`, `native/spchol.cpp`) against the JAX
package's.

Bars:
- the host phases (symmetrization, elimination tree, symbolic rows, the
  native and the Python numeric factor) and the blocked and level
  schedules' host packing (`pack_tri_blocked_host`, `pack_tri`) are
  bitwise equal to the JAX package's;
- the blocked triangular apply (f32, plain PyTorch on the CPU) lies within
  1e-5·max|x| of the JAX apply, and its block inverses within 1e-5·max|W|;
  the level apply (the plain sweeps) within 1e-12·max|x| in f64 and
  1e-5·max|x| in f32;
- every solve reaches true relres ≤ 1e-10 with x within 1e-9·‖x‖ of the
  JAX x (tests/test_dist_cg_ir.py's bar). The port's fp64 `cholesky` runs
  the JAX package's TPU branch (`cholesky_ir`), so it is held to the JAX
  `CholeskyIrSolver` with equal refinement passes, and to the JAX
  `CholeskySolver` (its CPU branch, a dense f64 factor) by x and relres.
The `cuda`-marked tests hold the same paths on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.matrix.generate import random_spd as j_random_spd
from lsbench_tpu.native import spchol as j_spchol
from lsbench_tpu.ordering import get_ordering as j_get_ordering
from lsbench_tpu.solvers import sparse_cholesky as jsc
from lsbench_tpu.solvers.base import get_solver as j_get_solver

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.native import spchol
from lsbench_tpu_torch.ops import spmv_sell, tri_sweep
from lsbench_tpu_torch.solvers import get_solver
from lsbench_tpu_torch.solvers import sparse_cholesky as tsc

from conftest import make_rhs

CPU = torch.device("cpu")

MATRICES = {
    "poisson_2d(24)": lambda: j_poisson_2d(24),
    "random_spd(300,9)": lambda: j_random_spd(300, 9),
}
ORDERINGS = ("none", "rcm", "amd", "metis")


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _relres(JA, x, b):
    x, b = np.asarray(x), np.asarray(b)
    if x.ndim == 1:
        x, b = x[:, None], b[:, None]
    return max(np.linalg.norm(b[:, j] - JA.matvec(x[:, j]))
               / np.linalg.norm(b[:, j]) for j in range(x.shape[1]))


def _xdiff(x, x_ref):
    x, x_ref = np.asarray(x), np.asarray(x_ref)
    return np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)


def _factor_inputs(JA, ordering):
    """(JAX symmetrized permuted A, port's) for the host phases."""
    JAp = JA.permuted(j_get_ordering(ordering, JA))
    return jsc.symmetrize(JAp), tsc.symmetrize(_port_csr(JAp))


# ---------------------------------------------------------- host phases

@pytest.mark.parametrize("factor", ["native", "python"])
@pytest.mark.parametrize("name,ordering", [("poisson_2d(24)", "amd"),
                                           ("random_spd(300,9)", "amd"),
                                           ("poisson_2d(24)", "none")])
def test_host_phases_bitwise_equal_jax(name, ordering, factor, monkeypatch):
    JAs, As = _factor_inputs(MATRICES[name](), ordering)
    for mine, theirs in zip((As.offs, As.cols, As.vals),
                            (JAs.offs, JAs.cols, JAs.vals)):
        np.testing.assert_array_equal(mine, theirs)
    parent = tsc.elimination_tree(As)
    np.testing.assert_array_equal(parent, jsc.elimination_tree(JAs))
    loffs, lcols = tsc.symbolic_rows(As, parent)
    j_loffs, j_lcols = jsc.symbolic_rows(JAs, parent)
    np.testing.assert_array_equal(loffs, j_loffs)
    np.testing.assert_array_equal(lcols, j_lcols)
    if factor == "python":
        def broken(*_):
            raise RuntimeError("no native library")
        monkeypatch.setattr(spchol, "chol_numeric", broken)
        monkeypatch.setattr(j_spchol, "chol_numeric", broken)
    for mine, theirs in zip(tsc.numeric_factor(As, loffs, lcols),
                            jsc.numeric_factor(JAs, loffs, lcols),
                            strict=True):
        np.testing.assert_array_equal(mine, theirs)


def test_numeric_factor_refuses_indefinite(monkeypatch):
    A = _port_csr(j_poisson_2d(6))
    A.vals[A.row_indices() == A.cols] *= -1.0
    parent = tsc.elimination_tree(A)
    loffs, lcols = tsc.symbolic_rows(A, parent)
    with pytest.raises(np.linalg.LinAlgError):
        tsc.numeric_factor(A, loffs, lcols)

    def broken(*_):
        raise RuntimeError("no native library")

    monkeypatch.setattr(spchol, "chol_numeric", broken)
    with pytest.raises(np.linalg.LinAlgError, match="positive definite"):
        tsc.numeric_factor(A, loffs, lcols)


def _factor(JA, ordering):
    _, As = _factor_inputs(JA, ordering)
    parent = tsc.elimination_tree(As)
    return tsc.numeric_factor(As, *tsc.symbolic_rows(As, parent))


# ------------------------------------------------------- blocked schedule

@pytest.mark.parametrize("name,ordering,block", [
    ("poisson_2d(24)", "amd", 32), ("random_spd(300,9)", "rcm", 16),
    ("poisson_2d(24)", "none", 256)])
def test_block_packing_bitwise_equal_jax(name, ordering, block):
    """The host arrays of the forward sweep, and every padded sweep array
    the device expansion builds from them, are the JAX package's; the
    block inverses agree to f32 rounding."""
    JA = MATRICES[name]()
    cp, ci, cx = _factor(JA, ordering)
    n = JA.nrows
    (host_f, seg_f), _, meta = tsc.pack_tri_blocked_host(cp, ci, cx, n,
                                                         block)
    # The JAX package's forward-sweep packing, step by step.
    col_of = np.repeat(np.arange(n), np.diff(cp))
    off = ci != col_of
    r, c, v = ci[off], col_of[off], cx[off]
    order = np.lexsort((c, r))
    roffs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r[order], minlength=n), out=roffs[1:])
    lev = jsc._level_schedule(n, roffs, c[order])
    j_host, j_seg, _, _ = jsc._pack_blocks(n, roffs, c[order], v[order],
                                           cx[cp[:-1]], lev, block,
                                           jnp.float32)
    assert seg_f == j_seg
    for key in j_host:
        np.testing.assert_array_equal(host_f[key], j_host[key], err_msg=key)

    state, meta2 = tsc.pack_tri_blocked(cp, ci, cx, n, torch.float32,
                                        block=block, device=CPU)
    j_state, j_meta = jsc.pack_tri_blocked(cp, ci, cx, n, jnp.float32,
                                           block=block)
    assert meta == meta2 == j_meta
    for sweep in ("f", "b"):
        mine, theirs = state[sweep], j_state[sweep]
        for key in ("cols", "vals", "slot", "rows"):
            np.testing.assert_array_equal(mine[key].numpy(),
                                          np.asarray(theirs[key]),
                                          err_msg=f"{sweep} {key}")
        W, j_W = mine["W"].numpy().ravel(), np.asarray(theirs["W"])
        assert np.abs(W - j_W).max() <= 1e-5 * np.abs(j_W).max()
        assert len(mine["steps"]) == meta["nb"]


@pytest.mark.parametrize("k", [1, 3])
def test_apply_tri_blocked_matches_jax(k):
    JA = j_poisson_2d(24)
    cp, ci, cx = _factor(JA, "amd")
    n = JA.nrows
    state, _ = tsc.pack_tri_blocked(cp, ci, cx, n, torch.float32, block=64,
                                    device=CPU)
    j_state, j_meta = jsc.pack_tri_blocked(cp, ci, cx, n, jnp.float32,
                                           block=64)
    b = np.random.default_rng(k).standard_normal((n, k)).astype(np.float32)
    bb = b[:, 0] if k == 1 else b
    x = tsc.apply_tri_blocked(state, torch.as_tensor(bb), n=n, block=64)
    x_jax = np.asarray(jsc.apply_tri_blocked(
        j_state, jnp.asarray(bb), n=n, rs_f=j_meta["rs_f"],
        rs_b=j_meta["rs_b"], block=64))
    assert x.shape == bb.shape and x.dtype == torch.float32
    assert np.abs(x.numpy() - x_jax).max() <= 1e-5 * np.abs(x_jax).max()


# ---------------------------------------------------------- level schedule

@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
@pytest.mark.parametrize("name,ordering", [("poisson_2d(24)", "amd"),
                                           ("random_spd(300,9)", "rcm"),
                                           ("poisson_2d(24)", "none")])
def test_level_packing_bitwise_equal_jax(name, ordering, dtype):
    """`pack_tri`'s host arrays (the padded level segments of both sweeps)
    and its meta are the JAX package's; the plain version's per-level views
    cut them as the JAX scan does."""
    JA = MATRICES[name]()
    cp, ci, cx = _factor(JA, ordering)
    n = JA.nrows
    host, meta = tsc.pack_tri_host(cp, ci, cx, n)
    j_state, j_meta = jsc.pack_tri(cp, ci, cx, n, dtype)
    assert meta == j_meta
    for sweep in ("f", "b"):
        flat, seg_R, _, nlev = host[sweep]
        assert nlev == j_meta["nlev_" + sweep]
        for key in ("rows", "slot", "cols", "vals", "dinv"):
            mine = flat[key]
            if key in ("vals", "dinv"):
                mine = mine.astype(dtype)
            np.testing.assert_array_equal(
                mine, np.asarray(j_state[sweep][key]),
                err_msg=f"{sweep} {key}")
    state, meta2 = tsc.pack_tri(cp, ci, cx, n, torch.float64, CPU)
    assert meta2 == meta
    for S, key in ((state.f, "rs_f"), (state.b, "rs_b")):
        assert len(S.levels) == sum(L for L, _, _ in meta[key])
        assert [lv[5] for lv in S.levels] \
            == [R for L, _, R in meta[key] for _ in range(L)]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("k", [1, 3])
def test_apply_tri_matches_jax(k, dtype, tol):
    JA = j_poisson_2d(24)
    cp, ci, cx = _factor(JA, "amd")
    n = JA.nrows
    j_dt = jnp.float64 if dtype == torch.float64 else jnp.float32
    state, apply, nlev_f, nlev_b, waste = tsc.build_level_solver(
        cp, ci, cx, n, dtype, device=CPU)
    j_state, j_apply, j_nf, j_nb, j_waste = jsc.build_level_solver(
        cp, ci, cx, n, j_dt)
    assert (nlev_f, nlev_b, waste) == (j_nf, j_nb, j_waste)
    b = np.random.default_rng(k).standard_normal((n, k))
    bb = b[:, 0] if k == 1 else b
    x = apply(state, torch.as_tensor(bb))
    if k == 1:
        x_jax = np.asarray(j_apply(j_state, jnp.asarray(bb, j_dt)))
    else:
        x_jax = np.stack([np.asarray(j_apply(j_state, jnp.asarray(b[:, j],
                                                                  j_dt)))
                          for j in range(k)], axis=1)
    assert x.shape == bb.shape and x.dtype == dtype
    assert np.abs(x.numpy() - x_jax).max() <= tol * np.abs(x_jax).max()


def test_level_schedule_is_not_ported():
    """The level schedule, once refused, now builds; an unknown schedule
    is still refused."""
    cls, _ = get_solver("sparse_cholesky")
    s = cls(_port_csr(j_poisson_2d(6)), schedule="level", device="cpu")
    assert s.schedule == "level" and s.n_levels_f > 1
    with pytest.raises(ValueError, match="unknown schedule"):
        cls(_port_csr(j_poisson_2d(6)), schedule="scan", device="cpu")


def test_level_multi_rhs_matches_jax():
    """`--nrhs 3` on the level schedule: every column to 1e-10 and within
    1e-9 of the JAX x, labelled fp32_ir_auto."""
    JA = j_random_spd(300, 9)
    rng = np.random.default_rng(0)
    B = np.column_stack([make_rhs(JA.nrows)] + [rng.standard_normal(JA.nrows)
                                                for _ in range(2)])
    kw = dict(schedule="level", ordering="amd", rtol=1e-12)
    _, port = _solve(get_solver, "sparse_cholesky", _port_csr(JA), B,
                     device="cpu", **kw)
    _, jax_res = _solve(j_get_solver, "sparse_cholesky", JA, B, **kw)
    assert port.extra["precision_mode"] == "fp32_ir_auto"
    assert port.extra["levels"] == jax_res.extra["levels"]
    for j in range(3):
        assert _relres(JA, port.x[:, j].numpy(), B[:, j]) <= 1e-10
        assert _xdiff(port.x[:, j].numpy(),
                      np.asarray(jax_res.x)[:, j]) <= 1e-9


# ----------------------------------------------------------------- solves

def _solve(get, name, A, b, **kw):
    cls, params = get(name)
    params.update(kw)
    solver = cls(A, **params)
    return solver, solver.solve(b)


# port solver spelling, its options → the JAX solver it is held to
SOLVES = {
    "cholesky": ("cholesky", {}, "cholesky_ir", {}),
    "cholmod": ("cholmod", {}, "cholesky_ir", {}),
    "cusolver": ("cusolver", {}, "cholesky_ir",
                 dict(refactor_each_solve=True)),
    "cholesky_ir": ("cholesky_ir", {}, "cholesky_ir", {}),
    "sparse_cholesky host": ("sparse_cholesky", dict(schedule="host"),
                             "sparse_cholesky", dict(schedule="host")),
    "sparse_cholesky block": ("sparse_cholesky", dict(schedule="block"),
                              "sparse_cholesky", dict(schedule="block")),
    "sparse_cholesky level": ("sparse_cholesky", dict(schedule="level"),
                              "sparse_cholesky", dict(schedule="level")),
}


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("solve", sorted(SOLVES))
def test_direct_solve_matches_jax(solve, name, ordering):
    JA = MATRICES[name]()
    A, b = _port_csr(JA), make_rhs(JA.nrows)
    port_name, kw, jax_name, j_kw = SOLVES[solve]
    solver, port = _solve(get_solver, port_name, A, b, device="cpu",
                          ordering=ordering, rtol=1e-12, **kw)
    _, jax_res = _solve(j_get_solver, jax_name, JA, b, ordering=ordering,
                        rtol=1e-12, **j_kw)
    x = port.x.numpy()
    assert port.x.dtype == torch.float64 and port.x.shape == b.shape
    assert port.converged and jax_res.converged
    assert _relres(JA, x, b) <= 1e-10
    assert _xdiff(x, jax_res.x) <= 1e-9
    if jax_name == "cholesky_ir":
        assert port.extra["refine_passes"] == jax_res.extra["refine_passes"]
    if solve.startswith("sparse"):
        assert port.extra["schedule"] == kw["schedule"]
        assert port.extra["fill_nnz"] == jax_res.extra["fill_nnz"]
        assert ("precision_mode" in port.extra) == (kw["schedule"] != "host")
        if kw["schedule"] == "level":
            assert port.extra["levels"] == jax_res.extra["levels"]
    if port_name in ("cholesky", "cholmod", "cusolver"):
        # fp64 Cholesky runs as cholesky_ir (the JAX package's TPU branch);
        # the JAX CPU branch is a dense f64 factor.
        assert port.extra["precision_mode"] == "fp32_ir_auto"
        _, j_dense = _solve(j_get_solver, "cholesky", JA, b,
                            ordering=ordering)
        assert _relres(JA, np.asarray(j_dense.x), b) <= 1e-10
        assert _xdiff(x, j_dense.x) <= 1e-9


@pytest.mark.parametrize("name", ["cholesky", "cholesky_ir"])
def test_dense_guard_delegates_to_sparse(name):
    JA = j_poisson_2d(16)
    A, b = _port_csr(JA), make_rhs(JA.nrows)
    kw = dict(ordering="amd", max_dense_n=100)
    solver, port = _solve(get_solver, name, A, b, device="cpu", **kw)
    _, jax_res = _solve(j_get_solver, name, JA, b, **kw)
    assert port.extra["delegated"] == jax_res.extra["delegated"] \
        == "sparse_cholesky"
    assert port.extra["schedule"] == "host"
    assert isinstance(solver._delegate, tsc.SparseCholeskySolver)
    assert solver.setup_breakdown is solver._delegate.setup_breakdown
    assert _relres(JA, port.x.numpy(), b) <= 1e-10
    assert _xdiff(port.x.numpy(), jax_res.x) <= 1e-9


@pytest.mark.parametrize("solve", sorted(SOLVES))
def test_multi_rhs_each_column_converges(solve):
    JA = j_random_spd(300, 9)
    A = _port_csr(JA)
    rng = np.random.default_rng(0)
    B = np.column_stack([make_rhs(A.nrows)] + [rng.standard_normal(A.nrows)
                                               for _ in range(2)])
    port_name, kw, _, _ = SOLVES[solve]
    solver, port = _solve(get_solver, port_name, A, B, device="cpu",
                          ordering="amd", **kw)
    assert port.x.shape == (A.nrows, 3)
    for j in range(3):
        assert _relres(JA, port.x[:, j].numpy(), B[:, j]) <= 1e-10
    one = solver.solve_fn()(B[:, 1])
    assert _xdiff(one.numpy(), port.x[:, 1].numpy()) <= 1e-9
    if "refine_passes" in port.extra:
        assert port.extra["nrhs"] == 3 and len(port.extra["relres_cols"]) == 3


FP32 = {"cholesky": [dict(refactor_each_solve=False),
                     dict(refactor_each_solve=True)],
        "sparse_cholesky": [dict(schedule="block"), dict(schedule="level")]}


@pytest.mark.parametrize("name", sorted(FP32))
def test_fp32_cholesky_matches_jax(name):
    """`--precision fp32`: the dense f32 path and the sparse blocked sweeps
    in f32 refined against the raw f32 operator, in both packages."""
    JA = j_poisson_2d(16)
    A, b = _port_csr(JA), make_rhs(JA.nrows)
    for opts in FP32[name]:
        kw = dict(dtype="float32", ordering="rcm", **opts)
        _, port = _solve(get_solver, name, A, b, device="cpu", **kw)
        _, jax_res = _solve(j_get_solver, name, JA, b, **kw)
        assert port.x.dtype == torch.float32 and "precision_mode" not in \
            port.extra
        assert _relres(JA, port.x.double().numpy(), b) <= 1e-5
        assert _xdiff(port.x.double().numpy(),
                      np.asarray(jax_res.x, np.float64)) <= 1e-5


def test_cpu_direct_paths_launch_nothing():
    spmv_sell.reset_launches()
    tri_sweep.reset_launches()
    JA = j_poisson_2d(10)
    A, b = _port_csr(JA), make_rhs(JA.nrows)
    for name, kw in (("cholmod", {}),
                     ("sparse_cholesky", dict(schedule="block")),
                     ("sparse_cholesky", dict(schedule="level"))):
        _solve(get_solver, name, A, b, device="cpu", **kw)
    assert sum(spmv_sell.LAUNCHES.values()) == 0
    assert sum(tri_sweep.LAUNCHES.values()) == 0


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("solve", ["cholmod", "cusolver",
                                   "sparse_cholesky block",
                                   "sparse_cholesky level"])
def test_direct_paths_on_card(solve, cuda_device):
    """On the card each device path refines through `spmv_sell_f64` to the
    plain versions' relres and refinement passes (the level schedule
    through the f32 triangular-sweep kernel)."""
    JA = j_poisson_2d(24)
    A, b = _port_csr(JA), make_rhs(JA.nrows)
    port_name, kw, _, _ = SOLVES[solve]
    _, plain = _solve(get_solver, port_name, A, b, device="cpu",
                      ordering="amd", **kw)
    spmv_sell.reset_launches()
    tri_sweep.reset_launches()
    _, res = _solve(get_solver, port_name, A, b, device=cuda_device,
                    ordering="amd", **kw)
    assert res.x.device.type == "cuda"
    assert spmv_sell.LAUNCHES["sell_f64"] > 0
    assert (tri_sweep.LAUNCHES["tri_sweep_f32"] > 0) \
        == (kw.get("schedule") == "level")
    assert _relres(JA, res.x.cpu().numpy(), b) <= 1e-10
    assert res.extra.get("refine_passes") == plain.extra.get("refine_passes")
    assert _xdiff(res.x.cpu().numpy(), plain.x.numpy()) <= 1e-9
