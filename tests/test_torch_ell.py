"""Port parity: the JAX package's XLA-only SpMV layouts in the port — the
padded-row `EllMatrix` with `spmv_ell`, `BsrMatrix.matvec_xla` ("bsr_xla")
and the dense operator — as `build_matvec` layouts of CG, `cg_ir`, AMG and
the CLI, against the JAX package on the same inputs. Bars: layout arrays
bit for bit; f64 SpMV to 1e-13 relative, f32 to 1e-5 relative to (1 + |y|);
solves to true relres ≤ 1e-10 with x within 1e-9 of the JAX x (ROADMAP)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsbench_tpu.harness.cli import main as j_main
from lsbench_tpu.matrix.ell import EllMatrix as JEll
from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.matrix.generate import random_spd as j_random_spd
from lsbench_tpu.ops.spmv import spmv_ell as j_spmv_ell
from lsbench_tpu.ordering.rcm import rcm_ordering as j_rcm
from lsbench_tpu.solvers.base import get_solver as j_get_solver

from lsbench_tpu_torch.harness.cli import main
from lsbench_tpu_torch.matrix.bsr import BsrMatrix
from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.ell import EllMatrix
from lsbench_tpu_torch.ops.spmv import spmv_ell, spmv_ell_padded
from lsbench_tpu_torch.ops.spmv_bsr import LAUNCHES, reset_launches
from lsbench_tpu_torch.solvers import get_solver
from lsbench_tpu_torch.solvers.cg import build_matvec

from conftest import make_rhs

CPU = torch.device("cpu")
MATRICES = {
    "random_spd(300,9)": lambda: j_random_spd(300, nnz_per_row=9, seed=0),
    "poisson_2d(17)": lambda: j_poisson_2d(17),
    "random_spd(64,3) RCM": lambda: _rcm(j_random_spd(64, nnz_per_row=3,
                                                      seed=2)),
}


def _rcm(A):
    return A.permuted(j_rcm(A))


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _bits_equal(t, j):
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("align", [(8, 1), (128, 8)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ell_layout_bit_identical(name, dtype, align):
    JA = MATRICES[name]()
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    E = EllMatrix.from_csr(_port_csr(JA), dtype=dtype, row_align=align[0],
                           width_align=align[1], device=CPU)
    JE = JEll.from_csr(JA, dtype=jdt, row_align=align[0],
                       width_align=align[1])
    _bits_equal(E.vals, JE.vals)
    _bits_equal(E.cols, JE.cols)
    assert (E.n_pad, E.k) == (JE.n_pad, JE.k)
    _bits_equal(E.astype(torch.float32).vals, JE.astype(jnp.float32).vals)
    moved = E.to("meta")
    assert {moved.vals.device.type, moved.cols.device.type} == {"meta"}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmv_ell_matches_jax(name, dtype):
    JA = MATRICES[name]()
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    E = EllMatrix.from_csr(_port_csr(JA), dtype=dtype, device=CPU)
    x = np.random.default_rng(1).standard_normal(JA.ncols)
    y = spmv_ell(E, torch.as_tensor(x))
    assert y.dtype == dtype and y.shape == (JA.nrows,)
    y_jax = np.asarray(j_spmv_ell(JEll.from_csr(JA, dtype=jdt),
                                  jnp.asarray(x)))
    if dtype == torch.float64:
        np.testing.assert_allclose(y.numpy(), y_jax, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(y.numpy(), JA.matvec(x), rtol=1e-13,
                                   atol=1e-13)
    else:
        rel = np.abs(y.numpy() - y_jax) / (1.0 + np.abs(y_jax))
        assert rel.max() < 1e-5
    yp = spmv_ell_padded(E, torch.as_tensor(x))
    assert yp.shape == (E.n_pad,) and torch.equal(yp[: JA.nrows], y)
    assert not yp[JA.nrows:].any()
    with pytest.raises(ValueError, match="shape"):
        spmv_ell(E, torch.ones(JA.ncols + 1, dtype=dtype))


def test_build_matvec_layouts_and_dtypes():
    A = _port_csr(j_poisson_2d(9))
    for layout, kind in (("ell", EllMatrix), ("bsr_xla", BsrMatrix),
                         ("dense", torch.Tensor)):
        for dtype in (torch.float64, torch.float32):
            mv, op = build_matvec(A, layout, CPU, dtype=dtype)
            assert isinstance(op, kind)
            y = mv(op, torch.ones(A.ncols, dtype=dtype))
            assert y.dtype == dtype
            np.testing.assert_allclose(y.numpy(), A.matvec(np.ones(A.ncols)),
                                       rtol=1e-6, atol=1e-6)
    assert build_matvec(A, "bsr_xla", CPU)[1].sel is not None
    with pytest.raises(ValueError, match="unknown layout"):
        build_matvec(A, "csr", CPU)


def _solve(get, name, A, b, **kw):
    cls, params = get(name)
    params.update(kw)
    solver = cls(A, **params)
    return solver, solver.solve(b)


def _true_relres(JA, x, b):
    return np.linalg.norm(b - JA.matvec(x)) / np.linalg.norm(b)


@pytest.mark.parametrize("layout", ["ell", "bsr_xla"])
@pytest.mark.parametrize("grid", [13, 15, 17])
def test_fp64_cg_layout_matches_jax(grid, layout):
    """fp64 CG on each XLA-only layout agrees with the JAX CG on the same
    layout, with an f64 operator (the solver hands `build_matvec` its
    dtype; "dense" is tested in test_torch_solvers.py)."""
    JA = j_poisson_2d(grid)
    A = _port_csr(JA)
    b = make_rhs(A.nrows)
    kw = dict(layout=layout, rtol=1e-12)
    solver, port = _solve(get_solver, "cg", A, b, device="cpu", **kw)
    _, jax_res = _solve(j_get_solver, "cg", JA, b, **kw)
    op = solver._op
    assert (op.vals if layout == "ell" else op.blocks).dtype == torch.float64
    x, x_jax = port.x.numpy(), np.asarray(jax_res.x)
    assert port.converged and jax_res.converged
    assert _true_relres(JA, x, b) <= 1e-10
    assert np.linalg.norm(x - x_jax) / np.linalg.norm(x_jax) <= 1e-9
    assert abs(port.iters - jax_res.iters) <= 1


@pytest.mark.parametrize("name", ["poisson_2d(24)", "random_spd(300,9)"])
def test_cg_ir_ell_layout(name):
    """`cg_ir` with the ELL inner layout: f32 CG on `spmv_ell` plus the
    f64-accurate residual, which is K2's (plain here) where the JAX package
    off the TPU takes f64 ELL; the two residuals agree to ~1e-16. The f32
    inner iterations differ only by rounding (XLA's and PyTorch's f32
    dots), which the bar of 5% (at least 3) covers. It is checked at rtol
    1e-11: at 1e-10 the second pass ends within f32 rounding of the
    tolerance (8.6e-11 against 1.0e-10 on poisson_2d(16)), so which side
    of it a package lands on decides a whole third pass."""
    JA = (j_poisson_2d(24) if name.startswith("poisson")
          else j_random_spd(300, nnz_per_row=9, seed=0))
    A = _port_csr(JA)
    b = make_rhs(A.nrows)
    kw = dict(layout="ell", ordering="rcm", rtol=1e-11)
    reset_launches()
    solver, port = _solve(get_solver, "cg_ir", A, b, device="cpu", **kw)
    _, jax_res = _solve(j_get_solver, "cg_ir", JA, b, **kw)
    assert isinstance(solver._op, EllMatrix)
    assert solver._op.vals.dtype == torch.float32
    assert sum(LAUNCHES.values()) == 0
    assert port.converged and _true_relres(JA, port.x.numpy(), b) <= 1e-10
    assert port.extra["refine_passes"] == jax_res.extra["refine_passes"]
    assert abs(port.iters - jax_res.iters) <= max(3, 0.05 * jax_res.iters), (
        port.iters, jax_res.iters)


def test_amg_precond_with_bsr_xla_matches_jax():
    """tests/test_amg.py:213-221 in the port: CG on the bsr_xla layout with
    an AMG V-cycle; and the AMG levels themselves on bsr_xla (coarse levels
    flip to dense) in both packages."""
    JA = j_poisson_2d(20)
    A = _port_csr(JA)
    b = np.arange(A.nrows, dtype=np.float64)
    x_ref = np.linalg.solve(JA.to_dense(), b)
    for precond_params in (None, {"layout": "bsr_xla"}):
        kw = dict(rtol=1e-10, precond="amg", layout="bsr_xla",
                  precond_params=precond_params)
        solver, port = _solve(get_solver, "cg", A, b, device="cpu", **kw)
        _, jax_res = _solve(j_get_solver, "cg", JA, b, **kw)
        assert port.converged
        np.testing.assert_allclose(port.x.numpy(), x_ref, rtol=1e-6,
                                   atol=1e-8)
        x_jax = np.asarray(jax_res.x)
        assert (np.linalg.norm(port.x.numpy() - x_jax)
                / np.linalg.norm(x_jax)) <= 1e-9
        assert port.iters == jax_res.iters
    levels = solver._pstate[0]
    kinds = {type(op).__name__ for lv in levels for op in (lv["a"], lv["p"],
                                                           lv["r"])}
    assert "BsrMatrix" in kinds
    assert all(lv["a"].sel is not None for lv in levels
               if isinstance(lv["a"], BsrMatrix))


@pytest.fixture
def poisson_file(tmp_path):
    from lsbench_tpu_torch.matrix.generate import poisson_2d
    from lsbench_tpu_torch.matrix.io import write_matrix
    f = tmp_path / "p16.txt"
    write_matrix(poisson_2d(16), str(f))
    return f


@pytest.mark.parametrize("argv", [
    ["--solver", "cg_ir", "--ordering", "rcm", "--opt", "layout=ell"],
    ["--solver", "cg", "--opt", "layout=ell"],
    ["--solver", "cg", "--opt", "layout=bsr_xla"],
])
def test_layout_opt_through_the_cli(poisson_file, capsys, argv):
    """`--opt layout=...` reaches the solver unchanged in both CLIs. rtol
    1e-11 for the iteration bar of `test_cg_ir_ell_layout`."""
    base = ["--matrix", str(poisson_file), "--rtol", "1e-11", "--trials",
            "2", "--warmups", "1", "--json", *argv]
    rc = main(base + ["--platform", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    j_rc = j_main(base)
    j_out = capsys.readouterr().out.strip().splitlines()
    assert rc == j_rc == 0
    assert out[0] == j_out[0]
    assert out[1].split(",")[:6] == j_out[1].split(",")[:6]
    rec, j_rec = json.loads(out[2]), json.loads(j_out[2])
    for k in ("solver", "ordering", "precision", "converged"):
        assert rec[k] == j_rec[k], k
    assert rec["converged"] is True and rec["true_relres"] <= 1e-10
    assert abs(rec["iters"] - j_rec["iters"]) <= max(3, 0.05 * j_rec["iters"])
