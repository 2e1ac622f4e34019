"""Port parity: the sliced-ELL layout (`matrix/sell.py`) and its f32 and f64
products (`ops/spmv_sell.py`), which replace the class-padded K5 and the
f64-accurate K2 on the port's solver paths.

Bars: the f32 plain version within 1e-5·max|y| of the JAX package's
`spmv_bsr_classed` (off the TPU its jnp reference) and of the host f64 CSR
matvec (f32 sums in another order); the f64 plain version within
1e-13·max|y| of the JAX `spmv_bsr_df64` in interpret mode (its double-float
result is good to ~2⁻⁴⁸) and of the host f64 matvec; solves to true relres
≤ 1e-10 with x within 1e-9 of the JAX x and inner iterations within 5%
(`tests/test_torch_solvers.py`'s bars). The CUDA kernels are held to the
plain versions by the `cuda`-marked tests, on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsbench_tpu.matrix import bsr as jbsr
from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.matrix.generate import random_spd as j_random_spd
from lsbench_tpu.matrix.generate import sem_2d as j_sem_2d
from lsbench_tpu.ops import spmv_pallas as jops
from lsbench_tpu.ordering.rcm import rcm_ordering as j_rcm
from lsbench_tpu.solvers.base import get_solver as j_get_solver

from lsbench_tpu_torch.matrix.bsr import classed_layout_wins
from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.sell import SLICE, SellMatrix
from lsbench_tpu_torch.ops import spmv_sell as ops
from lsbench_tpu_torch.solvers import get_solver
from lsbench_tpu_torch.solvers.cg import build_matvec
from lsbench_tpu_torch.solvers.refine import f64_residual_matvec

from conftest import make_rhs

CPU = torch.device("cpu")
BOTH = (torch.float32, torch.float64)


def _rcm(A):
    return A.permuted(j_rcm(A))


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _ragged() -> CsrMatrix:
    """n = 70 (not a multiple of 32): row 5 empty, row 40 with 60 entries
    among neighbours of 1-3, a diagonal elsewhere."""
    rng = np.random.default_rng(7)
    rows, cols = [], []
    for r in range(70):
        if r == 5:
            continue
        cs = (rng.choice(70, 60, replace=False) if r == 40
              else np.unique([r, *rng.integers(0, 70, rng.integers(0, 3))]))
        rows += [r] * len(cs)
        cols += list(cs)
    vals = rng.standard_normal(len(rows))
    return CsrMatrix.from_coo(np.array(rows), np.array(cols), vals,
                              nrows=70, ncols=70)


# JAX matrices (None: port-only) and their port CSR.
MATRICES = {
    "poisson_2d(16) RCM": lambda: _rcm(j_poisson_2d(16)),
    "poisson_2d(33) RCM": lambda: _rcm(j_poisson_2d(33)),
    "sem_2d(4) RCM": lambda: _rcm(j_sem_2d(4)),
    "random_spd(300,17) RCM": lambda: _rcm(j_random_spd(300, nnz_per_row=17,
                                                        seed=2)),
    "ragged(70)": lambda: None,
}


def _case(name):
    JA = MATRICES[name]()
    return JA, (_ragged() if JA is None else _port_csr(JA))


def _x(n, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(n) * scale


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_sell_layout_invariants(name):
    _, A = _case(name)
    S = SellMatrix.from_csr(A, dtypes=BOTH, device=CPU)
    n_slices = -(-A.nrows // SLICE)
    assert S.n_slices == n_slices and S.nnz == A.nnz
    off = S.slice_off.numpy()
    cols, v32, v64 = S.cols.numpy(), S.vals.numpy(), S.vals64.numpy()
    assert off[0] == 0 and off[-1] == S.n_stored == cols.size == v64.size
    # Each slice is as wide as its widest row.
    lens = np.zeros(n_slices * SLICE, dtype=np.int64)
    lens[: A.nrows] = np.diff(A.offs)
    np.testing.assert_array_equal(S.widths,
                                  lens.reshape(n_slices, SLICE).max(axis=1))
    # Rebuild the matrix entry by entry: every nonzero exactly once, at
    # slice_off[s] + 32·j + l, and zero values everywhere else.
    slot_row = (np.repeat(np.arange(n_slices), np.diff(off)) * SLICE
                + np.arange(S.n_stored) % SLICE)
    slot_j = (np.arange(S.n_stored) - np.repeat(off[:-1], np.diff(off))) // SLICE
    real = slot_j < lens[slot_row]
    assert real.sum() == A.nnz
    rows = A.row_indices()
    j = np.arange(A.nnz) - A.offs[rows]
    pos = off[rows // SLICE] + SLICE * j + rows % SLICE
    assert np.all(real[pos])
    np.testing.assert_array_equal(cols[pos], A.cols)
    np.testing.assert_array_equal(v64[pos], A.vals)
    np.testing.assert_array_equal(v32[pos], A.vals.astype(np.float32))
    assert not v64[~real].any() and not v32[~real].any()
    assert cols.min() >= 0 and cols.max() < A.ncols
    # Padding repeats its row's last column (column 0 in an empty row).
    pad_rows = slot_row[~real]
    last = np.zeros(n_slices * SLICE, dtype=np.int64)
    full = lens[: A.nrows] > 0
    last[: A.nrows][full] = A.cols[A.offs[1:][full] - 1]
    np.testing.assert_array_equal(cols[~real], last[pad_rows])
    if name == "ragged(70)":
        # Row 40's width pads its own slice only.
        assert S.widths[1] == 60 and max(S.widths[0], S.widths[2]) <= 3
        assert A.nrows % SLICE and lens[5] == 0


def test_with_f64_shares_the_structure():
    A = _port_csr(_rcm(j_poisson_2d(20)))
    S = SellMatrix.from_csr(A, device=CPU)
    assert S.vals64 is None and S.vals.dtype == torch.float32
    S64 = S.with_f64(A)
    assert S64.cols is S.cols and S64.slice_off is S.slice_off
    assert S64.vals is S.vals and S64.with_f64(A) is S64
    ref = SellMatrix.from_csr(A, dtypes=(torch.float64,), device=CPU)
    assert torch.equal(S64.vals64, ref.vals64)
    assert S64.bytes_streamed == S.bytes_streamed + 8 * S.n_stored
    with pytest.raises(ValueError, match="built from"):
        S.with_f64(_port_csr(j_poisson_2d(20)))        # not RCM-ordered
    moved = S64.to("meta")
    assert {t.device.type for t in (moved.cols, moved.slice_off, moved.vals,
                                    moved.vals64)} == {"meta"}


def test_layout_refuses_columns_outside_x():
    """The kernels read x[cols] in place, padding included: a column
    outside [0, ncols) is refused when the layout is built."""
    A = _ragged()
    narrow = CsrMatrix(A.nrows, int(A.cols.max()), A.offs, A.cols, A.vals)
    with pytest.raises(ValueError, match="outside"):
        SellMatrix.from_csr(narrow, device=CPU)
    negative = CsrMatrix(A.nrows, A.ncols, A.offs,
                         np.where(A.cols == 0, -1, A.cols), A.vals)
    with pytest.raises(ValueError, match="outside"):
        SellMatrix.from_csr(negative, device=CPU)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmv_sell_plain_matches_jax_classed_and_host(name):
    JA, A = _case(name)
    S = SellMatrix.from_csr(A, device=CPU)
    x = _x(A.ncols, 4)
    y = ops.spmv_sell(S, torch.as_tensor(x, dtype=torch.float32))
    assert y.dtype == torch.float32 and y.shape == (A.nrows,)
    assert torch.equal(y, ops.spmv_sell_plain(S, torch.as_tensor(
        x, dtype=torch.float32)))   # CPU tensors take the plain version
    y = y.numpy().astype(np.float64)
    yref = A.matvec(x)
    assert np.abs(y - yref).max() <= 1e-5 * np.abs(yref).max()
    if JA is not None:
        y_jax = np.asarray(jops.spmv_bsr_classed(jbsr.BsrClassed.from_csr(JA),
                                                 jnp.asarray(x)))
        assert np.abs(y - y_jax).max() <= 1e-5 * np.abs(y_jax).max()


# The Pallas interpret runs compile per shape: two main-path-like cases.
@pytest.mark.parametrize("name", ["poisson_2d(16) RCM",
                                  "random_spd(300,17) RCM"])
def test_spmv_sell_f64_plain_matches_jax_df64_and_host(name):
    JA, A = _case(name)
    S = SellMatrix.from_csr(A, dtypes=(torch.float64,), device=CPU)
    x = _x(A.ncols, 3, scale=1e3)
    y = ops.spmv_sell_f64(S, torch.as_tensor(x))
    assert y.dtype == torch.float64 and y.shape == (A.nrows,)
    y = y.numpy()
    y_jax = np.asarray(jops.spmv_bsr_df64(jbsr.BsrDf64.from_csr(JA),
                                          jnp.asarray(x), interpret=True))
    yref = A.matvec(x)
    assert np.abs(y - y_jax).max() <= 1e-13 * np.abs(y_jax).max()
    assert np.abs(y - yref).max() <= 1e-13 * np.abs(yref).max()


@pytest.mark.parametrize("name", ["sem_2d(4) RCM", "ragged(70)"])
def test_spmv_sell_f64_plain_matches_host(name):
    _, A = _case(name)
    S = SellMatrix.from_csr(A, dtypes=(torch.float64,), device=CPU)
    x = _x(A.ncols, 5)
    y = ops.spmv_sell_f64(S, torch.as_tensor(x)).numpy()
    yref = A.matvec(x)
    assert np.abs(y - yref).max() <= 1e-13 * np.abs(yref).max()


def test_input_checks_and_no_fallback():
    A = _port_csr(j_poisson_2d(9))
    S = SellMatrix.from_csr(A, dtypes=BOTH, device=CPU)
    x32, x64 = torch.ones(A.ncols), torch.ones(A.ncols, dtype=torch.float64)
    with pytest.raises(TypeError):
        ops.spmv_sell(S, x64)
    with pytest.raises(TypeError):
        ops.spmv_sell_f64(S, x32)
    with pytest.raises(ValueError, match="shape"):
        ops.spmv_sell(S, torch.ones(A.ncols + 1))
    with pytest.raises(ValueError, match="contiguous"):
        ops.spmv_sell(S, torch.ones(2 * A.ncols)[::2])
    # A device that is neither the CPU nor CUDA never takes the plain path,
    # nor does an x that lies elsewhere than the layout.
    with pytest.raises(ValueError, match="CPU"):
        ops.spmv_sell(S.to("meta"), x32.to("meta"))
    with pytest.raises(ValueError, match="layout on"):
        ops.spmv_sell(S, x32.to("meta"))
    with pytest.raises(ValueError, match="no torch.float64"):
        ops.spmv_sell_f64(SellMatrix.from_csr(A, device=CPU), x64)
    assert sum(ops.LAUNCHES.values()) == 0


def test_solver_routes_take_sell():
    """`build_matvec` gives the SELL products for "bsr" (the redesigned K1),
    "bsr_classed" and "bsr_df64"; every refinement residual is the SELL
    f64 product, sharing a SELL inner operator's structure."""
    A = _port_csr(_rcm(j_poisson_2d(12)))
    mv, op = build_matvec(A, "bsr_classed", CPU)
    assert mv is ops.spmv_sell and isinstance(op, SellMatrix)
    assert op.vals64 is None
    mv64, op64 = build_matvec(A, "bsr_df64", CPU)
    assert mv64 is ops.spmv_sell_f64 and op64.vals is None
    mv1, op1 = build_matvec(A, "bsr", CPU)
    assert mv1 is ops.spmv_sell and isinstance(op1, SellMatrix)
    assert torch.equal(op1.cols, op.cols) and torch.equal(op1.vals, op.vals)
    x = torch.as_tensor(_x(A.ncols, 6))
    yref = A.matvec(x.numpy())
    for inner in (op, op1):
        y = f64_residual_matvec(A, inner, CPU)(x).numpy()
        assert np.abs(y - yref).max() <= 1e-13 * np.abs(yref).max()
    cls, params = get_solver("block_cg")
    params.update(device="cpu", ordering="rcm")
    solver = cls(A, **params)
    y = solver._mm64(torch.stack([x, 2 * x], dim=1)).numpy()
    np.testing.assert_allclose(y, np.stack([yref, 2 * yref], axis=1),
                               rtol=1e-13, atol=1e-13 * np.abs(yref).max())


def _solve(get, name, A, b, **kw):
    cls, params = get(name)
    params.update(kw)
    solver = cls(A, **params)
    return solver, solver.solve(b)


def _check_parity(JA, b, port, jax_res):
    x_port, x_jax = port.x.numpy(), np.asarray(jax_res.x)
    assert port.converged == jax_res.converged
    for x in (x_port, x_jax):
        assert np.linalg.norm(b - JA.matvec(x)) / np.linalg.norm(b) <= 1e-10
    assert np.linalg.norm(x_port - x_jax) / np.linalg.norm(x_jax) <= 1e-9
    assert abs(port.iters - jax_res.iters) <= 0.05 * jax_res.iters, (
        port.iters, jax_res.iters)


# poisson_2d(24) with this layout is a case of
# tests/test_torch_solvers.py::test_cg_ir_matches_jax, and fp64 CG (every
# iteration on `spmv_sell_f64`) is test_fp64_cg_matches_jax there.
SOLVES = {"sem_2d(8)": lambda: j_sem_2d(8),
          "random_spd(300)": lambda: j_random_spd(300)}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_cg_ir_sell_inner_matches_jax(name):
    """cg_ir with the class-padded layout name: f32 CG on `spmv_sell`,
    residual on `spmv_sell_f64` sharing its structure; the JAX package runs
    its classed BSR reference inside and f64 ELL outside."""
    JA = SOLVES[name]()
    A, b = _port_csr(JA), make_rhs(JA.nrows)
    kw = dict(layout="bsr_classed", ordering="rcm", rtol=1e-12)
    solver, port = _solve(get_solver, "cg_ir", A, b, device="cpu", **kw)
    _, jax_res = _solve(j_get_solver, "cg_ir", JA, b, **kw)
    assert isinstance(solver._op, SellMatrix)
    assert port.extra["refine_passes"] >= 2
    _check_parity(JA, b, port, jax_res)


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_cg_ir_uniform_bsr_route_matches_jax(name):
    """cg_ir with the uniform layout name "bsr" (the JAX package's K1 on
    operators where `classed_layout_wins` is false): the port runs it on
    `spmv_sell`, with the residual on `spmv_sell_f64` sharing its
    structure, and matches the JAX solve as the classed route does."""
    JA = SOLVES[name]()
    A, b = _port_csr(JA), make_rhs(JA.nrows)
    assert not classed_layout_wins(_port_csr(_rcm(JA)))
    kw = dict(layout="bsr", ordering="rcm", rtol=1e-12)
    solver, port = _solve(get_solver, "cg_ir", A, b, device="cpu", **kw)
    _, jax_res = _solve(j_get_solver, "cg_ir", JA, b, **kw)
    assert isinstance(solver._op, SellMatrix) and solver._op.vals64 is None
    assert port.extra["refine_passes"] >= 2
    _check_parity(JA, b, port, jax_res)


def _transfer_operators():
    """(label, CsrMatrix) of every rectangular P (n×nc) and R (nc×n) of a
    real classical hierarchy of poisson_2d(32)."""
    from lsbench_tpu_torch.solvers import amg as tamg
    A = _port_csr(j_poisson_2d(32))
    mats, _ = tamg.build_matrix_hierarchy(
        A, tamg.AmgOptions(coarsening="classical", theta=0.25))
    return [(f"level {l} {k}", m[k]) for l, m in enumerate(mats)
            for k in ("P", "R")]


def test_spmv_sell_on_rectangular_amg_transfers():
    """`spmv_sell` and `spmv_sell_f64` take x of length ncols: on each
    rectangular transfer operator of an AMG hierarchy they match the host
    f64 product, and the padding reads only columns below ncols."""
    ops_ = _transfer_operators()
    assert any(M.nrows < M.ncols for _, M in ops_)
    assert any(M.nrows > M.ncols for _, M in ops_)
    for label, M in ops_:
        S = SellMatrix.from_csr(M, dtypes=BOTH, device=CPU)
        assert (S.nrows, S.ncols) == M.shape
        assert 0 <= int(S.cols.min()) and int(S.cols.max()) < M.ncols
        x = _x(M.ncols, 9)
        yref = M.matvec(x)
        y32 = ops.spmv_sell(S, torch.as_tensor(x, dtype=torch.float32))
        y64 = ops.spmv_sell_f64(S, torch.as_tensor(x))
        assert y32.shape == y64.shape == (M.nrows,)
        scale = np.abs(yref).max()
        assert np.abs(y32.numpy() - yref).max() <= 1e-5 * scale, label
        assert np.abs(y64.numpy() - yref).max() <= 1e-13 * scale, label
        with pytest.raises(ValueError, match="shape"):
            ops.spmv_sell_f64(S, torch.zeros(M.nrows, dtype=torch.float64))


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_sell_kernels_match_plain_on_card(name, cuda_device):
    _, A = _case(name)
    S = SellMatrix.from_csr(A, dtypes=BOTH, device=cuda_device)
    x64 = torch.as_tensor(_x(A.ncols, 8), device=cuda_device)
    x32 = x64.float()
    before = dict(ops.LAUNCHES)
    for kern, plain, x, rtol in (
            (ops.spmv_sell, ops.spmv_sell_plain, x32, 1e-5),
            (ops.spmv_sell_f64, ops.spmv_sell_f64_plain, x64, 1e-13)):
        y, y_again, y_plain = kern(S, x), kern(S, x), plain(S, x)
        torch.cuda.synchronize()
        assert y.device == x.device and y.dtype == x.dtype
        assert y.shape == (A.nrows,)
        assert torch.equal(y, y_again)                 # bitwise repeatable
        scale = float(y_plain.abs().max())
        assert float((y - y_plain).abs().max()) <= rtol * scale
    assert ops.LAUNCHES["sell_f32"] == before["sell_f32"] + 2
    assert ops.LAUNCHES["sell_f64"] == before["sell_f64"] + 2


@pytest.mark.cuda
def test_sell_kernels_on_rectangular_transfers_on_card(cuda_device):
    for label, M in _transfer_operators():
        S = SellMatrix.from_csr(M, dtypes=BOTH, device=cuda_device)
        x64 = torch.as_tensor(_x(M.ncols, 10), device=cuda_device)
        for kern, plain, x, rtol in (
                (ops.spmv_sell, ops.spmv_sell_plain, x64.float(), 1e-5),
                (ops.spmv_sell_f64, ops.spmv_sell_f64_plain, x64, 1e-13)):
            y, y_plain = kern(S, x), plain(S, x)
            assert y.shape == (M.nrows,)
            scale = float(y_plain.abs().max())
            assert float((y - y_plain).abs().max()) <= rtol * scale, label


@pytest.mark.cuda
def test_sell_kernels_refuse_bad_x_on_card(cuda_device):
    A = _port_csr(_rcm(j_poisson_2d(16)))
    S = SellMatrix.from_csr(A, dtypes=BOTH, device=cuda_device)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="layout on"):
        ops.spmv_sell(S, torch.ones(A.ncols))           # x on the CPU
    with pytest.raises(TypeError):
        ops.spmv_sell(S, torch.ones(A.ncols, dtype=torch.float64,
                                    device=cuda_device))
    with pytest.raises(TypeError):
        ops.spmv_sell_f64(S, torch.ones(A.ncols, device=cuda_device))
    assert ops.LAUNCHES == before
