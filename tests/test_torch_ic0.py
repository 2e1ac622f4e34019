"""Port parity for the IC(0) preconditioner (`solvers/ic0.py`) and its apply,
the triangular-sweep kernel's wrapper (`ops/tri_sweep.py`), on the CPU with
the plain sweep, against the JAX package on the same matrices and
right-hand sides (RCM poisson_2d(40), AMD random_spd(300, 9)).

Bars:
- `ic0_factor`: cp and ci equal, cx within 1e-14·max|cx| (the same NumPy
  arithmetic); the diagonal-shift retry tries the same α sequence;
- the kernels' layout (rows in level order as CSR, columns as positions),
  walked position by position, solves the sweep to the plain version's x
  within 1e-12·max|x| (f64), and every entry points to an earlier level
  (`tests/test_torch_tri_sweep.py` walks it segment by segment, as the
  kernels do);
- fp64 `cg --precond ic0` on `layout=ell` takes the JAX iteration count
  (±1) with x within 1e-9·‖x‖; `cg_ir --precond ic0` reaches true relres
  ≤ 1e-10 in both packages, as do the other Krylov solvers that take it.
The `cuda`-marked tests hold `tri_sweep_f32` and `tri_sweep_f64` to the
plain version on the card: f32 within 1e-5·max|x|, f64 within
1e-12·max|x| (the kernels sum a row's entries in another order than
`index_add_`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsbench_tpu.matrix.csr import CsrMatrix as JCsr
from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.matrix.generate import random_spd as j_random_spd
from lsbench_tpu.ordering import get_ordering as j_get_ordering
from lsbench_tpu.solvers import ic0 as j_ic0
from lsbench_tpu.solvers.base import get_solver as j_get_solver

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ops import tri_sweep as ts
from lsbench_tpu_torch.solvers import get_solver
from lsbench_tpu_torch.solvers import ic0 as t_ic0
from lsbench_tpu_torch.solvers import sparse_cholesky as tsc

from conftest import make_rhs

CPU = torch.device("cpu")

# label → (JAX matrix, ordering)
CASES = {
    "poisson_2d(40) rcm": (lambda: j_poisson_2d(40), "rcm"),
    "random_spd(300,9) amd": (lambda: j_random_spd(300, 9), "amd"),
}


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _ordered(label):
    make, ordering = CASES[label]
    JA = make()
    return JA.permuted(j_get_ordering(ordering, JA))


def _xdiff(x, x_ref):
    x, x_ref = np.asarray(x), np.asarray(x_ref)
    return np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)


def _relres(JA, x, b):
    return np.linalg.norm(b - JA.matvec(np.asarray(x))) / np.linalg.norm(b)


@pytest.mark.parametrize("label", sorted(CASES))
def test_ic0_factor_matches_jax(label):
    JA = _ordered(label)
    cp, ci, cx = t_ic0.ic0_factor(_port_csr(JA))
    j_cp, j_ci, j_cx = j_ic0.ic0_factor(JA)
    np.testing.assert_array_equal(cp, j_cp)
    np.testing.assert_array_equal(ci, j_ci)
    assert np.abs(cx - j_cx).max() <= 1e-14 * np.abs(j_cx).max()


def test_ic0_shift_retry_matches_jax(monkeypatch):
    """The breakdown matrix of tests/test_ic0.py: both packages retry with
    the same diagonal shifts and end on the same factor."""
    D = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 1.0], [0.0, 1.0, 3.0]])
    JA = JCsr.from_dense(D)
    alphas = {"port": [], "jax": []}

    def spy(mod, key):
        numeric = mod._ic0_numeric

        def wrapped(*args):
            alphas[key].append(args[-1])
            return numeric(*args)
        monkeypatch.setattr(mod, "_ic0_numeric", wrapped)

    spy(t_ic0, "port")
    spy(j_ic0, "jax")
    cp, ci, cx = t_ic0.ic0_factor(_port_csr(JA))
    j_cp, j_ci, j_cx = j_ic0.ic0_factor(JA)
    assert len(alphas["port"]) > 1 and alphas["port"] == alphas["jax"]
    np.testing.assert_array_equal(ci, j_ci)
    assert np.abs(cx - j_cx).max() <= 1e-14 * np.abs(j_cx).max()
    assert np.all(np.isfinite(cx)) and np.all(cx[cp[:-1]] > 0)


def test_ic0_missing_diagonal_raises():
    A = _port_csr(JCsr.from_dense(np.array([[0.0, 1.0], [1.0, 2.0]])))
    with pytest.raises(np.linalg.LinAlgError, match="full diagonal"):
        t_ic0.ic0_factor(A)


def _kernel_walk(S, b):
    """The kernels' arithmetic in position order on the host (f64): x_p =
    (b[perm[p]] − Σ vals·x[cols])·dinv at each position p, x by position,
    from S's kernel arrays; returned by row."""
    perm, offs = S.perm.numpy(), S.offs.numpy()
    cols, vals, dinv = S.cols.numpy(), S.vals.double().numpy(), \
        S.dinv.double().numpy()
    xpos = np.full(S.n, np.nan)
    for p in range(S.n):
        sl = slice(offs[p], offs[p + 1])
        assert not np.isnan(xpos[cols[sl]]).any()  # every dependency is earlier
        xpos[p] = (b[perm[p]] - vals[sl] @ xpos[cols[sl]]) * dinv[p]
    x = np.empty(S.n)
    x[perm] = xpos
    return x


@pytest.mark.parametrize("label", sorted(CASES))
def test_kernel_layout_walk_matches_plain(label):
    JA = _ordered(label)
    cp, ci, cx = t_ic0.ic0_factor(_port_csr(JA))
    state, meta = tsc.pack_tri(cp, ci, cx, JA.nrows, torch.float64, CPU)
    b = np.random.default_rng(1).standard_normal(JA.nrows)
    for S, nlev in ((state.f, meta["nlev_f"]), (state.b, meta["nlev_b"])):
        assert S.nlev == nlev and S.nnz == cp[-1] - JA.nrows
        x = ts.tri_sweep(S, torch.as_tensor(b)).numpy()
        assert np.abs(_kernel_walk(S, b) - x).max() <= 1e-12 * np.abs(x).max()


def test_layout_refuses_a_dependency_on_a_later_position():
    perm = np.array([0, 1, 2], dtype=np.int32)
    offs = np.array([0, 0, 1, 2])
    ok = dict(cols=np.array([0, 1]), vals=np.ones(2), dinv=np.ones(3),
              lvl_offs=np.array([0, 1, 2, 3]))
    ts.TriSweep.build(perm, offs, dtype=torch.float64, device=CPU, **ok)
    for bad in (dict(ok, cols=np.array([0, 2])),  # a later position
                dict(ok, lvl_offs=np.array([0, 1, 3]))):  # its own level
        with pytest.raises(ValueError, match="own or a later level"):
            ts.TriSweep.build(perm, offs, dtype=torch.float64, device=CPU,
                              **bad)


def test_wrapper_checks_and_counts_nothing_on_cpu():
    JA = _ordered("random_spd(300,9) amd")
    cp, ci, cx = t_ic0.ic0_factor(_port_csr(JA))
    state, _ = tsc.pack_tri(cp, ci, cx, JA.nrows, torch.float32, CPU)
    ts.reset_launches()
    b = torch.ones(JA.nrows)
    with pytest.raises(TypeError, match="must be torch.float32"):
        ts.tri_sweep(state.f, b.double())
    with pytest.raises(ValueError, match="shape"):
        ts.tri_sweep(state.f, b[:-1])
    with pytest.raises(ValueError, match="shape"):
        ts.tri_sweep(state.f, torch.ones(2 * JA.nrows)[::2])
    B = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (JA.nrows, 3)), dtype=torch.float32)
    X = ts.tri_sweep(state.f, B)
    for j in range(3):
        assert torch.equal(X[:, j], ts.tri_sweep(state.f, B[:, j].clone()))
    assert sum(ts.LAUNCHES.values()) == 0


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("label", sorted(CASES))
def test_ic0_apply_matches_jax(label, dtype, tol):
    JA = _ordered(label)
    A = _port_csr(JA)
    r = np.random.default_rng(3).standard_normal(JA.nrows)
    state, apply = t_ic0.ic0_precond(A, dtype, CPU)
    j_dt = jnp.float64 if dtype == torch.float64 else jnp.float32
    j_state, j_apply = j_ic0.ic0_precond(JA, j_dt)
    z = apply(state, torch.as_tensor(r, dtype=dtype)).numpy()
    z_jax = np.asarray(j_apply(j_state, jnp.asarray(r, j_dt)))
    assert z.dtype == np.dtype(str(dtype).split(".")[1])
    assert np.abs(z - z_jax).max() <= tol * np.abs(z_jax).max()


@pytest.mark.parametrize("label", sorted(CASES))
def test_fp64_cg_ic0_matches_jax(label):
    make, ordering = CASES[label]
    JA = make()
    b = make_rhs(JA.nrows)
    kw = dict(precond="ic0", layout="ell", ordering=ordering, rtol=1e-10)
    cls, params = get_solver("cg")
    port = cls(_port_csr(JA), device=CPU, **params, **kw).solve(b)
    j_cls, j_params = j_get_solver("cg")
    jax_res = j_cls(JA, **j_params, **kw).solve(b)
    assert port.converged and jax_res.converged
    assert abs(port.iters - jax_res.iters) <= 1
    assert port.x.dtype == torch.float64
    assert _xdiff(port.x.numpy(), jax_res.x) <= 1e-9
    # IC(0) beats Jacobi on iterations, as tests/test_ic0.py requires.
    jac = cls(_port_csr(JA), device=CPU, **params,
              **dict(kw, precond="jacobi")).solve(b)
    assert port.iters < 0.7 * jac.iters


@pytest.mark.parametrize("solver", ["cg_ir", "gmres", "bicgstab"])
@pytest.mark.parametrize("label", sorted(CASES))
def test_ir_solvers_with_ic0_reach_1e10(label, solver):
    """fp64 `cg_ir`, `gmres` and `bicgstab` (the last two as their IR
    twins) with IC(0) applied in f32, in both packages."""
    make, ordering = CASES[label]
    JA = make()
    b = make_rhs(JA.nrows)
    kw = dict(precond="ic0", ordering=ordering, rtol=1e-10)
    cls, params = get_solver(solver)
    params.update(kw)
    port = cls(_port_csr(JA), device=CPU, **params).solve(b)
    assert port.converged and _relres(JA, port.x.numpy(), b) <= 1e-10
    if solver == "cg_ir":
        j_cls, j_params = j_get_solver(solver)
        jax_res = j_cls(JA, **j_params, **kw).solve(b)
        assert _relres(JA, np.asarray(jax_res.x), b) <= 1e-10
        assert _xdiff(port.x.numpy(), jax_res.x) <= 1e-9
        assert port.extra["refine_passes"] == jax_res.extra["refine_passes"]


def test_block_cg_with_ic0_each_column_converges():
    """`--solver cg --nrhs 3 --precond ic0`: block CG's simultaneous
    recurrence, one IC(0) apply per column."""
    JA = _ordered("random_spd(300,9) amd")
    rng = np.random.default_rng(0)
    B = np.column_stack([make_rhs(JA.nrows)] + [rng.standard_normal(JA.nrows)
                                                for _ in range(2)])
    cls, params = get_solver("block_cg")
    s = cls(_port_csr(JA), device=CPU, precond="ic0", rtol=1e-10, **params)
    res = s.solve(B)
    assert s.method == "simultaneous"
    for j in range(3):
        assert _relres(JA, res.x[:, j].numpy(), B[:, j]) <= 1e-10


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _packs(label, dtype, device):
    JA = _ordered(label)
    cp, ci, cx = t_ic0.ic0_factor(_port_csr(JA))
    return tsc.pack_tri(cp, ci, cx, JA.nrows, dtype, device, plain=True)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("label", sorted(CASES))
def test_tri_sweep_kernel_matches_plain(label, dtype, tol, cuda_device):
    state = _packs(label, dtype, cuda_device)
    name = ts._NAMES[dtype]
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (state.f.n, 2)), dtype=dtype, device=cuda_device)
    for S in (state.f, state.b):
        plain = torch.stack([ts.tri_sweep_plain(S, b[:, j].contiguous())
                             for j in range(2)], dim=1)
        ts.reset_launches()
        x = ts.tri_sweep(S, b)
        torch.cuda.synchronize()
        # Both columns in one launch per segment of the sweep's plan.
        assert ts.LAUNCHES[name] == len(S.plan) and x.device == b.device
        assert (x - plain).abs().max() <= tol * plain.abs().max()
        # Each row's sum has a fixed order: repeat launches agree bit for bit.
        assert torch.equal(ts.tri_sweep(S, b), x)


@pytest.mark.cuda
def test_cg_ir_ic0_on_card(cuda_device):
    JA = _ordered("poisson_2d(40) rcm")
    b = make_rhs(JA.nrows)
    ts.reset_launches()
    cls, params = get_solver("cg_ir")
    res = cls(_port_csr(JA), device=cuda_device, precond="ic0",
              rtol=1e-10, **params).solve(b)
    assert ts.LAUNCHES["tri_sweep_f32"] > 0
    assert _relres(JA, res.x.cpu().numpy(), b) <= 1e-10
