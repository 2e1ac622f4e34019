"""Port parity for the blocked band Cholesky (`solvers/band_cholesky.py`,
`cholesky_band`) against the JAX package on the CPU.

Bars: `band_layout`'s host arrays are the JAX package's bit for bit;
`factor_band` and `solve_band` agree with the JAX functions (run as
tests/test_band_cholesky.py runs them, jitted on the CPU) within 1e-12 in
f64 and 1e-5 in f32, relative to the largest entry; `cholesky_band`
reaches true relres ≤ 1e-10 with the JAX package's refinement passes and x
within 1e-9·‖x‖ of the JAX x; its band-size guard refuses a matrix that
is not banded enough, with the JAX message."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.matrix.generate import random_spd as j_random_spd
from lsbench_tpu.solvers import band_cholesky as jb
from lsbench_tpu.solvers.base import get_solver as j_get_solver

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ops import spmv_sell
from lsbench_tpu_torch.solvers import band_cholesky as tb
from lsbench_tpu_torch.solvers import get_solver

from conftest import make_rhs

CPU = torch.device("cpu")

# label → (JAX matrix, block size nb)
CASES = {"poisson_2d(12)": (lambda: j_poisson_2d(12), 128),
         "poisson_2d(20) nb=16": (lambda: j_poisson_2d(20), 16),
         "random_spd(300,9) nb=32": (lambda: j_random_spd(300, 9), 32)}


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _symmetric(JA):
    from lsbench_tpu.solvers.sparse_cholesky import symmetrize
    return symmetrize(JA)


@pytest.mark.parametrize("label", sorted(CASES))
def test_band_layout_bitwise_equal_jax(label):
    make, nb = CASES[label]
    JA = _symmetric(make())
    mine = tb.band_layout(_port_csr(JA), nb=nb)
    theirs = jb.band_layout(JA, nb=nb)
    for a, b_ in zip(mine, theirs, strict=True):
        np.testing.assert_array_equal(a, b_)


def _jax_factor(W0, slabs, nb, dt):
    return jax.jit(lambda W, S: jb.factor_band(W, S, nb=nb))(
        jnp.asarray(W0, dt), jnp.asarray(slabs, dt))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("label", sorted(CASES))
def test_factor_and_solve_band_match_jax(label, dtype, tol):
    make, nb = CASES[label]
    JA = _symmetric(make())
    W0, slabs, nsteps, w, _ = jb.band_layout(JA, nb=nb)
    dt = jnp.float64 if dtype == torch.float64 else jnp.float32
    j_Ld, j_Lp = (np.asarray(a) for a in _jax_factor(W0, slabs, nb, dt))
    Ld, Lp = tb.factor_band(torch.as_tensor(W0, dtype=dtype),
                            torch.as_tensor(slabs, dtype=dtype), nb=nb)
    assert Ld.shape == (nsteps, nb, nb) and Lp.shape == (nsteps, w, nb)
    for mine, theirs in ((Ld, j_Ld), (Lp, j_Lp)):
        assert np.abs(mine.numpy() - theirs).max() \
            <= tol * np.abs(theirs).max()

    b = np.zeros(nsteps * nb)
    b[:JA.nrows] = np.random.default_rng(5).standard_normal(JA.nrows)
    x = tb.solve_band(Ld, Lp, torch.as_tensor(b, dtype=dtype), nb=nb)
    x_jax = np.asarray(jb.solve_band(jnp.asarray(j_Ld), jnp.asarray(j_Lp),
                                     jnp.asarray(b, dt), nb=nb))
    assert x.dtype == dtype and x.shape == b.shape
    assert np.abs(x.numpy() - x_jax).max() <= tol * np.abs(x_jax).max()
    if dtype == torch.float64:
        ref = np.linalg.solve(JA.to_dense(), b[:JA.nrows])
        assert np.abs(x.numpy()[:JA.nrows] - ref).max() \
            <= 1e-10 * np.abs(ref).max()


def test_factor_band_refuses_indefinite():
    JA = j_poisson_2d(6)
    W0, slabs, *_ = jb.band_layout(JA, nb=8)
    W0 = -W0
    with pytest.raises(np.linalg.LinAlgError, match="not positive definite"):
        tb.factor_band(torch.as_tensor(W0), torch.as_tensor(slabs), nb=8)


@pytest.mark.parametrize("ordering", ["rcm", "none"])
@pytest.mark.parametrize("label", ["poisson_2d(20) nb=16",
                                   "random_spd(300,9) nb=32"])
def test_cholesky_band_matches_jax(label, ordering):
    make, nb = CASES[label]
    JA = make()
    b = make_rhs(JA.nrows)
    kw = dict(ordering=ordering, nb=nb, rtol=1e-10)
    cls, params = get_solver("cholesky_band")
    spmv_sell.reset_launches()
    port = cls(_port_csr(JA), device=CPU, **params, **kw).solve(b)
    j_cls, j_params = j_get_solver("cholesky_band")
    jax_res = j_cls(JA, **j_params, **kw).solve(b)
    assert sum(spmv_sell.LAUNCHES.values()) == 0
    assert port.converged and jax_res.converged
    assert port.x.dtype == torch.float64 and port.x.shape == b.shape
    assert port.extra["precision_mode"] == "fp32_ir_auto"
    assert port.extra["bandwidth"] == jax_res.extra["bandwidth"]
    assert port.iters == port.extra["refine_passes"] \
        == jax_res.extra["refine_passes"]
    x = port.x.numpy()
    assert np.linalg.norm(b - JA.matvec(x)) / np.linalg.norm(b) <= 1e-10
    assert np.linalg.norm(x - np.asarray(jax_res.x)) \
        / np.linalg.norm(np.asarray(jax_res.x)) <= 1e-9


def test_cholesky_band_guard_refuses_wide_band():
    JA = j_random_spd(300, 9)
    kw = dict(ordering="none", nb=32, max_band_mb=0.5)
    cls, _ = get_solver("cholesky_band")
    with pytest.raises(ValueError, match="not banded enough") as port:
        cls(_port_csr(JA), device=CPU, **kw)
    with pytest.raises(ValueError, match="not banded enough") as jax_err:
        jb.BandCholeskySolver(JA, **kw)
    assert str(port.value) == str(jax_err.value)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cholesky_band_on_card(cuda_device):
    """On the card the refinement residual is `spmv_sell_f64`; the passes
    and x match the plain run's."""
    JA = j_poisson_2d(20)
    b = make_rhs(JA.nrows)
    cls, params = get_solver("cholesky_band")
    plain = cls(_port_csr(JA), device=CPU, nb=16, **params).solve(b)
    spmv_sell.reset_launches()
    res = cls(_port_csr(JA), device=cuda_device, nb=16, **params).solve(b)
    assert spmv_sell.LAUNCHES["sell_f64"] > 0
    assert res.extra["refine_passes"] == plain.extra["refine_passes"]
    x = res.x.cpu().numpy()
    assert np.linalg.norm(b - JA.matvec(x)) / np.linalg.norm(b) <= 1e-10
