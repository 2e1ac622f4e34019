"""Port parity: the BSR SpMV kernels' plain PyTorch versions against the JAX
Pallas kernels (interpret mode on the CPU, or the classed jnp reference,
which is what `spmv_bsr_classed` itself runs off the TPU) and the host f64
CSR matvec. The CUDA kernels themselves are compared with the plain
versions by the `cuda`-marked test below, on a card."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsbench_tpu.matrix import bsr as jbsr
from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.matrix.generate import random_spd as j_random_spd
from lsbench_tpu.ops import spmv_pallas as jops
from lsbench_tpu.ordering.rcm import rcm_ordering as j_rcm

from lsbench_tpu_torch.matrix import bsr as tbsr
from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ops import spmv_bsr as ops

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MATRICES = {
    "poisson17": lambda: j_poisson_2d(17),
    "random300": lambda: j_random_spd(300, nnz_per_row=9, seed=0),
    "poisson17_rcm": lambda: _rcm(j_poisson_2d(17)),
    "random300x17_rcm": lambda: _rcm(j_random_spd(300, nnz_per_row=17,
                                                  seed=2)),
}


# The Pallas interpret runs compile per shape: the f32 and f64 comparisons
# take the RCM-ordered matrices of the main path.
PALLAS_CASES = ["poisson17_rcm", "random300x17_rcm"]


def _rcm(A):
    return A.permuted(j_rcm(A))


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _x(n, seed, scale=1.0):
    return np.random.default_rng(seed).standard_normal(n) * scale


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_spmv_bsr_f32_plain_matches_pallas(name):
    JA = MATRICES[name]()
    B = tbsr.BsrMatrix.from_csr(_port_csr(JA), device=CPU)
    x = _x(JA.ncols, 1)
    y_jax = np.asarray(jops.spmv_bsr(jbsr.BsrMatrix.from_csr(JA),
                                     jnp.asarray(x), interpret=True))
    y = ops.spmv_bsr_plain(B, torch.as_tensor(x, dtype=torch.float32))
    assert y.dtype == torch.float32 and y.shape == (JA.nrows,)
    y = y.numpy().astype(np.float64)
    # f32 sums in another order: 1e-5 relative to (1 + |y|).
    assert (np.abs(y - y_jax) / (1.0 + np.abs(y_jax))).max() < 1e-5
    yref = JA.matvec(x)
    assert (np.abs(y - yref) / (1.0 + np.abs(yref))).max() < 1e-5
    # On CPU tensors the public wrapper IS the plain version.
    assert torch.equal(ops.spmv_bsr(B, torch.as_tensor(x, dtype=torch.float32)),
                       torch.as_tensor(y, dtype=torch.float32))


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_spmv_bsr_df64_plain_matches_pallas_and_host(name):
    JA = MATRICES[name]()
    A = _port_csr(JA)
    D = tbsr.BsrDf64.from_csr(A, device=CPU)
    x = _x(JA.ncols, 3, scale=1e3)
    y = ops.spmv_bsr_df64(D, torch.as_tensor(x))
    assert y.dtype == torch.float64 and y.shape == (JA.nrows,)
    y = y.numpy()
    y_jax = np.asarray(jops.spmv_bsr_df64(jbsr.BsrDf64.from_csr(JA),
                                          jnp.asarray(x), interpret=True))
    yref = A.matvec(x)
    # The double-float contract: ~2^-48 relative to max|y| (test_bsr.py:140).
    assert np.abs(y - y_jax).max() / np.abs(y_jax).max() < 5e-13
    assert np.abs(y - yref).max() / np.abs(yref).max() < 5e-13
    # Shared-hi form: hi taken from the f32 BsrMatrix gives the same result.
    B = tbsr.BsrMatrix.from_csr(A, device=CPU)
    y_lo = ops.spmv_bsr_df64_lo(B, D.blocks_lo, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(y_lo, y)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmv_bsr_classed_plain_matches_jax_reference(name):
    JA = MATRICES[name]()
    C = tbsr.BsrClassed.from_csr(_port_csr(JA), device=CPU)
    x = _x(JA.ncols, 4)
    JC = jbsr.BsrClassed.from_csr(JA)
    y_jax = np.asarray(JC.matvec_reference(jnp.asarray(x)))
    y = ops.spmv_bsr_classed(C, torch.as_tensor(x, dtype=torch.float32))
    assert y.dtype == torch.float32 and y.shape == (JA.nrows,)
    y = y.numpy().astype(np.float64)
    assert (np.abs(y - y_jax) / (1.0 + np.abs(y_jax))).max() < 1e-5
    # Uniform and classed layouts compute the same product.
    B = tbsr.BsrMatrix.from_csr(_port_csr(JA), device=CPU)
    y_uni = ops.spmv_bsr_plain(B, torch.as_tensor(x, dtype=torch.float32))
    assert (np.abs(y - y_uni.numpy()) / (1.0 + np.abs(y))).max() < 1e-5


def test_no_fallback_off_cpu_and_input_checks():
    A = _port_csr(j_poisson_2d(9))
    B = tbsr.BsrMatrix.from_csr(A, device=CPU)
    x = torch.ones(A.ncols)
    # A device that is neither the CPU nor CUDA never takes the plain path.
    with pytest.raises(ValueError, match="CPU"):
        ops.spmv_bsr(B.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="CPU"):
        ops.spmv_bsr(B, x.to("meta"))
    with pytest.raises(ValueError, match="shape"):
        ops.spmv_bsr(B, torch.ones(A.ncols + 1))
    with pytest.raises(TypeError):
        ops.spmv_bsr(tbsr.BsrMatrix.from_csr(A, dtype=torch.float64,
                                             device=CPU), x)
    D = tbsr.BsrDf64.from_csr(A, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        ops.spmv_bsr_df64_lo(B, D.blocks_lo[:-1], x.double())


def test_ops_import_builds_nothing(tmp_path):
    """Importing the ops and running them on the CPU needs no nvcc and no
    triton and builds nothing."""
    code = (
        "import sys, os, torch\n"
        "from lsbench_tpu_torch.ops import _cuda, spmv_bsr as ops\n"
        "from lsbench_tpu_torch.matrix.generate import poisson_2d\n"
        "from lsbench_tpu_torch.matrix.bsr import BsrMatrix\n"
        "A = poisson_2d(9)\n"
        "ops.spmv_bsr(BsrMatrix.from_csr(A, device='cpu'), torch.ones(81))\n"
        "assert _cuda._lib is None\n"
        "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n"
        "assert sum(ops.LAUNCHES.values()) == 0\n"
        "print(os.path.exists(_cuda.LIBRARY))\n")
    from lsbench_tpu_torch.ops import _cuda
    existed = os.path.exists(_cuda.LIBRARY)
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=REPO)
    env.pop("CUDA_HOME", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(existed)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_kernels_match_plain_on_card(name, cuda_device):
    A = _port_csr(MATRICES[name]())
    B = tbsr.BsrMatrix.from_csr(A, device=cuda_device)
    C = tbsr.BsrClassed.from_csr(A, device=cuda_device)
    D = tbsr.BsrDf64.from_csr(A, device=cuda_device)
    x64 = torch.as_tensor(_x(A.ncols, 5), device=cuda_device)
    x32 = x64.float()
    before = dict(ops.LAUNCHES)
    for kern, plain, x, rtol in (
            (ops.spmv_bsr(B, x32), ops.spmv_bsr_plain(B, x32), x32, 1e-5),
            (ops.spmv_bsr_classed(C, x32), ops.spmv_bsr_classed_plain(C, x32),
             x32, 1e-5),
            (ops.spmv_bsr_df64(D, x64), ops.spmv_bsr_df64_plain(D, x64), x64,
             1e-13),
            (ops.spmv_bsr_df64_lo(B, D.blocks_lo, x64),
             ops.spmv_bsr_df64_plain(D, x64), x64, 1e-13)):
        torch.cuda.synchronize()
        scale = float(plain.abs().max())
        assert float((kern - plain).abs().max()) <= rtol * scale
        assert kern.device == x.device and kern.dtype == plain.dtype
    assert ops.LAUNCHES["bsr_f32"] == before["bsr_f32"] + 1
    assert ops.LAUNCHES["bsr_classed_f32"] == before["bsr_classed_f32"] + len(C.blocks)
    assert ops.LAUNCHES["bsr_f64acc"] == before["bsr_f64acc"] + 2
