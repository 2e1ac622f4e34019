"""Port parity for the multi-RHS SpMM (kernel K3): the BSR port
`spmm_bsr_plain` and the sliced-ELL redesign `spmm_sell_plain` (the solver
paths' SpMM) against the JAX package's `spmm_bsr` in Pallas interpret mode
and against the host f64 product, column by column against the SpMV's
plain version, and the wrappers' dispatch and input checks. The CUDA
kernels themselves are held to their plain versions by the `cuda`-marked
tests, on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsbench_tpu.matrix import bsr as jbsr
from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.matrix.generate import random_spd as j_random_spd
from lsbench_tpu.ops import spmv_pallas as jops

from lsbench_tpu_torch.matrix import bsr as tbsr
from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.sell import SellMatrix
from lsbench_tpu_torch.ops import spmv_bsr as ops
from lsbench_tpu_torch.ops import spmv_sell as sell

CPU = torch.device("cpu")

# test_block_cg.py's SpMM matrices: 300 rows (ncols not a multiple of 128,
# so the x table has a zero tail) and poisson_2d(20), 400 rows.
MATRICES = {
    "random_spd(300,9)": lambda: j_random_spd(300, nnz_per_row=9, seed=2),
    "poisson_2d(20)": lambda: j_poisson_2d(20),
}


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _X(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k))


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmm_plain_matches_pallas_and_host(name, k):
    JA = MATRICES[name]()
    A = _port_csr(JA)
    B = tbsr.BsrMatrix.from_csr(A, device=CPU)
    X = _X(A.ncols, k, k)
    Y_jax = np.asarray(jops.spmm_bsr(jbsr.BsrMatrix.from_csr(JA),
                                     jnp.asarray(X, jnp.float32),
                                     interpret=True))
    Y = ops.spmm_bsr_plain(B, torch.as_tensor(X, dtype=torch.float32))
    assert Y.dtype == torch.float32 and Y.shape == (A.nrows, k)
    Y = Y.numpy().astype(np.float64)
    Y_host = A.to_dense() @ X
    # f32 sums in another order than the MXU's and the host's: 1e-5
    # relative to max|Y| (test_block_cg.py::test_spmm_matches_dense).
    assert np.abs(Y - Y_jax).max() / np.abs(Y_jax).max() < 1e-5
    assert np.abs(Y - Y_host).max() / np.abs(Y_host).max() < 1e-5
    # On CPU tensors the public wrapper is the plain version.
    Xt = torch.as_tensor(X, dtype=torch.float32)
    assert torch.equal(ops.spmm_bsr(B, Xt), ops.spmm_bsr_plain(B, Xt))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmm_column_equals_spmv(name):
    A = _port_csr(MATRICES[name]())
    B = tbsr.BsrMatrix.from_csr(A, device=CPU)
    X = torch.as_tensor(_X(A.ncols, 4, 0), dtype=torch.float32)
    Y = ops.spmm_bsr_plain(B, X)
    for j in range(4):
        y = ops.spmv_bsr_plain(B, X[:, j].contiguous())
        torch.testing.assert_close(Y[:, j], y, rtol=2e-6, atol=1e-6)


def test_x_table_matches_jax_layout():
    """The (n_cb, k, 128) table is the JAX package's pad-and-transpose."""
    X = _X(300, 3, 1).astype(np.float32)
    xt = ops._x_table_mm(torch.as_tensor(X), 300, 3)
    X_pad = np.zeros((384, 3), np.float32)
    X_pad[:300] = X
    np.testing.assert_array_equal(
        xt.numpy(), X_pad.reshape(3, 128, 3).transpose(0, 2, 1))


def test_spmm_no_fallback_off_cpu_and_input_checks():
    A = _port_csr(j_poisson_2d(9))
    B = tbsr.BsrMatrix.from_csr(A, device=CPU)
    X = torch.ones(A.ncols, 2)
    # A device that is neither the CPU nor CUDA never takes the plain path.
    with pytest.raises(ValueError, match="CPU"):
        ops.spmm_bsr(B.to("meta"), X.to("meta"))
    with pytest.raises(ValueError, match="CPU"):
        ops.spmm_bsr(B, X.to("meta"))
    for bad in (torch.ones(A.ncols + 1, 2), torch.ones(A.ncols, 0),
                torch.ones(A.ncols)):
        with pytest.raises(ValueError, match="shape"):
            ops.spmm_bsr(B, bad)
    with pytest.raises(TypeError):
        ops.spmm_bsr(tbsr.BsrMatrix.from_csr(A, dtype=torch.float64,
                                             device=CPU), X)
    assert ops.LAUNCHES["bsr_mm_f32"] == 0


@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmm_sell_plain_matches_pallas_and_host(name, k):
    """The SELL SpMM's plain version against the JAX BSR kernel within
    1e-5·max|Y_j| and the host f64 product within 2e-5·max|Y_j|, per
    column (f32 sums in entry order, the MXU's and the host's in others)."""
    JA = MATRICES[name]()
    A = _port_csr(JA)
    S = SellMatrix.from_csr(A, device=CPU)
    X = _X(A.ncols, k, 10 + k)
    Y_jax = np.asarray(jops.spmm_bsr(jbsr.BsrMatrix.from_csr(JA),
                                     jnp.asarray(X, jnp.float32),
                                     interpret=True)).astype(np.float64)
    Xt = torch.as_tensor(X, dtype=torch.float32)
    Y = sell.spmm_sell_plain(S, Xt)
    assert Y.dtype == torch.float32 and Y.shape == (A.nrows, k)
    Y = Y.numpy().astype(np.float64)
    Y_host = A.to_dense() @ X
    scale = np.abs(Y_host).max(axis=0)
    assert np.all(np.abs(Y - Y_jax).max(axis=0) <= 1e-5 * scale)
    assert np.all(np.abs(Y - Y_host).max(axis=0) <= 2e-5 * scale)
    # On CPU tensors the public wrapper is the plain version.
    assert torch.equal(sell.spmm_sell(S, Xt), sell.spmm_sell_plain(S, Xt))
    assert sell.LAUNCHES["sell_mm_f32"] == 0


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmm_sell_column_equals_spmv_sell(name):
    """Each column sums in the SpMV's entry order: bit for bit."""
    A = _port_csr(MATRICES[name]())
    S = SellMatrix.from_csr(A, device=CPU)
    X = torch.as_tensor(_X(A.ncols, 5, 1), dtype=torch.float32)
    Y = sell.spmm_sell_plain(S, X)
    for j in range(5):
        assert torch.equal(Y[:, j], sell.spmv_sell_plain(S, X[:, j].contiguous()))


def test_spmm_sell_no_fallback_off_cpu_and_input_checks():
    A = _port_csr(j_poisson_2d(9))
    S = SellMatrix.from_csr(A, device=CPU)
    X = torch.ones(A.ncols, 2)
    # Operands on two devices, or on one that is neither the CPU nor CUDA,
    # never take the plain path.
    with pytest.raises(ValueError, match="layout on cpu"):
        sell.spmm_sell(S, X.to("meta"))
    with pytest.raises(ValueError, match="CPU"):
        sell.spmm_sell(S.to("meta"), X.to("meta"))
    for bad in (torch.ones(A.ncols + 1, 2), torch.ones(A.ncols, 0),
                torch.ones(A.ncols), torch.ones(2, A.ncols).T,
                torch.ones(A.ncols, 2, 1)):
        with pytest.raises(ValueError, match="shape"):
            sell.spmm_sell(S, bad)
    with pytest.raises(TypeError):
        sell.spmm_sell(S, X.double())
    with pytest.raises(ValueError, match="no torch.float32"):
        sell.spmm_sell(SellMatrix.from_csr(A, dtypes=(torch.float64,),
                                           device=CPU), X)
    assert sell.LAUNCHES["sell_mm_f32"] == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 8, 11, 16])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmm_kernel_matches_plain_on_card(name, k, cuda_device):
    A = _port_csr(MATRICES[name]())
    B = tbsr.BsrMatrix.from_csr(A, device=cuda_device)
    X = torch.as_tensor(_X(A.ncols, k, k), dtype=torch.float32,
                        device=cuda_device)
    before = ops.LAUNCHES["bsr_mm_f32"]
    Y = ops.spmm_bsr(B, X)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["bsr_mm_f32"] == before + 1
    assert Y.device == X.device and Y.shape == (A.nrows, k)
    P = ops.spmm_bsr_plain(B, X)
    assert float((Y - P).abs().max()) <= 1e-5 * float(P.abs().max())


# The SELL SpMM's instances: KC = 1, 2, 4 (k = 3, masked), 8 (k = 8; k = 11
# as a chunk of 8 and a masked chunk of 3), 16; vector accesses where
# k % 4 == 0 and X is 16-byte aligned.
@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 8, 11, 16])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmm_sell_kernel_matches_plain_on_card(name, k, cuda_device):
    A = _port_csr(MATRICES[name]())
    S = SellMatrix.from_csr(A, device=cuda_device)
    X = torch.as_tensor(_X(A.ncols, k, k), dtype=torch.float32,
                        device=cuda_device)
    before = sell.LAUNCHES["sell_mm_f32"]
    Y, Y_again = sell.spmm_sell(S, X), sell.spmm_sell(S, X)
    torch.cuda.synchronize()
    assert sell.LAUNCHES["sell_mm_f32"] == before + 2
    assert Y.device == X.device and Y.shape == (A.nrows, k)
    assert torch.equal(Y, Y_again)
    P = sell.spmm_sell_plain(S, X)
    assert torch.all((Y - P).abs().amax(dim=0) <= 1e-5 * P.abs().amax(dim=0))
    # Each column bit for bit the f32 SpMV kernel's.
    for j in range(k):
        assert torch.equal(Y[:, j], sell.spmv_sell(S, X[:, j].contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 8, 16])
def test_spmm_sell_unaligned_x_on_card(k, cuda_device):
    """X 4 bytes off a 16-byte boundary takes the scalar accesses and gives
    the aligned result bit for bit."""
    A = _port_csr(MATRICES["random_spd(300,9)"]())
    S = SellMatrix.from_csr(A, device=cuda_device)
    X = torch.as_tensor(_X(A.ncols, k, 3), dtype=torch.float32,
                        device=cuda_device)
    buf = torch.empty(A.ncols * k + 1, dtype=torch.float32,
                      device=cuda_device)
    Xu = buf[1:].view(A.ncols, k)
    Xu.copy_(X)
    assert Xu.data_ptr() % 16 != 0
    assert torch.equal(sell.spmm_sell(S, Xu), sell.spmm_sell(S, X))


@pytest.mark.cuda
def test_spmm_sell_refuses_cpu_cuda_mix_on_card(cuda_device):
    A = _port_csr(j_poisson_2d(9))
    S = SellMatrix.from_csr(A, device=cuda_device)
    with pytest.raises(ValueError, match="layout on cuda"):
        sell.spmm_sell(S, torch.ones(A.ncols, 2))
    with pytest.raises(ValueError, match="layout on cpu"):
        sell.spmm_sell(S.to("cpu"), torch.ones(A.ncols, 2,
                                               device=cuda_device))
