"""Port parity: the window-ELL transfer SpMV (K4). The layout arrays against
the JAX package's bit for bit; the plain PyTorch version, which reads x in
place, against the JAX Pallas kernel in interpret mode, the host f64 CSR
matvec (test_interp_pallas.py's tolerance, 2e-5) and the former zero-padded
x-table version (bit for bit); the layout's refusal of an index outside x.
The CUDA kernel is compared with the plain version by the `cuda`-marked
tests, on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsbench_tpu.matrix.csr import CsrMatrix as JCsr
from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.ops import interp_pallas as jwell
from lsbench_tpu.solvers.amg import AmgOptions as JOptions
from lsbench_tpu.solvers.amg import build_matrix_hierarchy as j_hierarchy

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ops import interp_well as ops

CPU = torch.device("cpu")


def _port_csr(M) -> CsrMatrix:
    return CsrMatrix(M.nrows, M.ncols, M.offs, M.cols, M.vals)


def _padding_case():
    """300 × 100, two entries per row: 300 is not a multiple of 128, so
    the padded rows must come out exactly 0."""
    rng = np.random.default_rng(2)
    n, nc = 300, 100
    rows = np.repeat(np.arange(n), 2)
    cols = np.clip(np.repeat(np.arange(n) // 3, 2) + np.tile([0, 1], n),
                   0, nc - 1)
    return JCsr.from_coo(rows, cols, rng.standard_normal(2 * n),
                         nrows=n, ncols=nc)


def _table_version(op, v):
    """The former plain version (the JAX kernel's source): v zero-padded to
    ceil(ncols/128) + J blocks, every slot of all n_pad rows."""
    ctab = -(-op.ncols // ops.TR) + op.j_blocks
    xt = torch.zeros(ctab * ops.TR, dtype=torch.float32)
    xt[: op.ncols] = v
    base = (op.w0.long() * ops.TR).repeat_interleave(ops.TR)
    return (op.vals * xt[base[None, :] + op.lcols.long()]).sum(0)


def _banded(n, k, seed):
    """n × n, k nonzeros per row in a band around the diagonal (k8 =
    k rounded up to 8)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = np.clip(rows + np.tile(np.arange(k) - k // 2, n), 0, n - 1)
    cols = np.where(rows < k, np.tile(np.arange(k), n), cols)
    return CsrMatrix.from_coo(rows, cols, rng.standard_normal(n * k),
                              nrows=n, ncols=n)


@pytest.fixture(scope="module")
def level0_transfers():
    mats, _ = j_hierarchy(j_poisson_2d(64),
                          JOptions(coarsening="classical", theta=0.25))
    return {"P0": mats[0]["P"], "R0": mats[0]["R"]}


def _operator(name, level0_transfers):
    return _padding_case() if name == "pad300x100" else level0_transfers[name]


@pytest.mark.parametrize("name", ["P0", "R0", "pad300x100"])
def test_spmv_well_plain_matches_pallas_and_host(name, level0_transfers):
    M = _operator(name, level0_transfers)
    jop = jwell.WindowEll.from_csr(M, max_j=16)
    op = ops.WindowEll.from_csr(_port_csr(M), max_j=16, device=CPU)
    assert jop is not None and op is not None
    # The same layout, bit for bit.
    for f in ("vals", "lcols", "w0"):
        np.testing.assert_array_equal(getattr(op, f).numpy(),
                                      np.asarray(getattr(jop, f)))
    assert (op.j_blocks, op.k_real, op.nnz) == (jop.j_blocks, jop.k_real,
                                                jop.nnz)
    assert op.bytes_streamed == jop.bytes_streamed

    v = np.random.default_rng(0).standard_normal(M.ncols)
    y = ops.spmv_well(op, torch.as_tensor(v, dtype=torch.float32))
    assert y.dtype == torch.float32 and y.shape == (M.nrows,)
    y = y.numpy().astype(np.float64)
    y_jax = np.asarray(jwell.spmv_well(jop, jnp.asarray(v, jnp.float32),
                                       interpret=True))
    ref = M.matvec(v)
    for other in (y_jax, ref):
        np.testing.assert_allclose(y, other, rtol=2e-5,
                                   atol=2e-5 * np.abs(ref).max())
    # The table version over all n_pad rows: its padding rows are exactly
    # zero, and its real rows are the in-place version's.
    full = _table_version(op, torch.as_tensor(v, dtype=torch.float32))
    assert torch.count_nonzero(full[M.nrows:]) == 0
    assert ops.LAUNCHES["well_f32"] == 0


@pytest.mark.parametrize("name", ["P0", "R0", "pad300x100"])
def test_spmv_well_in_place_equals_table_version(name, level0_transfers):
    """x read in place gives the former zero-padded table's result, and
    every index the kernel would read lies in [0, ncols)."""
    M = _operator(name, level0_transfers)
    op = ops.WindowEll.from_csr(_port_csr(M), max_j=16, device=CPU)
    v = torch.as_tensor(np.random.default_rng(4).standard_normal(M.ncols),
                        dtype=torch.float32)
    y = ops.spmv_well_plain(op, v)
    assert y.shape == (M.nrows,)
    torch.testing.assert_close(y, _table_version(op, v)[: M.nrows],
                               rtol=0, atol=0)
    idx = ops._read_index(op)
    assert idx.shape == (op.k_real, M.nrows)
    assert int(idx.min()) >= 0 and int(idx.max()) < M.ncols


def test_from_jax_arrays_refuses_reads_outside_x(level0_transfers):
    """A layout whose index reaches ncols (or falls below 0) is refused: the
    kernel reads x in place, with no zero-padded table behind it."""
    jop = jwell.WindowEll.from_csr(level0_transfers["P0"])
    w0 = np.asarray(jop.w0)
    kw = dict(vals=np.asarray(jop.vals), w0=w0, nrows=jop.nrows,
              ncols=jop.ncols, nnz=jop.nnz, j_blocks=jop.j_blocks,
              k_real=jop.k_real, device=CPU)
    r = jop.nrows - 1
    for reach in (jop.ncols, -1):
        lcols = np.array(jop.lcols)
        lcols[0, r] = reach - ops.TR * w0[r // ops.TR]
        with pytest.raises(ValueError, match="outside"):
            ops.WindowEll.from_jax_arrays(lcols=lcols, **kw)
    # Past k_real and past nrows nothing is read, so nothing is checked.
    lcols = np.array(jop.lcols)
    lcols[jop.k_real:, :] = 10**6
    lcols[:, jop.nrows:] = 10**6
    op = ops.WindowEll.from_jax_arrays(lcols=lcols, **kw)
    v = torch.ones(jop.ncols)
    assert torch.equal(ops.spmv_well(op, v), ops.spmv_well(
        ops.WindowEll.from_jax_arrays(lcols=np.asarray(jop.lcols), **kw), v))


def test_wide_layouts():
    """k8 = 8, 16, 24 (the AMG's max_k=24) and 32 are laid out, and the
    plain version reads x in place for each."""
    for k, k8 in ((5, 8), (13, 16), (21, 24), (27, 32)):
        M = _banded(600, k, k)
        op = ops.WindowEll.from_csr(M, max_k=32, device=CPU)
        assert (op.k8, op.k_real) == (k8, k)
        v = np.random.default_rng(k).standard_normal(M.ncols)
        y = ops.spmv_well(op, torch.as_tensor(v, dtype=torch.float32))
        ref = M.matvec(v)
        assert np.abs(y.numpy() - ref).max() <= 2e-5 * np.abs(ref).max()


def test_from_jax_arrays_carries_the_layout(level0_transfers):
    jop = jwell.WindowEll.from_csr(level0_transfers["P0"])
    op = ops.WindowEll.from_jax_arrays(
        vals=np.asarray(jop.vals), lcols=np.asarray(jop.lcols),
        w0=np.asarray(jop.w0), nrows=jop.nrows, ncols=jop.ncols,
        nnz=jop.nnz, j_blocks=jop.j_blocks, k_real=jop.k_real, device=CPU)
    mine = ops.WindowEll.from_csr(_port_csr(level0_transfers["P0"]),
                                  device=CPU)
    for f in ("vals", "lcols", "w0"):
        assert torch.equal(getattr(op, f), getattr(mine, f))
    with pytest.raises(ValueError, match="int32"):
        ops.WindowEll.from_jax_arrays(
            vals=np.asarray(jop.vals), lcols=np.asarray(jop.lcols, np.int64),
            w0=np.asarray(jop.w0), nrows=jop.nrows, ncols=jop.ncols,
            nnz=jop.nnz, j_blocks=jop.j_blocks, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        ops.WindowEll.from_jax_arrays(
            vals=np.asarray(jop.vals), lcols=np.asarray(jop.lcols),
            w0=np.asarray(jop.w0)[:-1], nrows=jop.nrows, ncols=jop.ncols,
            nnz=jop.nnz, j_blocks=jop.j_blocks, device=CPU)


def test_from_csr_refuses_what_jax_refuses():
    # A random permutation operator has full-width windows.
    rng = np.random.default_rng(1)
    n = 2048
    M = CsrMatrix.from_coo(np.arange(n), rng.permutation(n), np.ones(n),
                           nrows=n, ncols=n)
    assert ops.WindowEll.from_csr(M, max_j=4, device=CPU) is None
    assert jwell.WindowEll.from_csr(
        JCsr(M.nrows, M.ncols, M.offs, M.cols, M.vals), max_j=4) is None
    # Only f32 is laid out (the JAX `from_csr`'s dtype gate).
    band = CsrMatrix.from_coo(np.arange(n), np.arange(n), np.ones(n))
    assert ops.WindowEll.from_csr(band, device=CPU) is not None
    assert ops.WindowEll.from_csr(band, dtype=torch.float64,
                                  device=CPU) is None


def test_no_fallback_off_cpu_and_input_checks():
    M = _port_csr(_padding_case())
    op = ops.WindowEll.from_csr(M, device=CPU)
    with pytest.raises(ValueError, match="CPU"):
        ops.spmv_well(op, torch.ones(M.ncols, device="meta"))
    with pytest.raises(ValueError, match="shape"):
        ops.spmv_well(op, torch.ones(M.ncols + 1))
    with pytest.raises(ValueError, match="shape"):
        ops.spmv_well(op, torch.ones(2 * M.ncols)[::2])
    with pytest.raises(TypeError):
        ops.spmv_well(op, torch.ones(M.ncols, dtype=torch.float64))
    assert ops.LAUNCHES["well_f32"] == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["P0", "R0", "pad300x100"])
def test_well_kernel_matches_plain_on_card(name, level0_transfers,
                                           cuda_device):
    M = _port_csr(_operator(name, level0_transfers))
    op = ops.WindowEll.from_csr(M, max_j=16, device=cuda_device)
    v = torch.as_tensor(np.random.default_rng(5).standard_normal(M.ncols),
                        dtype=torch.float32, device=cuda_device)
    before = ops.LAUNCHES["well_f32"]
    y = ops.spmv_well(op, v)
    plain = ops.spmv_well_plain(op, v)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["well_f32"] == before + 1
    assert y.device == v.device and y.shape == (M.nrows,)
    assert float((y - plain).abs().max()) <= 1e-5 * float(plain.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 8, 13, 21])
def test_well_kernel_slot_counts_on_card(k, cuda_device):
    """k8 = 8, 16, 24 against the plain version, with a k_real below and at
    k8, on n not a multiple of 128."""
    M = _banded(1000, k, k)
    op = ops.WindowEll.from_csr(M, max_k=24, device=cuda_device)
    v = torch.as_tensor(np.random.default_rng(k).standard_normal(M.ncols),
                        dtype=torch.float32, device=cuda_device)
    before = ops.LAUNCHES["well_f32"]
    y, y_again = ops.spmv_well(op, v), ops.spmv_well(op, v)
    plain = ops.spmv_well_plain(op, v)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["well_f32"] == before + 2
    assert torch.equal(y, y_again)
    assert float((y - plain).abs().max()) <= 1e-5 * float(plain.abs().max())
    ref = M.matvec(v.double().cpu().numpy())
    assert np.abs(y.double().cpu().numpy() - ref).max() <= (
        2e-5 * np.abs(ref).max())
