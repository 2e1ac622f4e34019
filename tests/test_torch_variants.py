"""Port parity: the exact-block layout (BsrCompact), the one-hot selector and
the three alternate SpMV kernels K6 (`spmv_bsr_compact`), K7
(`spmv_bsr(variant="selector")`) and K8 (`variant="onehot"`).

On the CPU the plain PyTorch versions are held to the JAX Pallas kernels in
interpret mode (exact f32, K8's intended result) and to the host f64 CSR
matvec, at 1e-5 relative to (1 + |y|) (f32 sums in another order); layouts
must match the JAX arrays bit for bit. The CUDA kernels are held to their
plain versions by the `cuda`-marked tests, on a card; K6, K7 and K8 there
run the SELL f32 kernel over the layouts' packed forms
(`tests/test_torch_pack.py` holds those forms on the CPU), so they also
give `spmv_sell`'s bits."""

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
from lsbench_tpu_torch.matrix.sell import SellMatrix
from lsbench_tpu_torch.ops import spmv_bsr as ops
from lsbench_tpu_torch.ops import spmv_sell

CPU = torch.device("cpu")

# The JAX package's own test matrices (tests/test_bsr.py) and their RCM
# orders.
BASE = {
    "random_spd(300,9)": lambda: j_random_spd(300, nnz_per_row=9, seed=0),
    "poisson_2d(17)": lambda: j_poisson_2d(17),
    "random_spd(64,3)": lambda: j_random_spd(64, nnz_per_row=3, seed=2),
}
MATRICES = {**BASE, **{f"{k} RCM": (lambda m=m: _rcm(m()))
                       for k, m in BASE.items()}}


def _rcm(A):
    return A.permuted(j_rcm(A))


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _x(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def _bits_equal(t, j):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    b = np.asarray(j)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _close(y, ref):
    return (np.abs(y - ref) / (1.0 + np.abs(ref))).max() < 1e-5


# ------------------------------------------------------------ layouts

@pytest.mark.parametrize("name", sorted(MATRICES))
def test_compact_layout_bit_identical(name):
    JA = MATRICES[name]()
    C = tbsr.BsrCompact.from_csr(_port_csr(JA), device=CPU)
    JC = jbsr.BsrCompact.from_csr(JA)
    for t, j in ((C.blocks, JC.blocks), (C.gids, JC.gids),
                 (C.bcols, JC.bcols)):
        _bits_equal(t, j)
    assert (C.n_groups, C.n_blocks, C.n_col_blocks, C.bytes_streamed) == (
        JC.n_groups, JC.n_blocks, JC.n_col_blocks, JC.bytes_streamed)
    # The packed form the card runs K6 on is the CSR's SELL layout.
    P, R = C.packed(), SellMatrix.from_csr(_port_csr(JA), device=CPU)
    for f in ("cols", "slice_off", "vals"):
        assert torch.equal(getattr(P, f), getattr(R, f)), f


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_selector_bit_identical(name):
    JA = MATRICES[name]()
    A = _port_csr(JA)
    JB = jbsr.BsrMatrix.from_csr(JA, with_sel=True)
    B = tbsr.BsrMatrix.from_csr(A, device=CPU, with_sel=True)
    _bits_equal(B.sel, JB.sel)
    _bits_equal(tbsr._bsr_selector(B.block_cols.numpy(), A.ncols),
                jbsr._bsr_selector(np.asarray(JB.block_cols), JA.ncols))
    lazy = tbsr.BsrMatrix.from_csr(A, device=CPU)
    assert lazy.sel is None
    assert lazy.ensure_sel() is lazy and torch.equal(lazy.sel, B.sel)
    moved = B.to("meta")
    assert moved.sel.device.type == "meta"


def test_from_jax_arrays_compact_and_selector():
    JA = _rcm(j_poisson_2d(17))
    A = _port_csr(JA)
    meta = dict(nrows=JA.nrows, ncols=JA.ncols, nnz=JA.nnz)
    JC = jbsr.BsrCompact.from_csr(JA)
    arrays = dict(blocks=np.asarray(JC.blocks), gids=np.asarray(JC.gids),
                  bcols=np.asarray(JC.bcols), n_groups=JC.n_groups)
    C = tbsr.from_jax_arrays(device=CPU, **meta, **arrays)
    ref = tbsr.BsrCompact.from_csr(A, device=CPU)
    assert isinstance(C, tbsr.BsrCompact)
    for t, r in ((C.blocks, ref.blocks), (C.gids, ref.gids),
                 (C.bcols, ref.bcols)):
        assert torch.equal(t, r)

    JB = jbsr.BsrMatrix.from_csr(JA, with_sel=True)
    uni = dict(blocks=np.asarray(JB.blocks),
               block_cols=np.asarray(JB.block_cols))
    B = tbsr.from_jax_arrays(sel=np.asarray(JB.sel), device=CPU, **meta,
                             **uni)
    assert isinstance(B, tbsr.BsrMatrix)
    _bits_equal(B.sel, JB.sel)
    assert torch.equal(B.block_cols,
                       tbsr.BsrMatrix.from_csr(A, device=CPU).block_cols)

    # Outside input is checked: a selector row that is not one-hot, or not
    # at its block column; out-of-range ids. Unsorted gids are taken: the
    # product sums each block into y[gid] in any order, as the JAX kernel
    # does.
    sel = np.asarray(JB.sel)
    for bad_sel in (sel * 2.0, np.roll(sel, 1, axis=1),
                    np.concatenate([sel[:, :1] * 0, sel[:, 1:]], axis=1)):
        with pytest.raises(ValueError, match="one-hot"):
            tbsr.from_jax_arrays(sel=bad_sel.astype(np.float32), device=CPU,
                                 **meta, **uni)
    with pytest.raises(ValueError, match="selector of shape"):
        tbsr.from_jax_arrays(sel=sel[:-1], device=CPU, **meta, **uni)
    bad = dict(arrays, gids=arrays["gids"].copy())
    bad["gids"][0] = JC.n_groups
    with pytest.raises(ValueError, match="row group id"):
        tbsr.from_jax_arrays(device=CPU, **meta, **bad)
    bad = dict(arrays, bcols=arrays["bcols"].copy())
    bad["bcols"][0] = -1
    with pytest.raises(ValueError, match="block column"):
        tbsr.from_jax_arrays(device=CPU, **meta, **bad)
    order = np.arange(JC.n_blocks)
    order[[0, 5]] = order[[5, 0]]  # two nonzero blocks of other groups
    shuffled = dict(arrays, blocks=arrays["blocks"][order],
                    gids=arrays["gids"][order], bcols=arrays["bcols"][order])
    S = tbsr.from_jax_arrays(device=CPU, **meta, **shuffled)
    x = _x(JA.ncols, 9)
    xt = torch.as_tensor(x, dtype=torch.float32)
    y_jax = np.asarray(jops.spmv_bsr_compact(
        jbsr.BsrCompact(blocks=jnp.asarray(shuffled["blocks"]),
                        gids=jnp.asarray(shuffled["gids"]),
                        bcols=jnp.asarray(shuffled["bcols"]),
                        nrows=JA.nrows, ncols=JA.ncols, nnz=JA.nnz,
                        n_groups=JC.n_groups),
        jnp.asarray(x), interpret=True))
    for y in (ops.spmv_bsr_compact(S, xt),
              spmv_sell.spmv_sell_plain(S.packed(), xt)):
        assert _close(y.numpy().astype(np.float64), y_jax)
    with pytest.raises(ValueError, match="one entry per block"):
        tbsr.from_jax_arrays(device=CPU, **meta,
                             **dict(arrays, gids=arrays["gids"][:-1]))


# --------------------------------------------- kernels' plain versions

@pytest.mark.parametrize("name", sorted(MATRICES))
def test_compact_plain_matches_pallas(name):
    JA = MATRICES[name]()
    C = tbsr.BsrCompact.from_csr(_port_csr(JA), device=CPU)
    x = _x(JA.ncols, 1)
    xt = torch.as_tensor(x, dtype=torch.float32)
    y = ops.spmv_bsr_compact_plain(C, xt)
    assert y.dtype == torch.float32 and y.shape == (JA.nrows,)
    y_jax = np.asarray(jops.spmv_bsr_compact(jbsr.BsrCompact.from_csr(JA),
                                             jnp.asarray(x), interpret=True))
    assert _close(y.numpy().astype(np.float64), y_jax)
    assert _close(y.numpy().astype(np.float64), JA.matvec(x))
    # On CPU tensors the public wrapper IS the plain version.
    assert torch.equal(ops.spmv_bsr_compact(C, xt), y)


@pytest.mark.parametrize("variant", ["selector", "onehot"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_gather_variants_plain_match_pallas(name, variant):
    JA = MATRICES[name]()
    B = tbsr.BsrMatrix.from_csr(_port_csr(JA), device=CPU)
    x = _x(JA.ncols, 2)
    xt = torch.as_tensor(x, dtype=torch.float32)
    plain = {"selector": ops.spmv_bsr_selector_plain,
             "onehot": ops.spmv_bsr_onehot_plain}[variant]
    y = plain(B, xt)
    assert y.dtype == torch.float32 and y.shape == (JA.nrows,)
    y_jax = np.asarray(jops.spmv_bsr(jbsr.BsrMatrix.from_csr(JA),
                                     jnp.asarray(x), variant=variant,
                                     interpret=True))
    assert _close(y.numpy().astype(np.float64), y_jax)
    assert _close(y.numpy().astype(np.float64), JA.matvec(x))
    assert torch.equal(ops.spmv_bsr(B, xt, variant=variant), y)
    # The gathers are exact, so every variant is K1's product.
    assert _close(y.numpy().astype(np.float64),
                  ops.spmv_bsr_plain(B, xt).numpy().astype(np.float64))


def _from_coo(r, c, v, nrows, ncols):
    return lambda: CsrMatrix.from_coo(r, c, v, nrows=nrows, ncols=ncols)


def _edge_cases():
    """Small operators at the kernels' edges: the exact block count not a
    multiple of 16 before padding, C = 1, a C too large for any staging of
    the x table in shared memory (C = 547), and an all-zero row group."""
    rng = np.random.default_rng(7)
    r, c = rng.integers(0, 64, 400), rng.integers(0, 70000, 400)
    e = np.concatenate([np.arange(8), np.arange(16, 40)])
    return {
        "C=1 poisson_2d(9)": lambda: _port_csr(j_poisson_2d(9)),
        "T%16!=0 poisson_2d(17)": lambda: _port_csr(j_poisson_2d(17)),
        "C=547 64x70000": _from_coo(r, c, rng.standard_normal(400), 64,
                                    70000),
        "empty row group": _from_coo(e, e, np.arange(1.0, e.size + 1.0), 40,
                                     40),
    }


EDGE = _edge_cases()
CASES = {**EDGE, **{k: (lambda m=m: _port_csr(m())) for k, m in
                    MATRICES.items()}}


def test_edge_cases_have_their_shapes():
    def compact(name):
        return tbsr.BsrCompact.from_csr(EDGE[name](), device=CPU)
    blocks = compact("T%16!=0 poisson_2d(17)").blocks
    assert int(blocks.flatten(1).any(dim=1).sum()) % 16 != 0
    assert compact("C=1 poisson_2d(9)").n_col_blocks == 1
    assert compact("C=547 64x70000").n_col_blocks == 547
    assert not bool((compact("empty row group").gids == 1).any())


@pytest.mark.parametrize("case", sorted(EDGE))
def test_plain_versions_on_edge_cases(case):
    A = EDGE[case]()
    x = _x(A.ncols, 3)
    xt = torch.as_tensor(x, dtype=torch.float32)
    ref = A.matvec(x)
    B = tbsr.BsrMatrix.from_csr(A, device=CPU)
    C = tbsr.BsrCompact.from_csr(A, device=CPU)
    for y in (ops.spmv_bsr_compact(C, xt),
              ops.spmv_bsr(B, xt, variant="selector"),
              ops.spmv_bsr(B, xt, variant="onehot")):
        assert y.shape == (A.nrows,)
        assert _close(y.numpy().astype(np.float64), ref)


def test_onehot_gathers_zero_for_an_out_of_range_column():
    """The in-kernel one-hot matches no column for an id outside [0, C):
    that slot gathers 0, as the TPU kernel's one-hot product does."""
    A = _port_csr(j_poisson_2d(17))
    B = tbsr.BsrMatrix.from_csr(A, device=CPU)
    x = torch.as_tensor(_x(A.ncols, 4), dtype=torch.float32)
    bad = B.block_cols.clone()
    bad[0, 0] = B.n_col_blocks
    y = ops.spmv_bsr_onehot_plain(tbsr.BsrMatrix(
        blocks=B.blocks, block_cols=bad, nrows=A.nrows, ncols=A.ncols,
        nnz=A.nnz), x)
    y0 = ops.spmv_bsr_plain(B, x)
    part = torch.einsum("rc,c->r", B.blocks[0, :8], x[:128])
    assert torch.allclose(y[:8], y0[:8] - part, atol=1e-5)
    assert torch.equal(y[8:], ops.spmv_bsr_onehot_plain(B, x)[8:])


def test_unknown_variant_raises():
    B = tbsr.BsrMatrix.from_csr(_port_csr(j_poisson_2d(9)), device=CPU)
    with pytest.raises(ValueError, match="variant"):
        ops.spmv_bsr(B, torch.ones(81), variant="gather")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["poisson_2d(17)", "random_spd(300,9) RCM"])
def test_matvec_xla_matches_jax(name, dtype):
    JA = MATRICES[name]()
    A = _port_csr(JA)
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    B = tbsr.BsrMatrix.from_csr(A, dtype=dtype, device=CPU)
    x = _x(JA.ncols, 5)
    y = B.matvec_xla(torch.as_tensor(x, dtype=dtype))
    assert y.dtype == dtype and B.sel is not None
    y_jax = np.asarray(jbsr.BsrMatrix.from_csr(JA, dtype=jdt).matvec_xla(
        jnp.asarray(x, dtype=jdt)))
    if dtype == torch.float64:
        # The JAX package's bar (tests/test_bsr.py:88).
        np.testing.assert_allclose(y.numpy(), y_jax, rtol=1e-13, atol=1e-13)
        np.testing.assert_allclose(y.numpy(), JA.matvec(x), rtol=1e-13,
                                   atol=1e-13)
    else:
        assert _close(y.numpy().astype(np.float64), y_jax)


# ------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_variant_kernels_match_plain_on_card(case, cuda_device):
    A = CASES[case]()
    B = tbsr.BsrMatrix.from_csr(A, device=cuda_device, with_sel=True)
    C = tbsr.BsrCompact.from_csr(A, device=cuda_device)
    x = torch.as_tensor(_x(A.ncols, 6), dtype=torch.float32,
                        device=cuda_device)
    ref = A.matvec(x.double().cpu().numpy())
    before = dict(ops.LAUNCHES)
    sell_before = spmv_sell.LAUNCHES["sell_f32"]
    for kern, plain in (
            (ops.spmv_bsr_compact(C, x), ops.spmv_bsr_compact_plain(C, x)),
            (ops.spmv_bsr(B, x, variant="selector"),
             ops.spmv_bsr_selector_plain(B, x)),
            (ops.spmv_bsr(B, x, variant="onehot"),
             ops.spmv_bsr_onehot_plain(B, x))):
        torch.cuda.synchronize()
        assert kern.device == x.device and kern.shape == (A.nrows,)
        scale = max(float(plain.abs().max()), 1e-30)
        assert float((kern - plain).abs().max()) <= 1e-5 * scale
        host = np.abs(kern.double().cpu().numpy() - ref).max()
        assert host <= 2e-5 * max(np.abs(ref).max(), 1e-30)
    for k in ("bsr_compact_f32", "bsr_selector_f32", "bsr_onehot_f32"):
        assert ops.LAUNCHES[k] == before[k] + 1
    # K7 and K8 count under their own names, not under the SELL kernel's.
    assert spmv_sell.LAUNCHES["sell_f32"] == sell_before
    # K6, K7 and K8 run the SELL f32 kernel over a packed form equal to
    # the CSR's SELL layout: spmv_sell's result bit for bit, and repeatable.
    ref_y = spmv_sell.spmv_sell(SellMatrix.from_csr(A, device=cuda_device), x)
    for fn in (lambda: ops.spmv_bsr_compact(C, x),
               lambda: ops.spmv_bsr(B, x, variant="selector"),
               lambda: ops.spmv_bsr(B, x, variant="onehot")):
        y = fn()
        assert torch.equal(y, ref_y)
        assert torch.equal(y, fn())
