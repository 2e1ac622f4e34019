"""Port parity: host CSR, RCM and BSR layouts of lsbench_tpu_torch against
lsbench_tpu on the same inputs. Layout arrays must match bit for bit."""

import numpy as np
import pytest
import torch

from lsbench_tpu.matrix import bsr as jbsr
from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.matrix.generate import random_spd as j_random_spd
from lsbench_tpu.matrix.generate import sem_2d as j_sem_2d
from lsbench_tpu.matrix.io import read_matrix as j_read_matrix
from lsbench_tpu.matrix.io import write_matrix as j_write_matrix
from lsbench_tpu.ordering.rcm import rcm_ordering as j_rcm

from lsbench_tpu_torch.matrix import bsr as tbsr
from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.generate import poisson_2d, random_spd, sem_2d
from lsbench_tpu_torch.matrix.io import read_matrix, write_matrix
from lsbench_tpu_torch.ordering import get_ordering
from lsbench_tpu_torch.ordering.rcm import rcm_ordering

CPU = torch.device("cpu")


def _port_csr(A) -> CsrMatrix:
    """The port's CsrMatrix holding a JAX-package CsrMatrix's arrays."""
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _same_csr(A, B):
    assert (A.nrows, A.ncols) == (B.nrows, B.ncols)
    for name in ("offs", "cols", "vals"):
        a, b = getattr(A, name), getattr(B, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_read_matrix_matches_jax(tiny_matrix_file, base_pair_files, tmp_path):
    f = tmp_path / "p9.txt"
    j_write_matrix(j_poisson_2d(9), f, base=1)
    for path in (tiny_matrix_file, *base_pair_files, f):
        _same_csr(read_matrix(path), j_read_matrix(path))


def test_write_matrix_matches_jax(tmp_path):
    A = random_spd(80, nnz_per_row=7, seed=3)
    write_matrix(A, tmp_path / "port.txt", base=1)
    j_write_matrix(j_random_spd(80, nnz_per_row=7, seed=3),
                   tmp_path / "jax.txt", base=1)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


@pytest.mark.parametrize("make,jmake", [
    (lambda: poisson_2d(17), lambda: j_poisson_2d(17)),
    (lambda: sem_2d(8), lambda: j_sem_2d(8)),
    (lambda: random_spd(300, 9), lambda: j_random_spd(300, 9)),
])
def test_generators_and_rcm_match_jax(make, jmake):
    A, JA = make(), jmake()
    _same_csr(A, JA)
    np.testing.assert_array_equal(rcm_ordering(A), j_rcm(JA))
    np.testing.assert_array_equal(get_ordering("none", A), np.arange(A.nrows))


@pytest.mark.parametrize("name", ["amd", "metis", "nd"])
def test_unported_orderings_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_ordering(name, poisson_2d(4))


MATRICES = [lambda: j_poisson_2d(17), lambda: j_random_spd(300, 9),
            lambda: _rcm(j_poisson_2d(17))]


def _rcm(A):
    return A.permuted(j_rcm(A))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits_equal(t, j):
    a, b = _np(t), np.asarray(j)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("make", MATRICES)
def test_bsr_layouts_bit_identical(make):
    JA = make()
    A = _port_csr(JA)
    B, JB = tbsr.BsrMatrix.from_csr(A, device=CPU), jbsr.BsrMatrix.from_csr(JA)
    _bits_equal(B.blocks, JB.blocks)
    _bits_equal(B.block_cols, JB.block_cols)
    assert B.bytes_streamed == JB.bytes_streamed

    D, JD = tbsr.BsrDf64.from_csr(A, device=CPU), jbsr.BsrDf64.from_csr(JA)
    _bits_equal(D.blocks_hi, JD.blocks_hi)
    _bits_equal(D.blocks_lo, JD.blocks_lo)
    _bits_equal(D.block_cols, JD.block_cols)
    _bits_equal(D.blocks_hi, B.blocks)  # the shared-hi invariant

    C, JC = (tbsr.BsrClassed.from_csr(A, device=CPU),
             jbsr.BsrClassed.from_csr(JA))
    assert (C.n_groups, len(C.blocks)) == (JC.n_groups, len(JC.blocks))
    for lst, jlst in ((C.blocks, JC.blocks), (C.bcols, JC.bcols),
                      (C.oidx, JC.oidx)):
        for t, j in zip(lst, jlst):
            _bits_equal(t, j)

    hb, hc = tbsr._bsr_host_layout(A)
    jb, jc = jbsr._bsr_host_layout(JA)
    _bits_equal(hb, jb)
    _bits_equal(hc, jc)


def test_classed_gate_matches_jax():
    for JA in (j_poisson_2d(48), _rcm(j_poisson_2d(48)), j_random_spd(2000)):
        assert (tbsr.classed_layout_wins(_port_csr(JA))
                == jbsr.classed_layout_wins(JA))
    # A large, padded case where classing wins on both sides (n=147k).
    JA = _rcm(j_poisson_2d(384))
    assert tbsr.classed_layout_wins(_port_csr(JA)) is True
    assert jbsr.classed_layout_wins(JA) is True


def test_from_jax_arrays_round_trip():
    JA = _rcm(j_poisson_2d(17))
    A = _port_csr(JA)
    meta = dict(nrows=JA.nrows, ncols=JA.ncols, nnz=JA.nnz)

    JB = jbsr.BsrMatrix.from_csr(JA)
    B = tbsr.from_jax_arrays(blocks=np.asarray(JB.blocks),
                             block_cols=np.asarray(JB.block_cols),
                             device=CPU, **meta)
    assert isinstance(B, tbsr.BsrMatrix)
    ref = tbsr.BsrMatrix.from_csr(A, device=CPU)
    assert torch.equal(B.blocks, ref.blocks)
    assert torch.equal(B.block_cols, ref.block_cols)
    _bits_equal(B.blocks, JB.blocks)

    JD = jbsr.BsrDf64.from_csr(JA)
    D = tbsr.from_jax_arrays(blocks_hi=np.asarray(JD.blocks_hi),
                             blocks_lo=np.asarray(JD.blocks_lo),
                             block_cols=np.asarray(JD.block_cols),
                             device=CPU, **meta)
    assert isinstance(D, tbsr.BsrDf64)
    _bits_equal(D.blocks_hi, JD.blocks_hi)
    _bits_equal(D.blocks_lo, JD.blocks_lo)

    JC = jbsr.BsrClassed.from_csr(JA)
    C = tbsr.from_jax_arrays(blocks=[np.asarray(b) for b in JC.blocks],
                             bcols=[np.asarray(b) for b in JC.bcols],
                             oidx=[np.asarray(o) for o in JC.oidx],
                             n_groups=JC.n_groups, device=CPU, **meta)
    assert isinstance(C, tbsr.BsrClassed)
    refc = tbsr.BsrClassed.from_csr(A, device=CPU)
    for lst, rlst in ((C.blocks, refc.blocks), (C.bcols, refc.bcols),
                      (C.oidx, refc.oidx)):
        assert all(torch.equal(t, r) for t, r in zip(lst, rlst))

    # Carried-over layouts are checked like any outside input.
    with pytest.raises(ValueError):
        tbsr.from_jax_arrays(blocks=np.asarray(JB.blocks),
                             block_cols=np.asarray(JB.block_cols, np.int64),
                             device=CPU, **meta)
    J16 = jbsr.BsrMatrix.from_csr(JA, block_rows=16)
    with pytest.raises(ValueError, match="slots of 8x128"):
        tbsr.from_jax_arrays(blocks=np.asarray(J16.blocks),
                             block_cols=np.asarray(J16.block_cols),
                             device=CPU, **meta)
    bad = np.asarray(JB.block_cols).copy()
    bad[0, 0] = JB.n_col_blocks
    with pytest.raises(ValueError):
        tbsr.from_jax_arrays(blocks=np.asarray(JB.blocks), block_cols=bad,
                             device=CPU, **meta)


def test_layout_to_moves_every_tensor():
    A = poisson_2d(17)
    C = tbsr.BsrClassed.from_csr(A, device=CPU).to("meta")
    assert all(t.device.type == "meta"
               for t in (*C.blocks, *C.bcols, *C.oidx))
    D = tbsr.BsrDf64.from_csr(A, device=CPU).to("meta")
    assert {D.blocks_hi.device.type, D.blocks_lo.device.type,
            D.block_cols.device.type} == {"meta"}
