"""Port parity: the two-pass SpGEMM/RAP (ops/spgemm_device.py) against the
JAX package's.

- The host symbolic plans are bit-identical: a_idx, b_idx, every pad
  class, slot_pos, offs, cols and nnz.
- The numeric pass (torch ops, on the CPU here) is within 1e-12 relative
  of the JAX numeric pass and of the host product (`spgemm`, `rap`).
- The `cuda` twin holds the numeric pass on the card to the CPU one and
  to itself, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsbench_tpu.matrix.csr import CsrMatrix as JCsr
from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.ops import spgemm_device as jsd
from lsbench_tpu.solvers import amg as jamg

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ops import spgemm_device as sd
from lsbench_tpu_torch.ops.spgemm import rap, spgemm

CPU = torch.device("cpu")
PRESET = dict(coarsening="classical", theta=0.5, interp="jacobi",
              interp_passes=3, interp_omega=0.5, pmax=8, coarse_n=16)


def _rand_sparse(rng, m, n, density=0.2):
    """`tests/test_spgemm_device.py`'s random operand (a[0, 0] = 1)."""
    a = rng.random((m, n))
    a[a < 1 - density] = 0
    a[0, 0] = 1.0
    return JCsr.from_dense(a)


def _port(M) -> CsrMatrix:
    return CsrMatrix(M.nrows, M.ncols, M.offs, M.cols, M.vals)


def _products():
    """(label, A, B) of the JAX package's tests: its random rectangular
    products and the factors of its RAP cases."""
    rng = np.random.default_rng(0)
    yield "rand 30x40 @ 40x25", _rand_sparse(rng, 30, 40), \
        _rand_sparse(rng, 40, 25)
    rng = np.random.default_rng(1)
    A = j_poisson_2d(10)
    P = _rand_sparse(rng, A.nrows, 25, density=0.1)
    yield "poisson(10) @ rand P", A, P
    yield "rand R @ poisson(10)", P.transpose(), A


def _raps():
    """(label, R, A, P): the JAX package's random-P RAP cases and the
    classical AMG hierarchy of poisson_2d(24), level by level."""
    rng = np.random.default_rng(1)
    A = j_poisson_2d(10)
    P = _rand_sparse(rng, A.nrows, 25, density=0.1)
    yield "poisson(10) rand P", P.transpose(), A, P
    rng = np.random.default_rng(2)
    A = j_poisson_2d(8)
    P = _rand_sparse(rng, A.nrows, 12, density=0.15)
    yield "poisson(8) rand P", P.transpose(), A, P
    mats, _ = jamg.build_matrix_hierarchy(j_poisson_2d(24),
                                          jamg.AmgOptions(**PRESET))
    for l, m in enumerate(mats):
        yield f"poisson(24) amg level {l}", m["R"], m["A"], m["P"]


PRODUCTS = list(_products())
RAPS = list(_raps())


def _assert_plan_equal(plan, jplan):
    for f in ("a_idx", "b_idx", "slot_pos"):
        got = getattr(plan, f).cpu().numpy()
        want = np.asarray(getattr(jplan, f))
        assert got.dtype == np.int32, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert len(plan.pads) == len(jplan.pads)
    for p, jp in zip(plan.pads, jplan.pads):
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(plan.offs, jplan.offs)
    np.testing.assert_array_equal(plan.cols, jplan.cols)
    assert plan.offs.dtype == jplan.offs.dtype
    assert plan.cols.dtype == jplan.cols.dtype
    assert (plan.nrows, plan.ncols, plan.nnz) == (jplan.nrows, jplan.ncols,
                                                  jplan.nnz)


def _rel(got, want):
    scale = max(float(np.max(np.abs(want))), 1e-300) if want.size else 1.0
    return float(np.max(np.abs(got - want))) / scale if want.size else 0.0


@pytest.mark.parametrize("case", PRODUCTS, ids=[c[0] for c in PRODUCTS])
def test_spgemm_plan_and_values_match_jax(case):
    _, JA, JB = case
    A, B = _port(JA), _port(JB)
    plan = sd.spgemm_symbolic(A, B, device=CPU)
    _assert_plan_equal(plan, jsd.spgemm_symbolic(JA, JB))
    vals = sd.spgemm_numeric(plan, torch.as_tensor(A.vals),
                             torch.as_tensor(B.vals)).numpy()
    jplan = jsd.spgemm_symbolic(JA, JB)
    jvals = np.asarray(jsd.spgemm_numeric(jplan, jnp.asarray(JA.vals),
                                          jnp.asarray(JB.vals)))
    assert _rel(vals, jvals) <= 1e-12
    C = CsrMatrix(plan.nrows, plan.ncols, plan.offs, plan.cols, vals)
    host = spgemm(A, B)
    assert _rel(C.to_dense(), host.to_dense()) <= 1e-12


@pytest.mark.parametrize("case", RAPS, ids=[c[0] for c in RAPS])
def test_rap_plan_and_values_match_jax(case):
    _, JR, JA, JP = case
    R, A, P = _port(JR), _port(JA), _port(JP)
    plan = sd.rap_symbolic(R, A, P, device=CPU)
    jplan = jsd.rap_symbolic(JR, JA, JP)
    _assert_plan_equal(plan.ra, jplan.ra)
    _assert_plan_equal(plan.rap, jplan.rap)
    vals = sd.rap_numeric(plan, *(torch.as_tensor(M.vals)
                                  for M in (R, A, P))).numpy()
    jvals = np.asarray(jsd.rap_numeric(jplan, *(jnp.asarray(M.vals)
                                               for M in (JR, JA, JP))))
    assert _rel(vals, jvals) <= 1e-12
    got = sd.rap_device(R, A, P, device=CPU)
    np.testing.assert_array_equal(got.vals, vals)
    assert _rel(got.to_dense(), rap(R, A, P).to_dense()) <= 1e-12


def test_rap_numeric_revalue_same_pattern():
    """The point of the split: new operator values re-form the coarse
    values without a new symbolic pass."""
    _, JR, JA, JP = RAPS[-2]  # an AMG level with a coarser level below
    R, A, P = _port(JR), _port(JA), _port(JP)
    plan = sd.rap_symbolic(R, A, P, device=CPU)
    rng = np.random.default_rng(3)
    v2 = A.vals * (1.5 + 0.01 * rng.random(A.nnz))
    A2 = CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, v2)
    vals = sd.rap_numeric(plan, torch.as_tensor(R.vals), torch.as_tensor(v2),
                          torch.as_tensor(P.vals)).numpy()
    C2 = CsrMatrix(plan.rap.nrows, plan.rap.ncols, plan.rap.offs,
                   plan.rap.cols, vals)
    assert _rel(C2.to_dense(), rap(R, A2, P).to_dense()) <= 1e-12
    jvals = np.asarray(jsd.rap_numeric(
        jsd.rap_symbolic(JR, JA, JP), jnp.asarray(JR.vals), jnp.asarray(v2),
        jnp.asarray(JP.vals)))
    assert _rel(vals, jvals) <= 1e-12


def test_empty_product():
    """No expansion triple: the JAX package's empty plan, zero values."""
    A = CsrMatrix.from_coo([0], [1], [1.0], nrows=3, ncols=4)
    B = CsrMatrix.from_coo([0], [2], [2.0], nrows=4, ncols=5)  # row 1 empty
    JA, JB = (JCsr(M.nrows, M.ncols, M.offs, M.cols, M.vals) for M in (A, B))
    plan = sd.spgemm_symbolic(A, B, device=CPU)
    _assert_plan_equal(plan, jsd.spgemm_symbolic(JA, JB))
    assert plan.nnz == 0 and plan.pads == ()
    vals = sd.spgemm_numeric(plan, torch.as_tensor(A.vals),
                             torch.as_tensor(B.vals))
    assert vals.shape == (0,) and vals.dtype == torch.float64


def test_symbolic_refuses_more_triples_than_int32_holds(monkeypatch):
    _, JA, JB = PRODUCTS[0]
    A, B = _port(JA), _port(JB)
    total = int(np.sum(B.offs[A.cols + 1] - B.offs[A.cols]))
    monkeypatch.setattr(sd, "MAX_TRIPLES", total - 1)
    with pytest.raises(ValueError, match="int32"):
        sd.spgemm_symbolic(A, B, device=CPU)
    monkeypatch.setattr(sd, "MAX_TRIPLES", total)
    sd.spgemm_symbolic(A, B, device=CPU)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAPS, ids=[c[0] for c in RAPS])
def test_rap_numeric_on_card(case, cuda_device):
    """The numeric RAP on CUDA tensors: within 1e-12 of the CPU pass and
    the host product, and bitwise repeatable (no atomics)."""
    _, JR, JA, JP = case
    R, A, P = _port(JR), _port(JA), _port(JP)
    plan = sd.rap_symbolic(R, A, P, device=cuda_device)
    args = [torch.as_tensor(M.vals, device=cuda_device) for M in (R, A, P)]
    v1 = sd.rap_numeric(plan, *args).cpu().numpy()
    v2 = sd.rap_numeric(plan, *args).cpu().numpy()
    np.testing.assert_array_equal(v1, v2)
    cpu = sd.rap_numeric(sd.rap_symbolic(R, A, P, device=CPU),
                         *(torch.as_tensor(M.vals) for M in (R, A, P)))
    assert _rel(v1, cpu.numpy()) <= 1e-12
    C = CsrMatrix(plan.rap.nrows, plan.rap.ncols, plan.rap.offs,
                  plan.rap.cols, v1)
    assert _rel(C.to_dense(), rap(R, A, P).to_dense()) <= 1e-12
