"""The port's halo-exchange SpMV (`lsbench_tpu_torch/parallel/dist_spmv.py`)
against the JAX package's (`lsbench_tpu/parallel/dist_spmv.py`).

- The host plans bit for bit: `build_halo_plan`'s vals (f32 and f64) and
  cols, n_pad, nloc, halo and needs_all_gather, `force_global_cols`, and
  each rank's local block (`local_block`, the SELL kernels' operator) held
  to the rows [r·nloc, (r+1)·nloc) of the JAX plan, for poisson_2d(16),
  poisson_2d(13) (n=169, which no D divides) and random_spd(128, 23) at
  D ∈ {1, 2, 4, 8}.
- The products on D ∈ {2, 4} gloo ranks (one spawn of D processes per D
  for all cases, `parallel/launch.py::run_ranks`): the f32 SpMV, the f32
  SpMM (k = 3) and the f64 SpMV on the SELL path ("bsr", the kernels'
  plain versions on the CPU) and on the ELL path, against the host f64 CSR
  product (f64 within 1e-12, f32 within 1e-5, relative to ‖|A|·|x|‖∞) and
  against the JAX `shard_map` product on a D-device mesh of the 8 virtual
  CPU devices (f32 within 1e-5, f64 within 1e-13 of ‖|A|·|x|‖∞), the JAX
  BSR path running its Pallas kernels in interpret mode as
  `tests/test_dist_bsr.py` does; all_gather on random_spd(128, 23); the
  all_gather strategy bit for bit the halo one on a banded matrix.
- `strategy="halo"` raises where the halo exceeds the block, as in JAX.

The rank function imports nothing of JAX (each rank imports this module);
the JAX side runs in the test process.
"""

import numpy as np
import pytest
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.parallel import dist_spmv as tds
from lsbench_tpu_torch.parallel.launch import run_ranks
from lsbench_tpu_torch.parallel.mesh import RowMesh, fetch_global
from lsbench_tpu_torch.parallel.perm import DistOrdering

DS = (2, 4)


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _jax_matrix(name):
    from lsbench_tpu.matrix.generate import poisson_2d, random_spd
    from lsbench_tpu.ordering.rcm import rcm_ordering
    if name == "p13":
        return poisson_2d(13)
    if name == "p16":
        return poisson_2d(16)
    if name == "p24rcm":
        A = poisson_2d(24)
        return A.permuted(rcm_ordering(A))
    return random_spd(128, nnz_per_row=23, seed=0)


# ------------------------------------------------------------------ plans

@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["p16", "p13", "rspd128"])
def test_plans_bit_for_bit(name, D):
    import jax.numpy as jnp
    from lsbench_tpu.parallel import dist_spmv as jds
    JA = _jax_matrix(name)
    A = _port_csr(JA)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float64, torch.float64)):
        jp = jds.build_halo_plan(JA, D, jdt)
        tp = tds.build_halo_plan(A, D, tdt)
        assert (tp.n, tp.n_pad, tp.nloc, tp.halo, tp.n_devices,
                tp.needs_all_gather) == (jp.n, jp.n_pad, jp.nloc, jp.halo,
                                         jp.n_devices, jp.needs_all_gather)
        assert tp.vals.dtype == tdt and tp.cols.dtype == torch.int32
        np.testing.assert_array_equal(tp.vals.numpy(), np.asarray(jp.vals))
        np.testing.assert_array_equal(tp.cols.numpy(), np.asarray(jp.cols))
        jg = jds.force_global_cols(JA, jp)
        tg = tds.force_global_cols(A, tp)
        assert tg.needs_all_gather and jg.needs_all_gather
        np.testing.assert_array_equal(tg.cols.numpy(), np.asarray(jg.cols))
    if jp.needs_all_gather:
        return
    # Each rank's block is the JAX plan's rows [r·nloc, (r+1)·nloc), its
    # columns in extended coordinates.
    vals, cols = np.asarray(jp.vals), np.asarray(jp.cols)
    nloc, H = jp.nloc, jp.halo
    for r in range(D):
        block, b_nloc, b_H = tds.local_block(A, D, r)
        assert (b_nloc, b_H, block.shape) == (nloc, H, (nloc, nloc + 2 * H))
        want = np.zeros((nloc, nloc + 2 * H))
        rows = np.repeat(np.arange(nloc), vals.shape[1])
        np.add.at(want, (rows, cols[r * nloc:(r + 1) * nloc].ravel()),
                  vals[r * nloc:(r + 1) * nloc].ravel())
        np.testing.assert_array_equal(block.to_dense(), want)


def test_halo_strategy_raises_where_the_halo_exceeds_the_block():
    A = _port_csr(_jax_matrix("rspd128"))
    mesh = RowMesh(rank=0, size=8, device=torch.device("cpu"), group=None)
    with pytest.raises(ValueError, match="halo"):
        tds.build_dist_matvec(A, mesh, torch.float64, strategy="halo")
    with pytest.raises(ValueError, match="halo strategy"):
        tds.build_dist_matvec(A, mesh, torch.float64, local_spmv="bsr")
    dm = tds.build_dist_matvec(A, mesh, torch.float64)
    assert (dm.strategy, dm.local_spmv) == ("all_gather", "ell")


# ------------------------------------------------------- products on ranks

# (case id) → (matrix, dtype, op, local_spmv, strategy)
CASES = {}
for _m in ("p13", "p24rcm"):
    for _local in ("bsr", "ell"):
        CASES[f"{_m}-{_local}-f32-spmv"] = (_m, "float32", "spmv", _local,
                                            "auto")
        CASES[f"{_m}-{_local}-f32-spmm"] = (_m, "float32", "spmm", _local,
                                            "auto")
        CASES[f"{_m}-{_local}-f64-spmv"] = (_m, "float64", "spmv", _local,
                                            "auto")
CASES["rspd128-allgather-f64-spmv"] = ("rspd128", "float64", "spmv", "auto",
                                       "all_gather")
CASES["rspd128-allgather-f32-spmm"] = ("rspd128", "float32", "spmm", "auto",
                                       "all_gather")
CASES["p24rcm-allgather-f64-spmv"] = ("p24rcm", "float64", "spmv", "ell",
                                      "all_gather")


def _input(name, op):
    n = _jax_matrix(name).nrows
    rng = np.random.default_rng(7)
    return rng.standard_normal(n if op == "spmv" else (n, 3))


def _rank_products(mesh, cases):
    """On each rank: every case's distributed product, gathered."""
    out = {}
    for cid, (A, dtype, op, local_spmv, strategy, X) in cases.items():
        dt = getattr(torch, dtype)
        dm = tds.build_dist_matvec(A, mesh, dt, strategy=strategy,
                                   local_spmv=local_spmv)
        rows = tds.RowShard(mesh, A.nrows, dm.nloc, DistOrdering(None, None))
        X_l = rows.local(X, dt)
        Y_l = dm.matvec(X_l) if op == "spmv" else dm.matmat(X_l)
        assert Y_l.dtype == dt and Y_l.shape == X_l.shape
        out[cid] = (dm.strategy, dm.local_spmv, dm.halo,
                    fetch_global(mesh, Y_l, A.nrows).numpy())
    return out


@pytest.fixture(scope="module")
def products():
    """D → {case: (strategy, local_spmv, halo, Y)} from rank 0, one spawn
    of D ranks per D."""
    cache = {}

    def get(D):
        if D not in cache:
            cases = {cid: (_port_csr(_jax_matrix(m)), dt, op, local, strat,
                           _input(m, op))
                     for cid, (m, dt, op, local, strat) in CASES.items()}
            per_rank = run_ranks(D, _rank_products, cases, timeout=120)
            for r in per_rank[1:]:  # every rank gathers the same product
                for cid in CASES:
                    np.testing.assert_array_equal(r[cid][3], per_rank[0][cid][3])
            cache[D] = per_rank[0]
        return cache[D]
    return get


def _jax_product(JA, D, dtype, op, local_spmv, strategy, X):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from lsbench_tpu.parallel.dist_spmv import build_dist_matvec
    from lsbench_tpu.parallel.mesh import ROWS, make_row_mesh
    mesh = make_row_mesh(D)
    jdt = jnp.float32 if dtype == "float32" else jnp.float64
    dm = build_dist_matvec(JA, mesh, jdt, strategy=strategy,
                           local_spmv=local_spmv)
    spec = P(ROWS) if op == "spmv" else P(ROWS, None)
    f = dm.matvec if op == "spmv" else dm.matmat
    run = shard_map(lambda *a: f(tuple(a[:-1]), a[-1]), mesh=mesh,
                    in_specs=(*dm.op_specs, spec), out_specs=spec,
                    check_vma=dm.check_vma)
    Xp = np.zeros((dm.n_pad, *X.shape[1:]))
    Xp[: JA.nrows] = X
    y = jax.jit(run)(*dm.op_args, jnp.asarray(Xp, jdt))
    return dm, np.asarray(y, dtype=np.float64)[: JA.nrows]


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("cid", sorted(CASES))
def test_distributed_product(products, cid, D):
    m, dtype, op, local_spmv, strategy = CASES[cid]
    strat, local, halo, Y = products(D)[cid]
    JA = _jax_matrix(m)
    A = _port_csr(JA)
    X = _input(m, op)
    cols = [X] if op == "spmv" else [X[:, j] for j in range(X.shape[1])]
    host = np.stack([A.matvec(c) for c in cols], axis=-1).reshape(Y.shape)
    absA = CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, np.abs(A.vals))
    scale = max(np.abs(absA.matvec(np.abs(c))).max() for c in cols)
    f64 = dtype == "float64"
    assert Y.dtype == (np.float64 if f64 else np.float32)
    assert np.abs(Y - host).max() <= (1e-12 if f64 else 1e-5) * scale
    if strategy == "all_gather" and m == "p24rcm":
        # Forced all_gather on a banded matrix: bit for bit the halo ELL.
        halo_y = products(D)["p24rcm-ell-f64-spmv"][3]
        np.testing.assert_array_equal(Y, halo_y)
    dm, y_jax = _jax_product(JA, D, dtype, op, local_spmv, strategy, X)
    assert (strat, local, halo) == (dm.strategy, dm.local_spmv, dm.halo)
    assert np.abs(Y - y_jax).max() <= (1e-13 if f64 else 1e-5) * scale
