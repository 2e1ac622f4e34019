"""The port's distributed AMG (`lsbench_tpu_torch/parallel/dist_amg.py`) on
D ∈ {2, 4} gloo ranks, against the JAX package's classes
(`lsbench_tpu/parallel/dist_amg.py`) on a D-device mesh of the 8 virtual
CPU devices and against the port's single-device solvers.

Inputs: poisson_2d(13) (n=169: at D = 4 the last rank is short, and the
coarse levels leave ranks with padding rows only) and RCM poisson_2d(24),
b[i] = i; SA (coarse_n 32 or 16) and the `amg_classical` preset.
Bars:
- the rectangular halo plans of every level's P and R
  (`build_rect_halo_plan`) bit for bit the JAX plans: vals (f32, f64),
  cols, halo and needs_all_gather, at D ∈ {2, 4}; each rank's block
  (`local_rect_block`) is the plan's rows;
- per class (`DistributedAmg` with 2 fixed cycles, SA and classical, and
  in converge mode with the V- and the K-cycle; `DistributedAmgCg`, SA and
  classical; `DistributedAmgCgIr`, classical and SA): the JAX class's
  levels and per-level halo-or-all_gather choice for A, P and R (JAX's
  `_halos`, `_p_halos`, `_r_halos`), the level-0 local SpMV "bsr" (the
  SELL kernels' plain versions here; JAX on the CPU runs ELL);
  iterations within 1 and x within 1e-8 relative of the JAX x in f64;
  for the IR class the same `refine_passes`, inner iterations within 5%,
  true_relres ≤ 1e-10 and x within 1e-8 relative;
- against the port's single-device solvers, the bars of the JAX package's
  `tests/test_dist_amg.py:23-61`: `amg` converge mode iterations within 1,
  x within rtol 1e-6 (atol 1e-8); AMG-CG iterations within 2 of `cg
  --precond amg`, x within rtol 1e-6 of the dense solve; AMG-CG-IR the
  same passes as `cg_ir --precond amg_classical`, iterations within 5%;
- the K-cycle takes no more cycles than the V-cycle on poisson_2d(48) at
  D = 4 (f64, SA, rtol 1e-8), both to true_relres ≤ 1e-8;
- every rank's gathered x is bitwise rank 0's;
- a matrix at the coarse size (poisson_2d(4)) is its own coarsest level:
  one exact cycle, true_relres ≤ 1e-10, for `DistributedAmg`,
  `DistributedAmgCgIr` and `DistributedAmgCg2d` (a gloo group of one).

The ranks start once per D for the whole module (`run_ranks`); the rank
function imports nothing of JAX. On a card (`pytest -m cuda`): the D = 4
per-rank blocks of level 0's A (halo frame) and of every P and R through
the SELL f32, f64 and k = 8 SpMM kernels against their plain versions
(1e-5, 1e-13, 1e-5 of max|y|).
"""

import numpy as np
import pytest
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.parallel import dist_spmv as tds
from lsbench_tpu_torch.parallel.launch import run_ranks
from lsbench_tpu_torch.solvers.base import to_numpy

CPU = torch.device("cpu")
CLASSICAL = dict(coarsening="classical", theta=0.5, interp="jacobi",
                 interp_passes=3, interp_omega=0.5, pmax=8)
# name → (class in lsbench_tpu[_torch].parallel.dist_amg, kwargs of both)
CLASSES = {
    "fixed_sa": ("DistributedAmg", dict(cycles=2, coarse_n=32)),
    "fixed_classical": ("DistributedAmg", dict(cycles=2, **CLASSICAL)),
    "converge_v": ("DistributedAmg", dict(rtol=1e-8, maxiter=60,
                                          coarse_n=32)),
    "converge_k": ("DistributedAmg", dict(rtol=1e-8, maxiter=60, cycle="k",
                                          coarse_n=16)),
    "amg_cg": ("DistributedAmgCg", dict(rtol=1e-10, coarse_n=32)),
    "amg_cg_classical": ("DistributedAmgCg", dict(rtol=1e-10, coarse_n=32,
                                                  coarsening="classical")),
    "amg_cg_ir": ("DistributedAmgCgIr", dict(CLASSICAL)),
    "amg_cg_ir_sa": ("DistributedAmgCgIr", {}),
}
MATRICES = ("p13", "p24rcm")
KCYCLE = dict(rtol=1e-8, coarsening="sa")


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _jax_matrix(name):
    from lsbench_tpu.matrix.generate import poisson_2d
    from lsbench_tpu.ordering.rcm import rcm_ordering
    A = poisson_2d({"p13": 13, "p24rcm": 24, "p48": 48}[name])
    return A.permuted(rcm_ordering(A)) if name.endswith("rcm") else A


def _rank_solves(mesh, jobs):
    """On each rank: solve every job, return (gathered x, iters, extra)."""
    from lsbench_tpu_torch.parallel import dist_amg
    out = {}
    for key, (cls, A, kw) in jobs.items():
        b = np.arange(A.nrows, dtype=np.float64)
        res = getattr(dist_amg, cls)(A, mesh, **kw).solve(b)
        out[key] = (to_numpy(res.x), res.iters, res.extra)
    return out


def _jobs(D):
    jobs = {}
    for m in MATRICES:
        A = _port_csr(_jax_matrix(m))
        for name, (cls, kw) in CLASSES.items():
            jobs[(name, m)] = (cls, A, kw)
    if D == 4:
        A = _port_csr(_jax_matrix("p48"))
        for cyc in ("v", "k"):
            jobs[(f"kcycle_{cyc}", "p48")] = (
                "DistributedAmg", A, dict(KCYCLE, cycle=cyc))
    return jobs


@pytest.fixture(scope="module")
def dist_results():
    """D → {(class, matrix): (x, iters, extra)}, one spawn of D ranks per
    D; every rank's x checked bitwise equal to rank 0's."""
    cache = {}

    def get(D):
        if D not in cache:
            per_rank = run_ranks(D, _rank_solves, _jobs(D), timeout=170)
            for r in per_rank[1:]:
                for key, (x, _, _) in per_rank[0].items():
                    np.testing.assert_array_equal(r[key][0], x)
            cache[D] = per_rank[0]
        return cache[D]
    return get


def _rel(x, y):
    return np.linalg.norm(x - y) / np.linalg.norm(y)


def _jax_hierarchy(JA, coarsening):
    from lsbench_tpu.solvers.amg import AmgOptions, build_matrix_hierarchy
    kw = CLASSICAL if coarsening == "classical" else dict(coarse_n=16)
    opts = AmgOptions(reorder_coarse=True, **kw)
    return build_matrix_hierarchy(JA, opts)


@pytest.mark.parametrize("coarsening", ["sa", "classical"])
@pytest.mark.parametrize("m", MATRICES)
@pytest.mark.parametrize("D", [2, 4])
def test_rect_halo_plans_bit_for_bit(D, m, coarsening):
    import jax.numpy as jnp
    from lsbench_tpu.parallel import dist_spmv as jds
    from lsbench_tpu.parallel.dist_amg import _pad_size
    mats, Ac = _jax_hierarchy(_jax_matrix(m), coarsening)
    assert mats
    sizes = [mm["A"].nrows for mm in mats] + [Ac.nrows]
    nlocs = [_pad_size(s, D) // D for s in sizes]
    seen_all_gather = False
    for lvl, mm in enumerate(mats):
        for op, nr, nc in (("P", nlocs[lvl], nlocs[lvl + 1]),
                           ("R", nlocs[lvl + 1], nlocs[lvl])):
            M = _port_csr(mm[op])
            for jdt, tdt in ((jnp.float32, torch.float32),
                             (jnp.float64, torch.float64)):
                jp = jds.build_rect_halo_plan(mm[op], D, nr, nc, jdt)
                tp = tds.build_rect_halo_plan(M, D, nr, nc, tdt)
                assert (tp.halo, tp.nloc_rows, tp.nloc_cols,
                        tp.needs_all_gather) == (jp.halo, jp.nloc_rows,
                                                 jp.nloc_cols,
                                                 jp.needs_all_gather)
                assert tp.vals.dtype == tdt and tp.cols.dtype == torch.int32
                np.testing.assert_array_equal(tp.vals.numpy(),
                                              np.asarray(jp.vals))
                np.testing.assert_array_equal(tp.cols.numpy(),
                                              np.asarray(jp.cols))
            seen_all_gather |= tp.needs_all_gather
            if tp.needs_all_gather:
                continue
            dense = np.zeros((nr * D, nc + 2 * tp.halo))
            for r in range(D):
                block, H = tds.local_rect_block(M, D, r, nr, nc)
                assert (H, block.shape) == (tp.halo, (nr, nc + 2 * H))
                rows = slice(r * nr, (r + 1) * nr)
                want = np.zeros((nr, nc + 2 * H))
                np.add.at(want, (np.repeat(np.arange(nr), tp.vals.shape[1]),
                                 tp.cols[rows].numpy().ravel()),
                          tp.vals[rows].numpy().ravel())
                np.testing.assert_array_equal(block.to_dense(), want)
                dense[rows] = block.to_dense()
            assert np.abs(dense).sum() == pytest.approx(
                np.abs(mm[op].vals).sum(), rel=1e-14)
    if D == 4 and m == "p24rcm":
        # The coarse levels reach past a neighbour block: the all_gather
        # fallback is exercised.
        assert seen_all_gather


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("m", MATRICES)
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_matches_jax_class(dist_results, name, m, D):
    from lsbench_tpu.parallel import dist_amg as jda
    from lsbench_tpu.parallel.mesh import make_row_mesh
    x, iters, extra = dist_results(D)[(name, m)]
    JA = _jax_matrix(m)
    b = np.arange(JA.nrows, dtype=np.float64)
    cls, kw = CLASSES[name]
    js = getattr(jda, cls)(JA, make_row_mesh(D), **kw)
    j = js.solve(b)
    assert extra["levels"] == j.extra["levels"] == js.n_levels
    assert extra["n_devices"] == D and extra["local_spmv"] == "bsr"
    assert extra["halos"] == {"A": js._halos, "P": js._p_halos,
                              "R": js._r_halos}
    assert abs(iters - int(j.iters)) <= 1
    assert _rel(x, np.asarray(j.x)) < 1e-8
    if name.startswith("amg_cg_ir"):
        assert extra["refine_passes"] == j.extra["refine_passes"]
        assert abs(iters - int(j.iters)) <= 0.05 * int(j.iters)
        assert extra["precision_mode"] == "fp32_ir_auto"
        assert extra["true_relres"] <= 1e-10
    elif "true_relres" in j.extra:
        assert extra["true_relres"] <= kw["rtol"]
    else:  # the fixed-cycle protocol: the residual is data
        assert "true_relres" not in extra and iters == kw["cycles"]


def _single(solver, A, b, **kw):
    from lsbench_tpu_torch.solvers import get_solver
    cls, params = get_solver(solver)
    params.update(kw)
    return cls(A, device=CPU, **params).solve(b)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("m", MATRICES)
def test_matches_single_device(dist_results, m, D):
    res = dist_results(D)
    A = _port_csr(_jax_matrix(m))
    b = np.arange(A.nrows, dtype=np.float64)
    exact = np.linalg.solve(A.to_dense(), b)

    x, iters, _ = res[("converge_v", m)]
    one = _single("amg", A, b, rtol=1e-8, maxiter=60, coarse_n=32)
    assert abs(iters - one.iters) <= 1
    np.testing.assert_allclose(x, to_numpy(one.x), rtol=1e-6, atol=1e-8)

    for name, pkw in (("amg_cg", {}),
                      ("amg_cg_classical", dict(coarsening="classical"))):
        x, iters, extra = res[(name, m)]
        assert extra["true_relres"] <= 1e-10
        np.testing.assert_allclose(x, exact, rtol=1e-6)
        one = _single("cg", A, b, rtol=1e-10, precond="amg",
                      precond_params=dict(coarse_n=32, **pkw))
        assert abs(iters - one.iters) <= 2

    x, iters, extra = res[("amg_cg_ir", m)]
    one = _single("cg_ir", A, b, precond="amg_classical")
    assert extra["refine_passes"] == one.extra["refine_passes"]
    assert abs(iters - one.iters) <= 0.05 * one.iters
    np.testing.assert_allclose(x, exact, rtol=1e-6)


def test_kcycle_takes_no_more_cycles_than_vcycle(dist_results):
    res = dist_results(4)
    it = {}
    for cyc in ("v", "k"):
        x, iters, extra = res[(f"kcycle_{cyc}", "p48")]
        assert extra["true_relres"] <= 1e-8 and extra["levels"] >= 3
        it[cyc] = iters
    assert it["k"] <= it["v"]


def test_a_matrix_at_the_coarse_size_is_its_own_coarsest_level():
    """poisson_2d(4) (n=16 ≤ coarse_n): no level to coarsen, one exact
    coarse solve per cycle, on the row mesh and the 1 × 1 grid (a gloo
    group of one, in this process)."""
    from lsbench_tpu_torch.matrix.generate import poisson_2d
    from lsbench_tpu_torch.parallel.dist_amg import (DistributedAmg,
                                                     DistributedAmgCgIr)
    from lsbench_tpu_torch.parallel.dist_amg2d import DistributedAmgCg2d
    from lsbench_tpu_torch.parallel.mesh import as_grid, make_row_mesh
    A = poisson_2d(4)
    b = np.arange(A.nrows, dtype=np.float64)
    with make_row_mesh(1, platform="cpu") as mesh:
        res = [DistributedAmg(A, mesh, rtol=1e-10).solve(b),
               DistributedAmgCgIr(A, mesh).solve(b),
               DistributedAmgCg2d(A, as_grid(mesh, 1, 1),
                                  rtol=1e-10).solve(b)]
    for r in res:
        assert r.extra["levels"] == 1 and r.extra["true_relres"] <= 1e-10
    assert res[0].iters == 1 and res[0].extra["halos"] == {
        "A": [], "P": [], "R": []}


@pytest.mark.cuda
def test_per_rank_blocks_on_card():
    """Level 0's A and every level's P and R of the D = 4 hierarchy of RCM
    poisson_2d(40) (classical), each rank's block in its halo frame,
    through the SELL kernels against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lsbench_tpu_torch.matrix.generate import poisson_2d
    from lsbench_tpu_torch.matrix.sell import SellMatrix
    from lsbench_tpu_torch.ops import spmv_sell as ss
    from lsbench_tpu_torch.ordering import get_ordering
    from lsbench_tpu_torch.parallel.dist_amg import _pad_size
    from lsbench_tpu_torch.solvers.amg import (AmgOptions,
                                               build_matrix_hierarchy)
    A = poisson_2d(40)
    A = A.permuted(get_ordering("rcm", A))
    mats, Ac = build_matrix_hierarchy(
        A, AmgOptions(reorder_coarse=True, coarse_n=64, **CLASSICAL),
        device="cpu")
    D, dev = 4, torch.device("cuda")
    nl = [_pad_size(s, D) // D
          for s in [mm["A"].nrows for mm in mats] + [Ac.nrows]]
    ops = [(mats[0]["A"], nl[0], nl[0])]
    for lvl, mm in enumerate(mats):
        ops += [(mm["P"], nl[lvl], nl[lvl + 1]),
                (mm["R"], nl[lvl + 1], nl[lvl])]
    rng = np.random.default_rng(5)
    ran = 0
    for M, nr, nc in ops:
        for r in range(D):
            block, H = tds.local_rect_block(M, D, r, nr, nc)
            if H > nc or block.nnz == 0:
                continue
            S = SellMatrix.from_csr(block, (torch.float32, torch.float64),
                                    device=dev)
            x = torch.as_tensor(rng.standard_normal(block.ncols), device=dev)
            X = torch.as_tensor(rng.standard_normal((block.ncols, 8)),
                                dtype=torch.float32, device=dev)
            y32, y64 = ss.spmv_sell(S, x.float()), ss.spmv_sell_f64(S, x)
            Y = ss.spmm_sell(S, X)
            scale = float(y64.abs().max()) or 1.0
            assert float((y32 - ss.spmv_sell_plain(S, x.float())).abs()
                         .max()) <= 1e-5 * scale
            assert float((y64 - ss.spmv_sell_f64_plain(S, x)).abs()
                         .max()) <= 1e-13 * scale
            assert float((Y - ss.spmm_sell_plain(S, X)).abs().max()) \
                <= 1e-5 * (float(Y.abs().max()) or 1.0)
            ran += 1
    assert ran >= D
