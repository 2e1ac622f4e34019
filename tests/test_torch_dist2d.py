"""The port's 2-D partition (`lsbench_tpu_torch/parallel/dist2d.py`, the
2-D classes of `dist_cg_ir.py`, `dist_amg2d.py`) on gloo ranks laid on a
pr × pc grid (`mesh.as_grid`): (1, 2) and (2, 1) on D = 2 ranks, (2, 2) on
D = 4; against the JAX package's classes on a `make_mesh_2d` of the 8
virtual CPU devices and against the port's 1-D classes on the same ranks.

Inputs made from a seed with numpy: poisson_2d(13) (n=169, which leaves
padded chunks at every grid), RCM poisson_2d(24), random_spd(97, 15);
b[i] = i (block CG: three more seeded columns). Bars:
- `build_2d_plan` bit for bit the JAX plan (vals in f32 and f64, cols,
  n_pad, csize, rloc, csize_in, n_gath), square and rectangular (the AMG
  transfer operators with a fine and a coarse chunk size), at grids
  (1, 2), (2, 1), (2, 2) and (2, 4); each rank's gathered-frame block
  (`local_block_2d`, the SELL kernels' operator) equals the plan's rows;
- `spmv_2d` at (1, 2), (2, 1) and (2, 2), gather-ELL and SELL, within
  1e-12 of max|A·x| of the host f64 CSR product, the f32 SELL product
  within 1e-5; the k = 3 column product within 1e-5 (f32) and 1e-12
  (f64) per column;
- `DistributedCg2d`, `DistributedBicgstab2d`, `DistributedBlockCg2d`
  (nrhs 4), `DistributedCgIr2d`, `DistributedBicgstabIr2d`,
  `DistributedGmresIr2d` and `DistributedAmgCg2d` at every grid: x within
  1e-9 relative of the port's 1-D class on the same ranks and of the JAX
  class, true_relres ≤ the class's rtol; against the JAX class the same
  `refine_passes` and iterations within 5% (f64 CG and AMG-CG within 2),
  and for the classes whose stop point moves with the last bits of the
  sums (`ROUNDING_SENSITIVE`, as in `tests/test_torch_dist_solvers.py`)
  at most one more pass and 10% more iterations per pass (GMRES: one
  more restart cycle per pass); the grid's shape in the record;
- the ordering round trip: `ordering="rcm"` inside `DistributedCg2d` and
  `DistributedCgIr2d` at (2, 2) gives x in the caller's order, within
  1e-9 relative of the single-device solve with RCM;
- every rank's gathered x is bitwise rank 0's.

The ranks start once per D for the whole module (`run_ranks`); the rank
function imports nothing of JAX. On a card (`pytest -m cuda`): every
rank's gathered-frame block of a 2 × 2 grid of RCM poisson_2d(40) through
the SELL f32, f64 and k = 8 SpMM kernels against their plain versions
(1e-5, 1e-13, 1e-5 of max|y|), and the partials summed and scattered on
the host against the host product (f64 within 1e-12).
"""

import numpy as np
import pytest
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.parallel import dist2d as td2
from lsbench_tpu_torch.parallel.launch import run_ranks
from lsbench_tpu_torch.solvers.base import to_numpy

CPU = torch.device("cpu")
GRIDS = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
# name → (2-D class path, 1-D class path, kwargs of all three)
SOLVERS = {
    "cg": ("dist2d.DistributedCg2d", "dist_cg.DistributedCg",
           dict(rtol=1e-10)),
    "bicgstab": ("dist2d.DistributedBicgstab2d",
                 "dist_bicgstab.DistributedBicgstab", dict(rtol=1e-10)),
    "block_cg": ("dist2d.DistributedBlockCg2d",
                 "dist_block_cg.DistributedBlockCg", dict(nrhs=4)),
    "cg_ir": ("dist_cg_ir.DistributedCgIr2d", "dist_cg_ir.DistributedCgIr",
              {}),
    "bicgstab_ir": ("dist_cg_ir.DistributedBicgstabIr2d",
                    "dist_cg_ir.DistributedBicgstabIr", {}),
    "gmres_ir": ("dist_cg_ir.DistributedGmresIr2d",
                 "dist_cg_ir.DistributedGmresIr", {}),
    "amg_cg": ("dist_amg2d.DistributedAmgCg2d", "dist_amg.DistributedAmgCg",
               dict(rtol=1e-10, coarse_n=32)),
}
MATRICES = ("p13", "p24rcm")
ROUNDING_SENSITIVE = ("bicgstab", "bicgstab_ir", "gmres_ir")
ROUND_TRIP = ("cg", "cg_ir")


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _jax_matrix(name):
    from lsbench_tpu.matrix.generate import poisson_2d, random_spd
    from lsbench_tpu.ordering.rcm import rcm_ordering
    if name == "rspd97":
        return random_spd(97, nnz_per_row=15, seed=7)
    A = poisson_2d({"p13": 13, "p24rcm": 24}[name])
    return A.permuted(rcm_ordering(A)) if name.endswith("rcm") else A


def _rhs(name, n):
    b = np.arange(n, dtype=np.float64)
    if name == "block_cg":
        rng = np.random.default_rng(0)
        return np.column_stack([b] + [rng.standard_normal(n)
                                      for _ in range(3)])
    return b


def _class(path, package="lsbench_tpu_torch"):
    import importlib
    mod, cls = path.split(".")
    return getattr(importlib.import_module(f"{package}.parallel.{mod}"), cls)


def _rank_work(mesh, jobs, products):
    """On each rank: the 2-D products and solves on each grid, the 1-D
    solves on the row mesh; (gathered x, iters, extra) per job."""
    from lsbench_tpu_torch.parallel.mesh import as_grid, fetch_global
    grids = {g: as_grid(mesh, *g) for g in GRIDS[mesh.size]}
    out = {}
    for key, (A, x, X) in products.items():
        g = grids[key[0]]
        ys = {f"{sp}_f64": td2.spmv_2d(A, g, x, torch.float64, sp)
              for sp in ("ell", "bsr")}
        ys["bsr_f32"] = td2.spmv_2d(A, g, x, torch.float32, "bsr")
        for dt in (torch.float32, torch.float64):
            op = td2.build_2d_matvec(A, g, dt)
            lo = mesh.rank * op.nloc
            Xp = np.zeros((op.n_pad, X.shape[1]))
            Xp[: A.nrows] = X
            X_l = torch.as_tensor(Xp[lo: lo + op.nloc], dtype=dt)
            ys[f"mm_{dt}"] = fetch_global(g, op.matmat(X_l),
                                          A.nrows).double().numpy()
        out[("spmv",) + key] = ys
    for key, (path, A, kw, b) in jobs.items():
        m = grids[key[2]] if key[2] is not None else mesh
        res = _class(path)(A, m, **kw).solve(b)
        out[key] = (to_numpy(res.x), res.iters, res.extra)
    return out


def _work(D):
    rng = np.random.default_rng(3)
    products, jobs = {}, {}
    for grid in GRIDS[D]:
        for mname in ("p13", "rspd97"):
            A = _port_csr(_jax_matrix(mname))
            products[(grid, mname)] = (A, rng.standard_normal(A.nrows),
                                       rng.standard_normal((A.nrows, 3)))
    for m in MATRICES:
        A = _port_csr(_jax_matrix(m))
        for name, (path2, path1, kw) in SOLVERS.items():
            b = _rhs(name, A.nrows)
            jobs[(name, m, None)] = (path1, A, kw, b)
            for grid in GRIDS[D]:
                jobs[(name, m, grid)] = (path2, A, kw, b)
    if D == 4:
        A = _port_csr(_jax_matrix("p13"))
        for name in ROUND_TRIP:
            path2, _, kw = SOLVERS[name]
            jobs[(name, "p13-rcm", (2, 2))] = (
                path2, A, dict(kw, ordering="rcm"), _rhs(name, A.nrows))
    return jobs, products


@pytest.fixture(scope="module")
def dist_results():
    """D → {key: result}, one spawn of D ranks per D; every rank's solve x
    and products checked bitwise equal to rank 0's."""
    cache = {}

    def get(D):
        if D not in cache:
            per_rank = run_ranks(D, _rank_work, *_work(D), timeout=170)
            for r in per_rank[1:]:
                for key, v in per_rank[0].items():
                    if key[0] == "spmv":
                        for k, y in v.items():
                            np.testing.assert_array_equal(r[key][k], y)
                    else:
                        np.testing.assert_array_equal(r[key][0], v[0])
            cache[D] = per_rank[0]
        return cache[D]
    return get


def _rel(x, y):
    return np.linalg.norm(x - y) / np.linalg.norm(y)


# ------------------------------------------------------------------ plans

@pytest.mark.parametrize("grid", [(1, 2), (2, 1), (2, 2), (2, 4)])
@pytest.mark.parametrize("name", ["p13", "p24rcm", "rspd97"])
def test_plans_bit_for_bit(name, grid):
    import jax.numpy as jnp
    from lsbench_tpu.parallel import dist2d as jd2
    pr, pc = grid
    JA = _jax_matrix(name)
    A = _port_csr(JA)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float64, torch.float64)):
        jp = jd2.build_2d_plan(JA, pr, pc, jdt)
        tp = td2.build_2d_plan(A, pr, pc, tdt)
        assert (tp.n, tp.n_pad, tp.csize, tp.rloc, tp.pr, tp.pc,
                tp.csize_in, tp.n_gath) == (jp.n, jp.n_pad, jp.csize,
                                            jp.rloc, jp.pr, jp.pc,
                                            jp.csize_in, jp.n_gath)
        assert tp.vals.dtype == tdt and tp.cols.dtype == torch.int32
        np.testing.assert_array_equal(tp.vals.numpy(), np.asarray(jp.vals))
        np.testing.assert_array_equal(tp.cols.numpy(), np.asarray(jp.cols))
    # Each rank's SELL operator: the plan's rows in the gathered frame.
    for i in range(pr):
        for j in range(pc):
            block = td2.local_block_2d(A, pr, pc, i, j)
            assert block.shape == (tp.rloc, tp.n_gath)
            want = np.zeros(block.shape)
            k = tp.vals.shape[-1]
            np.add.at(want, (np.repeat(np.arange(tp.rloc), k),
                             tp.cols[i, j].numpy().ravel()),
                      tp.vals[i, j].numpy().ravel())
            np.testing.assert_array_equal(block.to_dense(), want)


@pytest.mark.parametrize("grid", [(1, 2), (2, 1), (2, 2), (2, 4)])
def test_rectangular_plans_bit_for_bit(grid):
    """The transfer operators of the SA hierarchy of RCM poisson_2d(24),
    chunked by their fine and coarse levels' chunk sizes (the layout of
    `DistributedAmgCg2d`)."""
    import jax.numpy as jnp
    from lsbench_tpu.parallel import dist2d as jd2
    from lsbench_tpu.solvers.amg import AmgOptions, build_matrix_hierarchy
    pr, pc = grid
    P_ = pr * pc
    mats, Ac = build_matrix_hierarchy(
        _jax_matrix("p24rcm"), AmgOptions(reorder_coarse=True, coarse_n=16))
    sizes = [m["A"].nrows for m in mats] + [Ac.nrows]
    cs = [-(-max(1, -(-s // P_)) // 8) * 8 for s in sizes]
    for lvl, m in enumerate(mats):
        for op, a, b in (("A", cs[lvl], cs[lvl]), ("P", cs[lvl], cs[lvl + 1]),
                         ("R", cs[lvl + 1], cs[lvl])):
            jp = jd2.build_2d_plan(m[op], pr, pc, jnp.float64, csize_r=a,
                                   csize_c=b)
            tp = td2.build_2d_plan(_port_csr(m[op]), pr, pc, torch.float64,
                                   csize_r=a, csize_c=b)
            assert (tp.n_pad, tp.csize, tp.rloc, tp.csize_in,
                    tp.n_gath) == (jp.n_pad, jp.csize, jp.rloc, jp.csize_in,
                                   jp.n_gath)
            np.testing.assert_array_equal(tp.vals.numpy(),
                                          np.asarray(jp.vals))
            np.testing.assert_array_equal(tp.cols.numpy(),
                                          np.asarray(jp.cols))


# --------------------------------------------------------------- products

@pytest.mark.parametrize("grid", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("name", ["p13", "rspd97"])
def test_spmv_2d_matches_host(dist_results, name, grid):
    D = grid[0] * grid[1]
    ys = dist_results(D)[("spmv", grid, name)]
    A, x, X = _work(D)[1][(grid, name)]  # the inputs the ranks were given
    host = A.matvec(x)
    scale = np.abs(host).max()
    for k in ("ell_f64", "bsr_f64"):
        assert np.abs(ys[k] - host).max() <= 1e-12 * scale, k
    assert np.abs(ys["bsr_f32"] - host).max() <= 1e-5 * scale
    host_X = np.stack([A.matvec(X[:, c]) for c in range(3)], axis=1)
    for c in range(3):
        s = np.abs(host_X[:, c]).max()
        assert np.abs(ys["mm_torch.float32"][:, c]
                      - host_X[:, c]).max() <= 1e-5 * s
        assert np.abs(ys["mm_torch.float64"][:, c]
                      - host_X[:, c]).max() <= 1e-12 * s


# ---------------------------------------------------------------- solvers

def _jax_solve(name, JA, grid, b):
    from lsbench_tpu.parallel.mesh import make_mesh_2d
    path, _, kw = SOLVERS[name]
    return _class(path, "lsbench_tpu")(JA, make_mesh_2d(*grid), **kw).solve(b)


@pytest.mark.parametrize("grid", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("m", MATRICES)
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_matches_1d_and_jax(dist_results, name, m, grid):
    D = grid[0] * grid[1]
    res = dist_results(D)
    x, iters, extra = res[(name, m, grid)]
    x1, iters1, extra1 = res[(name, m, None)]
    JA = _jax_matrix(m)
    b = _rhs(name, JA.nrows)
    rtol = SOLVERS[name][2].get("rtol", 1e-10)
    assert extra["true_relres"] <= rtol
    assert tuple(extra["mesh"]) == grid
    assert extra["local_spmv"] == ("ell" if name == "amg_cg" else "bsr")
    assert _rel(x, x1) < 1e-9

    j = _jax_solve(name, JA, grid, b)
    assert tuple(j.extra["mesh"]) == grid
    assert _rel(x, np.asarray(j.x)) < 1e-9
    assert extra.get("precision_mode") == j.extra.get("precision_mode")
    j_iters, j_passes = int(j.iters), j.extra.get("refine_passes")
    passes = extra.get("refine_passes")
    if name == "amg_cg":
        assert extra["levels"] == j.extra["levels"] == extra1["levels"]
    if name in ROUNDING_SENSITIVE:
        assert passes is None or passes <= j_passes + 1
        cycles = 30 * (passes or 1) if name.startswith("gmres") else 0
        # 10% more iterations per pass: where the second pass ends on
        # either side of 1e-10 (f32 `bicgstab_ir` on poisson_2d(13) at
        # (1, 2): the port's second pass ends at 1.03e-10 after 40
        # iterations, the JAX class's at 6.9e-11 after 39), the port's
        # extra pass costs a pass's iterations.
        per_pass = (passes / j_passes) if passes else 1.0
        assert iters <= 1.1 * j_iters * per_pass + cycles
    else:
        assert passes == j_passes
        if name in ("cg", "amg_cg"):
            assert abs(iters - j_iters) <= 2
        else:
            assert abs(iters - j_iters) <= 0.05 * j_iters


@pytest.mark.parametrize("name", ROUND_TRIP)
def test_ordering_round_trip(dist_results, name):
    from lsbench_tpu_torch.solvers import get_solver
    x, _, extra = dist_results(4)[(name, "p13-rcm", (2, 2))]
    A = _port_csr(_jax_matrix("p13"))
    b = _rhs(name, A.nrows)
    assert extra["true_relres"] <= 1e-10
    solver, skw = {"cg": ("cg", dict(dtype=torch.float64, rtol=1e-10)),
                   "cg_ir": ("cg_ir", {})}[name]
    cls, params = get_solver(solver)
    params.update(skw, ordering="rcm")
    single = cls(A, device=CPU, **params).solve(b)
    assert _rel(x, to_numpy(single.x)) < 1e-9


def test_grid_mesh_groups():
    """A 2-D solver refuses a row mesh, and `as_grid` refuses a grid whose
    size is not the mesh's."""
    from lsbench_tpu_torch.matrix.generate import poisson_2d
    from lsbench_tpu_torch.parallel.mesh import as_grid, make_row_mesh
    with make_row_mesh(1, platform="cpu") as mesh:
        with pytest.raises(ValueError, match="grid mesh"):
            td2.DistributedCg2d(poisson_2d(4), mesh)
        with pytest.raises(ValueError, match="1x2 grid needs 2 ranks"):
            as_grid(mesh, 1, 2)
        g = as_grid(mesh, 1, 1)
        assert (g.pr, g.pc, g.i, g.j, g.rank) == (1, 1, 0, 0, 0)


@pytest.mark.cuda
def test_per_rank_blocks_on_card():
    """Each rank's gathered-frame block of a 2 × 2 grid of RCM
    poisson_2d(40) through the SELL kernels, on an x assembled by hand,
    against their plain versions; the four partials summed and scattered
    on the host against the host product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lsbench_tpu_torch.matrix.generate import poisson_2d
    from lsbench_tpu_torch.matrix.sell import SellMatrix
    from lsbench_tpu_torch.ops import spmv_sell as ss
    from lsbench_tpu_torch.ordering import get_ordering
    A = poisson_2d(40)
    A = A.permuted(get_ordering("rcm", A))
    pr = pc = 2
    plan = td2.build_2d_plan(A, pr, pc, torch.float64)
    cs, dev = plan.csize, torch.device("cuda")
    rng = np.random.default_rng(7)
    x = np.zeros(plan.n_pad)
    x[: A.nrows] = rng.standard_normal(A.nrows)
    X = rng.standard_normal((plan.n_pad, 8))
    y = np.zeros(plan.n_pad)
    for i in range(pr):
        for j in range(pc):
            S = SellMatrix.from_csr(td2.local_block_2d(A, pr, pc, i, j),
                                    (torch.float32, torch.float64),
                                    device=dev)
            # Grid column j's chunks j, pc + j, … in ascending grid row.
            idx = np.concatenate([np.arange((a * pc + j) * cs,
                                            (a * pc + j + 1) * cs)
                                  for a in range(pr)])
            xg = torch.as_tensor(x[idx], device=dev)
            Xg = torch.as_tensor(X[idx], dtype=torch.float32, device=dev)
            y32, y64 = ss.spmv_sell(S, xg.float()), ss.spmv_sell_f64(S, xg)
            Y = ss.spmm_sell(S, Xg)
            scale = float(y64.abs().max())
            assert float((y32 - ss.spmv_sell_plain(S, xg.float())).abs()
                         .max()) <= 1e-5 * scale
            assert float((y64 - ss.spmv_sell_f64_plain(S, xg)).abs()
                         .max()) <= 1e-13 * scale
            assert float((Y - ss.spmm_sell_plain(S, Xg)).abs().max()) \
                <= 1e-5 * float(Y.abs().max())
            y[i * plan.rloc: (i + 1) * plan.rloc] += y64.cpu().numpy()
    host = A.matvec(x[: A.nrows])
    assert np.abs(y[: A.nrows] - host).max() <= 1e-12 * np.abs(host).max()
