"""The port's distributed Krylov solvers (`lsbench_tpu_torch/parallel/`) on
D ∈ {2, 4} gloo ranks, against the port's single-device solvers and the
JAX package's distributed classes on a D-device mesh of the 8 virtual CPU
devices.

Each class runs on poisson_2d(13) (n=169: padded rows on the last rank)
and RCM poisson_2d(24); every rank's gathered x must be bitwise the same.
Bars:
- against the port's single-device solver of the same method: x within
  1e-9 relative (the bar of `tests/test_dist_cg_ir.py:57-60`);
- against the JAX class: the same `refine_passes`, inner iterations within
  5% (f64 CG within 2, the bar of `tests/test_distributed.py:36`), the
  same strategy, halo and precision mode (the port's local SpMV is the
  SELL path, "bsr", where JAX on the CPU takes "ell");
- the ordering round trip (D = 2): `ordering="rcm"` inside the class gives
  x in the caller's order, within 1e-9 of the single-device solve with
  RCM;
- the port's two loop changes, decided on reduced values: a planted
  breakdown (rho = 0 at the second iteration, on ranks one of which holds
  only padding rows) that the shadow restart passes, where the JAX f64
  loop returns a non-finite x; and the GMRES stagnation stop on
  poisson_2d(13) with an inner tolerance below the f32 floor, where the
  JAX inner loop runs to its cap in every pass;
- `cg_ir --ordering rcm` on poisson_2d(40) at D = 4 and D = 1 (a gloo group
  of one, in this process) within 1e-9 of the single-device `cg_ir`.

The ranks start once per D for the whole module (`run_ranks`); the rank
function imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.parallel.launch import run_ranks
from lsbench_tpu_torch.solvers.base import to_numpy

CPU = torch.device("cpu")

# name → (class under lsbench_tpu[_torch].parallel, kwargs of both)
SOLVERS = {
    "cg": ("dist_cg.DistributedCg", dict(rtol=1e-10)),
    "cg_block_jacobi": ("dist_cg.DistributedCg",
                        dict(rtol=1e-10, precond="block_jacobi")),
    "cg_ir": ("dist_cg_ir.DistributedCgIr", {}),
    "bicgstab_ir": ("dist_cg_ir.DistributedBicgstabIr", {}),
    "gmres_ir": ("dist_cg_ir.DistributedGmresIr", {}),
    "bicgstab": ("dist_bicgstab.DistributedBicgstab", dict(rtol=1e-10)),
    "gmres": ("dist_gmres.DistributedGmres", dict(rtol=1e-10)),
    "block_cg": ("dist_block_cg.DistributedBlockCg", dict(nrhs=4)),
}
# name → (port single-device solver, its kwargs)
SINGLE = {
    "cg": ("cg", dict(dtype=torch.float64, rtol=1e-10)),
    "cg_block_jacobi": ("cg", dict(dtype=torch.float64, rtol=1e-10,
                                   precond="block_jacobi")),
    "cg_ir": ("cg_ir", {}),
    "bicgstab_ir": ("bicgstab_ir", {}),
    "gmres_ir": ("gmres_ir", {}),
    "bicgstab": ("bicgstab_ir", {}),
    "gmres": ("gmres_ir", {}),
    "block_cg": ("block_cg", dict(method="simultaneous")),
}
MATRICES = ("p13", "p24rcm")
# Whose stop point moves with the last-bit differences between the two
# packages' sums (the port's SELL product sums each row in entry order;
# XLA's ELL reduce, its dots and its psum order differ): BiCGSTAB's
# irregular residual, and the cycle in which the f32 GMRES inner loop
# crosses its tolerance. On these matrices the port's own ELL path lands
# as far from its SELL path (e.g. f32 `bicgstab_ir` on RCM poisson_2d(24)
# at D = 4: 110 iterations and 3 passes on ELL, 78 and 2 on SELL; the JAX
# class 112 and 3).
ROUNDING_SENSITIVE = ("bicgstab", "bicgstab_ir", "gmres_ir")
ROUND_TRIP = ("cg_ir", "cg", "bicgstab", "gmres")
# An inner tolerance below the f32 floor of the recomputed residual, and a
# cap of 20 restart cycles per pass.
STAGNATION = dict(inner_rtol=1e-9, maxiter=600)

# A planted breakdown (tests/test_torch_krylov.py): with r̂0 = b = e1 and
# A[0,1] = A[2,0] = 0, the first Jacobi-preconditioned step leaves r1[0] = 0
# exactly, so rho = (r̂0, r1) = 0 at the second iteration in any precision.
_RHO0_A = np.array([[2.0, 0.0, 1.0], [1.0, 3.0, 0.0], [0.0, 1.0, 4.0]])
_RHO0_B = np.array([1.0, 0.0, 0.0])


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _jax_matrix(name):
    from lsbench_tpu.matrix.csr import CsrMatrix as JCsr
    from lsbench_tpu.matrix.generate import poisson_2d
    from lsbench_tpu.ordering.rcm import rcm_ordering
    if name == "p13":
        return poisson_2d(13)
    if name == "planted":
        return JCsr.from_dense(_RHO0_A)
    A = poisson_2d({"p24rcm": 24, "p40": 40}[name])
    return A.permuted(rcm_ordering(A)) if name.endswith("rcm") else A


def _rhs(name, n):
    b = np.arange(n, dtype=np.float64)
    if name == "block_cg":
        rng = np.random.default_rng(0)
        return np.column_stack([b] + [rng.standard_normal(n)
                                      for _ in range(3)])
    return b


def _port_class(path):
    import importlib
    mod, cls = path.split(".")
    return getattr(importlib.import_module(
        f"lsbench_tpu_torch.parallel.{mod}"), cls)


def _rank_solves(mesh, jobs):
    """On each rank: solve every job, return (gathered x, iters, extra)."""
    out = {}
    for key, (path, A, kw, b) in jobs.items():
        res = _port_class(path)(A, mesh, **kw).solve(b)
        out[key] = (to_numpy(res.x), res.iters, res.extra)
    return out


def _jobs(D):
    jobs = {}
    for m in MATRICES:
        A = _port_csr(_jax_matrix(m))
        for name, (path, kw) in SOLVERS.items():
            jobs[(name, m)] = (path, A, kw, _rhs(name, A.nrows))
    if D == 2:
        A = _port_csr(_jax_matrix("p13"))
        for name in ROUND_TRIP:
            path, kw = SOLVERS[name]
            jobs[(name, "p13-rcm")] = (path, A, dict(kw, ordering="rcm"),
                                       _rhs(name, A.nrows))
        P = _port_csr(_jax_matrix("planted"))
        jobs[("bicgstab", "planted")] = (
            "dist_bicgstab.DistributedBicgstab", P, dict(rtol=1e-6), _RHO0_B)
        jobs[("bicgstab_ir", "planted")] = (
            "dist_cg_ir.DistributedBicgstabIr", P, dict(rtol=1e-10), _RHO0_B)
        jobs[("gmres_ir", "stagnation")] = (
            "dist_cg_ir.DistributedGmresIr", A, STAGNATION,
            _rhs("gmres_ir", A.nrows))
    if D == 4:
        A = _port_csr(_jax_matrix("p40"))
        jobs[("cg_ir", "p40-rcm")] = ("dist_cg_ir.DistributedCgIr", A,
                                      dict(ordering="rcm"),
                                      _rhs("cg_ir", A.nrows))
    return jobs


@pytest.fixture(scope="module")
def dist_results():
    """D → {(solver, matrix): (x, iters, extra)}, one spawn of D ranks per
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


def _single(name, A, b, **kw):
    from lsbench_tpu_torch.solvers import get_solver
    solver, skw = SINGLE[name]
    cls, params = get_solver(solver)
    params.update(skw, **kw)
    return cls(A, device=CPU, **params).solve(b)


def _jax_solve(name, JA, D, b):
    import importlib
    from lsbench_tpu.parallel.mesh import make_row_mesh
    path, kw = SOLVERS[name]
    mod, cls = path.split(".")
    jcls = getattr(importlib.import_module(f"lsbench_tpu.parallel.{mod}"),
                   cls)
    return jcls(JA, make_row_mesh(D), **kw).solve(b)


def _rel(x, y):
    return np.linalg.norm(x - y) / np.linalg.norm(y)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("m", MATRICES)
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_matches_single_device_and_jax(dist_results, name, m, D):
    x, iters, extra = dist_results(D)[(name, m)]
    JA = _jax_matrix(m)
    A = _port_csr(JA)
    b = _rhs(name, A.nrows)
    assert extra["true_relres"] <= 1e-10
    assert (extra["strategy"], extra["local_spmv"]) == ("halo", "bsr")
    single = _single(name, A, b)
    assert _rel(x, to_numpy(single.x)) < 1e-9

    j = _jax_solve(name, JA, D, b)
    assert extra["strategy"] == j.extra["strategy"]
    if "halo" in j.extra:
        assert extra["halo"] == j.extra["halo"]
    assert extra.get("precision_mode") == j.extra.get("precision_mode")
    assert _rel(x, np.asarray(j.x)) < 1e-9
    j_iters, j_passes = int(j.iters), j.extra.get("refine_passes")
    passes = extra.get("refine_passes")
    if name in ROUNDING_SENSITIVE:
        # Not worse than the JAX class: at most one more pass, 10% more
        # iterations, and one more restart cycle per pass for GMRES.
        assert passes is None or passes <= j_passes + 1
        cycles = 30 * (passes or 1) if name.startswith("gmres") else 0
        assert iters <= 1.1 * j_iters + cycles
    else:
        assert passes == j_passes
        if name in ("cg", "cg_block_jacobi"):
            assert abs(iters - j_iters) <= 2
        else:
            assert abs(iters - j_iters) <= 0.05 * j_iters


@pytest.mark.parametrize("name", ROUND_TRIP)
def test_ordering_round_trip(dist_results, name):
    x, _, extra = dist_results(2)[(name, "p13-rcm")]
    A = _port_csr(_jax_matrix("p13"))
    b = _rhs(name, A.nrows)
    assert extra["true_relres"] <= 1e-10
    single = _single(name, A, b, ordering="rcm")
    assert _rel(x, to_numpy(single.x)) < 1e-9


@pytest.mark.parametrize("name", ["bicgstab", "bicgstab_ir"])
def test_shadow_restart_passes_a_planted_breakdown(dist_results, name):
    """The port restarts the shadow residual where rho = 0 (rank 1 holds
    only padding rows) and solves the 3×3 system. The JAX f64 loop, the
    same recurrence without the restart, divides by rho = 0 and returns a
    non-finite x; the JAX f32 inner loop's guards freeze the step instead,
    and its refinement takes at least the port's passes and iterations."""
    x, iters, extra = dist_results(2)[(name, "planted")]
    exact = np.linalg.solve(_RHO0_A, _RHO0_B)
    np.testing.assert_allclose(x, exact, rtol=1e-5, atol=1e-6)
    j = _jax_solve(name, _jax_matrix("planted"), 2, _RHO0_B)
    if name == "bicgstab":
        assert extra["true_relres"] <= 1e-6 and 2 < iters <= 6
        assert int(j.iters) == 3 and not np.isfinite(np.asarray(j.x)).any()
    else:
        assert extra["true_relres"] <= 1e-10
        assert extra["refine_passes"] <= j.extra["refine_passes"]
        assert iters <= int(j.iters)


def test_gmres_stagnation_stop_on_reduced_norms(dist_results):
    """In f32 the recomputed residual has a floor above an inner tolerance
    of 1e-9: on poisson_2d(13) the JAX inner loop runs to its cap (20
    cycles of 30) in every pass, the port stops after the first cycle that
    does not lower the reduced ‖r‖; both refine to 1e-10 in as many
    passes."""
    from lsbench_tpu.parallel.dist_cg_ir import DistributedGmresIr
    from lsbench_tpu.parallel.mesh import make_row_mesh
    x, iters, extra = dist_results(2)[("gmres_ir", "stagnation")]
    JA = _jax_matrix("p13")
    j = DistributedGmresIr(JA, make_row_mesh(2), **STAGNATION).solve(
        _rhs("gmres_ir", JA.nrows))
    passes = j.extra["refine_passes"]
    assert int(j.iters) == 600 * passes  # every pass ran to its cap
    assert extra["refine_passes"] == passes and iters < 600 * passes // 2
    assert extra["true_relres"] <= 1e-10 and j.extra["true_relres"] <= 1e-10


def test_cg_ir_rcm_at_4_and_1_ranks_matches_single_device(dist_results):
    from lsbench_tpu_torch.parallel.dist_cg_ir import DistributedCgIr
    from lsbench_tpu_torch.parallel.mesh import make_row_mesh
    x4, _, extra = dist_results(4)[("cg_ir", "p40-rcm")]
    A = _port_csr(_jax_matrix("p40"))
    b = _rhs("cg_ir", A.nrows)
    assert (extra["strategy"], extra["local_spmv"],
            extra["precision_mode"]) == ("halo", "bsr", "fp32_ir_auto")
    assert extra["true_relres"] <= 1e-10
    with make_row_mesh(1, platform="cpu") as mesh:
        x1 = to_numpy(DistributedCgIr(A, mesh, ordering="rcm").solve(b).x)
    single = to_numpy(_single("cg_ir", A, b, ordering="rcm").x)
    assert _rel(x4, single) < 1e-9 and _rel(x1, single) < 1e-9
