"""The port's communication model (`lsbench_tpu_torch/parallel/comm_model.py`)
against the JAX package's (`lsbench_tpu/parallel/comm_model.py`) and
against the collectives the port's ranks really call.

Inputs: RCM poisson_2d(16) and poisson_2d(16) unordered (n=256) for the CG
volumes, RCM poisson_2d(32) (n=1024) for the AMG ones and the trace,
random_spd(1000, 10) for the model's arithmetic. Bars:
- model parity: `cg_comm_volume` at D ∈ {1, 2, 4}, strategy ∈ {auto,
  halo, all_gather}, f32 and f64, `cg2d_comm_volume` at (1, 2), (2, 1),
  (2, 2), and `amg_comm_volume` of the port's `DistributedAmgCg`,
  `DistributedAmg(cycle="k")` and `DistributedAmgCgIr` on 4 gloo ranks,
  equal to the JAX functions' field by field (the JAX solvers on a
  4-device mesh of the 8 simulated devices). No field differs: the port's
  level-0 exchange carries the solver's dtype, which is the item size the
  JAX rule gives (8 bytes for f64, with or without its double-float
  kernel; 4 for the f32 cycle);
- arithmetic parity: `predict_efficiency` and `efficiency_crossover_n`
  equal the JAX functions to 1e-12 given the JAX link parameters (45
  GB/s, 1 µs); with the port's defaults the efficiency is monotone in t_1,
  falls with the hop latency, the gather hops cost, and the crossover
  lies in (1e4, 1e7) or is -1 when unreachable; the defaults are not the
  JAX (v5e) ones;
- trace counts: on 4 gloo ranks each solver runs at `rtol=0` with m and
  m + 2 iterations (cycles for the K-cycle, inner iterations for
  AMG-CG-IR with one refinement pass) while `dist.all_reduce`,
  `dist.batch_isend_irecv` (its isends), `dist.all_gather`,
  `dist2d._all_gather` and `dist2d._reduce_scatter` are counted; half the
  difference is the per-iteration count. On the middle ranks (1, 2) it
  equals the model's, on the end ranks (0, 3) the sends are half: CG halo
  and all_gather, 2-D CG on the 2 × 2 grid, AMG-CG (V-cycle), the
  K-cycle, AMG-CG-IR.

The ranks start once for the module (`run_ranks`); their functions import
nothing of JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.parallel import comm_model as tcm
from lsbench_tpu_torch.parallel.launch import run_ranks

M = 3  # iterations of the shorter run; the longer takes M + 2
CLASSICAL = dict(coarsening="classical", theta=0.5, interp="jacobi",
                 interp_passes=3, interp_omega=0.5, pmax=8)
# name → (class in lsbench_tpu[_torch].parallel.dist_amg, kwargs of both)
AMG = {
    "amg_cg": ("DistributedAmgCg", dict(dtype=torch.float32, rtol=1e-5)),
    "amg_k": ("DistributedAmg", dict(dtype=torch.float32, cycles=1,
                                     cycle="k")),
    "amg_cg_ir": ("DistributedAmgCgIr", dict(CLASSICAL)),
}


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _jax_matrix(nx, rcm=True):
    from lsbench_tpu.matrix.generate import poisson_2d
    from lsbench_tpu.ordering.rcm import rcm_ordering
    A = poisson_2d(nx)
    return A.permuted(rcm_ordering(A)) if rcm else A


def _jdtype(dtype):
    import jax.numpy as jnp
    return {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]


# -- model parity -----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("strategy", ["auto", "halo", "all_gather"])
@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("rcm", [True, False])
def test_cg_comm_volume_matches_jax(D, strategy, dtype, rcm):
    from lsbench_tpu.parallel import comm_model as jcm
    JA = _jax_matrix(16, rcm)
    want = jcm.cg_comm_volume(JA, D, _jdtype(dtype), strategy=strategy)
    got = tcm.cg_comm_volume(_port_csr(JA), D, dtype, strategy=strategy)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.bytes_per_iter == want.bytes_per_iter


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid", [(1, 2), (2, 1), (2, 2)])
def test_cg2d_comm_volume_matches_jax(grid, dtype):
    from lsbench_tpu.parallel import comm_model as jcm
    JA = _jax_matrix(16)
    want = jcm.cg2d_comm_volume(JA, *grid, _jdtype(dtype))
    got = tcm.cg2d_comm_volume(_port_csr(JA), *grid, dtype)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -- the ranks: AMG volumes and the collective trace ------------------------

class _Counts:
    """Counts the collective calls of this rank (the port's meaning of
    each model count, `comm_model.py`), by wrapping the functions the
    solvers call through their modules."""

    def __init__(self):
        import torch.distributed as dist

        from lsbench_tpu_torch.parallel import dist2d
        self.n = dict.fromkeys(("psum", "ppermute", "all_gather", "ag2d",
                                "rs2d"), 0)
        isend = dist.isend

        def wrap(mod, attr, key, count=lambda *a, **k: 1):
            orig = getattr(mod, attr)

            def f(*a, **k):
                self.n[key] += count(*a, **k)
                return orig(*a, **k)
            setattr(mod, attr, f)

        wrap(dist, "all_reduce", "psum")
        wrap(dist, "batch_isend_irecv", "ppermute",
             lambda ops: sum(op.op is isend for op in ops))
        wrap(dist, "all_gather", "all_gather")
        wrap(dist2d, "_all_gather", "ag2d")
        wrap(dist2d, "_reduce_scatter", "rs2d")

    def per_iteration(self, run) -> dict:
        """Half the difference of the calls of run(M + 2) and run(M)."""
        before = dict(self.n)
        run(M)
        mid = dict(self.n)
        run(M + 2)
        return {k: ((self.n[k] - mid[k]) - (mid[k] - before[k])) / 2
                for k in self.n}


def _rank_comm(mesh, Acg, Aamg):
    """On each rank: the AMG classes' comm volumes, and the per-iteration
    collective calls of each traced solver beside its model."""
    from lsbench_tpu_torch.parallel import dist_amg
    from lsbench_tpu_torch.parallel.dist2d import DistributedCg2d
    from lsbench_tpu_torch.parallel.dist_cg import DistributedCg
    from lsbench_tpu_torch.parallel.mesh import as_grid

    volumes = {name: tcm.amg_comm_volume(getattr(dist_amg, cls)(
                   Aamg, mesh, **kw))
               for name, (cls, kw) in AMG.items()}
    counts = _Counts()
    b_cg = np.arange(Acg.nrows, dtype=np.float64)
    b_amg = np.arange(Aamg.nrows, dtype=np.float64)
    out = {}
    for strategy in ("halo", "all_gather"):
        def run(m, strategy=strategy):
            DistributedCg(Acg, mesh, rtol=0.0, maxiter=m,
                          strategy=strategy).solve(b_cg)
        cv = tcm.cg_comm_volume(Acg, mesh.size, torch.float64,
                                strategy=strategy)
        out[f"cg {strategy}"] = (counts.per_iteration(run), cv)
    grid = as_grid(mesh, 2, 2)
    out["cg 2d"] = (counts.per_iteration(
        lambda m: DistributedCg2d(Acg, grid, rtol=0.0,
                                  maxiter=m).solve(b_cg)),
        tcm.cg2d_comm_volume(Acg, 2, 2, torch.float64))
    runs = {
        "amg_cg": lambda m: dist_amg.DistributedAmgCg(
            Aamg, mesh, dtype=torch.float32, rtol=0.0, maxiter=m),
        "amg_k": lambda m: dist_amg.DistributedAmg(
            Aamg, mesh, dtype=torch.float32, cycles=m, cycle="k"),
        "amg_cg_ir": lambda m: dist_amg.DistributedAmgCgIr(
            Aamg, mesh, inner_rtol=0.0, maxiter=m, max_refine=1,
            **CLASSICAL),
    }
    for name, make in runs.items():
        out[name] = (counts.per_iteration(lambda m: make(m).solve(b_amg)),
                     tcm.amg_comm_volume(make(M)))
    return {"volumes": volumes, "trace": out}


@pytest.fixture(scope="module")
def ranks():
    """Rank r's results of one run of 4 gloo ranks."""
    Acg = _port_csr(_jax_matrix(16))
    Aamg = _port_csr(_jax_matrix(32))
    return run_ranks(4, _rank_comm, Acg, Aamg, timeout=110)


@pytest.mark.parametrize("name", sorted(AMG))
def test_amg_comm_volume_matches_jax(ranks, name):
    from lsbench_tpu.parallel import dist_amg as jda
    from lsbench_tpu.parallel.comm_model import amg_comm_volume
    from lsbench_tpu.parallel.mesh import make_row_mesh
    cls, kw = AMG[name]
    jkw = {k: (_jdtype(v) if k == "dtype" else v) for k, v in kw.items()}
    want = amg_comm_volume(getattr(jda, cls)(_jax_matrix(32),
                                             make_row_mesh(4), **jkw))
    for r, out in enumerate(ranks):
        got = out["volumes"][name]
        assert dataclasses.asdict(got) == dataclasses.asdict(want), r
    # Not vacuous: the fine level rides the halo ring, and the K-cycle
    # has its FCG all-reduces and more than two levels.
    assert want.levels[0].a_strategy == "halo"
    if name == "amg_k":
        assert want.psums_per_cycle > 0 and len(want.levels) >= 2


TRACE = {  # name → the model fields of one iteration (psum, ppermute, ag)
    "cg halo": ("psums_per_iter", "ppermutes_per_spmv", None),
    "cg all_gather": ("psums_per_iter", "ppermutes_per_spmv", None),
    "cg 2d": ("psums_per_iter", "ppermutes_per_spmv", None),
    "amg_cg": ("psums_per_iter", "ppermutes_per_iter",
               "all_gathers_per_iter"),
    "amg_k": ("psums_per_cycle", "ppermutes_per_cycle",
              "all_gathers_per_cycle"),
    "amg_cg_ir": ("psums_per_iter", "ppermutes_per_iter",
                  "all_gathers_per_iter"),
}


@pytest.mark.parametrize("name", list(TRACE))
def test_collective_counts_match_the_model(ranks, name):
    psum, pp, ag = TRACE[name]
    for r, out in enumerate(ranks):
        got, cv = out["trace"][name]
        middle = r in (1, 2)
        assert got["psum"] == getattr(cv, psum), (r, got)
        assert got["ppermute"] == getattr(cv, pp) / (1 if middle else 2), (
            r, got)
        if name == "cg 2d":
            assert (got["ag2d"], got["rs2d"], got["all_gather"]) == (
                1, 1, 0), (r, got)
            assert cv.gather_hops_per_spmv == 2
            continue
        assert got["ag2d"] == got["rs2d"] == 0
        want_ag = (getattr(cv, ag) if ag else
                   (1 if cv.strategy == "all_gather" else 0))
        assert got["all_gather"] == want_ag, (r, got)
    cv = ranks[1]["trace"][name][1]
    if name == "cg halo":
        assert cv.strategy == "halo" and cv.bytes_per_spmv == 2 * cv.halo * 8
    if name == "cg all_gather":
        assert cv.strategy == "all_gather" and cv.ppermutes_per_spmv == 0
    if name.startswith("amg"):
        # Every level's A, R and P on the halo ring at D = 4, or the count
        # of all_gathers above would be the coarse gather alone.
        assert cv.levels[0].a_strategy == "halo"
        assert cv.ppermutes_per_cycle > 0


# -- the model's arithmetic -------------------------------------------------

def _spd_volumes():
    from lsbench_tpu.matrix.generate import random_spd
    from lsbench_tpu.parallel import comm_model as jcm
    JA = random_spd(1000, 10)
    return (jcm, jcm.cg_comm_volume(JA, 8, _jdtype(torch.float32)),
            tcm.cg_comm_volume(_port_csr(JA), 8, torch.float32))


@pytest.mark.parametrize("t1", [22.8e-6, 831e-6, 5e-3])
def test_predict_efficiency_matches_jax(t1):
    jcm, jcv, tcv = _spd_volumes()
    assert dataclasses.asdict(jcv) == dataclasses.asdict(tcv)
    assert tcv.strategy == "all_gather"  # random: no band
    for link, hop in ((45.0, 1e-6), (450.0, 3e-6), (25.0, 1e-5)):
        je, jt = jcm.predict_efficiency(t1, jcv, link, hop)
        te, tt = tcm.predict_efficiency(t1, tcv, link, hop)
        assert te == pytest.approx(je, rel=1e-12, abs=1e-15)
        assert tt == pytest.approx(jt, rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("args", [(5.0, 1.58, 8), (5.0, 1.58, 4, 0.9),
                                  (23.0, 10.0, 8, 0.8, 16)])
def test_crossover_matches_jax(args):
    import jax.numpy as jnp
    from lsbench_tpu.parallel import comm_model as jcm
    for dt in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        want = jcm.efficiency_crossover_n(*args, dtype=dt[0], link_gbps=45.0,
                                          hop_latency_s=1e-6)
        got = tcm.efficiency_crossover_n(*args, dtype=dt[1], link_gbps=45.0,
                                         hop_latency_s=1e-6)
        assert got == want


def test_model_structure_with_the_card_defaults():
    _, _, cv8 = _spd_volumes()
    small, _ = tcm.predict_efficiency(22.8e-6, cv8)
    big, _ = tcm.predict_efficiency(831e-6, cv8)
    assert small < big
    # The gather-hop term bites: an all_gather volume is slower than the
    # same volume with its hops zeroed.
    no_hops, _ = tcm.predict_efficiency(
        831e-6, dataclasses.replace(cv8, gather_hops_per_spmv=0))
    assert big < no_hops
    # Monotone in t1 and decreasing in latency.
    assert tcm.predict_efficiency(100e-6, cv8)[0] < big
    assert tcm.predict_efficiency(831e-6, cv8, hop_latency_s=1e-5)[0] < big
    assert tcm.predict_efficiency(831e-6, cv8, link_gbps=45.0)[0] < big
    one = dataclasses.replace(cv8, n_devices=1)
    assert tcm.predict_efficiency(831e-6, one) == (1.0, 831e-6)
    n80 = tcm.efficiency_crossover_n(5.0, 1.58, 8)
    assert 10_000 < n80 < 10_000_000
    assert tcm.efficiency_crossover_n(5.0, 1.58, 8, hop_latency_s=10.0) == -1


def test_defaults_are_the_cards_not_the_v5e():
    import inspect
    for fn in (tcm.predict_efficiency, tcm.efficiency_crossover_n):
        p = inspect.signature(fn).parameters
        assert p["link_gbps"].default == tcm.NVLINK4_GBPS == 450.0
        assert p["hop_latency_s"].default == tcm.NVLINK_HOP_LATENCY_S
        assert (p["link_gbps"].default, p["hop_latency_s"].default) != (
            45.0, 1e-6)
    doc = tcm.predict_efficiency.__doc__
    assert "published" in doc and "assumption" in doc
