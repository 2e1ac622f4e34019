"""The CG loop's in-place state and its CUDA graphs (`solvers/cg.py`:
`CgState`, `cg_start`, `cg_step`, `CgGraphs`; `ops/launches.py`:
`take_back`, `replayed`).

On the CPU:
- the in-place loop gives bit for bit the x, iteration count, rnorm and
  bnorm of the functional loop it replaced (a frozen copy below), with
  Jacobi, Chebyshev, block-Jacobi and classical-AMG preconditioning, in
  f32 and f64;
- a graph's captured launches are added to each kernel's count once per
  replay, and the graph keys appear only under a profiler session;
- CPU tensors, the NaN switch and a failed capture each leave the loop
  eager, and another loop on the same graphs takes a new state;
- a returned x does not change when the same solver solves again.

On a card (`pytest -m cuda tests/test_torch_cg_graph.py`): the graphed
loop against the eager one (x, iterations, launch counts, peak memory
allocated and reserved), returned x kept apart from the graphs' state, and
IC(0)'s sweeps captured.
"""

import gc

import numpy as np
import pytest
import torch

from lsbench_tpu_torch.matrix.generate import poisson_2d
from lsbench_tpu_torch.ops import launches, spmv_sell, tri_sweep
from lsbench_tpu_torch.solvers import get_solver
from lsbench_tpu_torch.solvers.cg import (ITER, CgGraphs, CgState,
                                          build_matvec, cg_loop)
from lsbench_tpu_torch.solvers.preconditioners import build as build_precond
from lsbench_tpu_torch.utils.debug import enable_debug_nans

PRECONDS = ["jacobi", "chebyshev", "block_jacobi", "amg_classical"]
DTYPES = [torch.float32, torch.float64]
LAYOUT = {torch.float32: "bsr", torch.float64: "bsr_df64"}


def frozen_cg_loop(matvec, precond_apply, b, rtol, maxiter, dtype):
    """`cg_loop` as it was before its state was updated in place."""
    b = b.to(dtype)
    bnorm = torch.sqrt(torch.dot(b, b))
    tol2 = (rtol * bnorm) ** 2

    x = torch.zeros_like(b)
    r = b
    z = precond_apply(r)
    p = z
    rz, rr = torch.dot(r, z), torch.dot(r, r)
    it = 0
    while it < maxiter and bool(rr > tol2):
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond_apply(r)
        rz_new, rr = torch.dot(r, z), torch.dot(r, r)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, it, torch.sqrt(rr), bnorm


@pytest.fixture(scope="module")
def A():
    return poisson_2d(24)


def rhs(n, seed=3, dtype=torch.float64, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(n), dtype=dtype,
                           device=device)


def loop_parts(A, precond, dtype, device="cpu"):
    apply_mv, op = build_matvec(A, LAYOUT[dtype], device, dtype=dtype)
    state, papply = build_precond(precond, A, dtype, device)
    return (lambda v: apply_mv(op, v)), (lambda r: papply(state, r))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("precond", PRECONDS)
def test_in_place_loop_matches_the_functional_loop(A, precond, dtype):
    mv, pc = loop_parts(A, precond, dtype)
    b = rhs(A.nrows, dtype=dtype)
    x, it, rnorm, bnorm = cg_loop(mv, pc, b, 1e-6, 500, dtype)
    want = frozen_cg_loop(mv, pc, b, 1e-6, 500, dtype)
    assert it == want[1] > 0
    for got, ref in zip((x, rnorm, bnorm), (want[0], want[2], want[3])):
        assert got.dtype == dtype and torch.equal(got, ref)


def test_in_place_loop_stops_at_maxiter_and_on_zero_b(A):
    mv, pc = loop_parts(A, "jacobi", torch.float32)
    b = rhs(A.nrows, dtype=torch.float32)
    got, want = (cg_loop(mv, pc, b, 1e-12, 7, torch.float32),
                 frozen_cg_loop(mv, pc, b, 1e-12, 7, torch.float32))
    assert got[1] == want[1] == 7 and torch.equal(got[0], want[0])
    x, it, rnorm, bnorm = cg_loop(mv, pc, torch.zeros_like(b), 1e-6, 50,
                                  torch.float32)
    assert it == 0 and not x.any() and float(rnorm) == float(bnorm) == 0.0


def test_loop_leaves_b_alone(A):
    mv, pc = loop_parts(A, "jacobi", torch.float32)
    b = rhs(A.nrows, dtype=torch.float32)
    b0 = b.clone()
    cg_loop(mv, pc, b, 1e-6, 500, torch.float32, graphs=CgGraphs())
    assert torch.equal(b, b0)


# --------------------------------------------------------- replay counting

def test_take_back_and_replayed_count_each_replay():
    launches.reset()
    before = launches.read()
    spmv_sell.LAUNCHES["sell_f32"] += 1          # what a capture counts
    tri_sweep.LAUNCHES["tri_sweep_f32"] += 3
    delta = launches.take_back(before)
    assert launches.read() == before
    for _ in range(5):
        launches.replayed("graph_replays:lsbench.cg.iter", delta)
    got = launches.read()
    assert got["sell_f32"] == 5 and got["tri_sweep_f32"] == 15
    assert {k: v for k, v in got.items()
            if k not in ("sell_f32", "tri_sweep_f32")} == {
        k: v for k, v in before.items()
        if k not in ("sell_f32", "tri_sweep_f32")}
    launches.reset()


def test_take_back_keeps_earlier_counts():
    launches.reset()
    spmv_sell.LAUNCHES["sell_f64"] = 4
    before = launches.read()
    spmv_sell.LAUNCHES["sell_f64"] += 2
    delta = launches.take_back(before)
    assert spmv_sell.LAUNCHES["sell_f64"] == 4
    launches.replayed("graph_replays:lsbench.cg.start", delta)
    assert spmv_sell.LAUNCHES["sell_f64"] == 6
    launches.reset()


def test_graph_keys_only_under_a_profiler():
    launches.reset()
    keys = set(launches.read())
    launches.replayed("graph_replays:lsbench.cg.iter", ())
    launches.count("graph_captures")
    launches.count("graph_fallbacks")
    assert set(launches.read()) == keys
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            launches.replayed("graph_replays:lsbench.cg.iter", ())
        launches.replayed("graph_replays:lsbench.cg.start", ())
        launches.count("graph_captures")
        launches.count("graph_fallbacks")
    got = launches.read()
    assert got["graph_replays:lsbench.cg.iter"] == 3
    assert got["graph_replays:lsbench.cg.start"] == 1
    assert got["graph_captures"] == got["graph_fallbacks"] == 1
    launches.reset()
    assert set(launches.read()) == keys


# -------------------------------------------------------------- path choice

def test_graphs_engage_only_where_they_hold():
    g = CgGraphs()
    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert g.engages(card)
    assert not g.engages(cpu)
    enable_debug_nans(True)
    try:
        assert not g.engages(card)
    finally:
        enable_debug_nans(False)
    g.failed = "lsbench.cg.iter: RuntimeError: planted"
    assert not g.engages(card)


def test_graphs_take_a_new_state_for_another_loop(monkeypatch):
    """The captures bake in the loop's size, dtype, device, rtol, SpMV and
    preconditioner: a change of any one makes a new state, to capture
    anew."""
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    g = CgGraphs()
    b = torch.zeros(8)
    parts = [b, torch.float32, 1e-5, _same, _same]
    s0 = g.state(*parts)
    g._graphs["lsbench.cg.iter"] = "captured"
    assert g.state(*parts) is s0 and g._graphs
    for i, other in [(0, torch.zeros(9)), (1, torch.float64), (2, 1e-6),
                     (3, lambda v: v), (4, lambda r: r)]:
        changed = list(parts)
        changed[i] = other
        g._graphs["lsbench.cg.iter"] = "captured"
        assert g.state(*changed) is not s0 and not g._graphs
        s0 = g.state(*parts)


def _same(t):
    return t


def test_cpu_loop_with_graphs_stays_eager(A):
    mv, pc = loop_parts(A, "jacobi", torch.float32)
    b = rhs(A.nrows, dtype=torch.float32)
    g = CgGraphs()
    got = cg_loop(mv, pc, b, 1e-6, 500, torch.float32, graphs=g)
    want = cg_loop(mv, pc, b, 1e-6, 500, torch.float32)
    assert got[1] == want[1] and torch.equal(got[0], want[0])
    assert g._state is None and not g._graphs and g.failed is None
    with g.solving(torch.device("cpu")) as keep:
        assert keep(b) is b and not g.on


def test_a_capture_that_raises_runs_the_step_eagerly(monkeypatch):
    """With CUDA's capture planted to fail: the step runs eagerly on the
    state, its launches count once, and the graphs stay eager for good."""
    class Refused:
        def capture_begin(self, pool=None):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Refused)
    g = CgGraphs()
    g._state = CgState(4, torch.float32, torch.device("cpu"))
    g._state.x.zero_()

    def step(s):
        spmv_sell.LAUNCHES["sell_f32"] += 1
        s.x.add_(1.0)

    launches.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        g.run(ITER, step)                    # the eager first run
        with pytest.warns(RuntimeWarning, match="runs eager"):
            g.run(ITER, step)                # the capture, refused
        g.run(ITER, step)
    assert g.failed.startswith(f"{ITER}: RuntimeError")
    assert not g.engages(torch.device("cuda")) and not g._graphs
    got = launches.read()
    assert got["sell_f32"] == 3 and got["graph_fallbacks"] == 1
    assert "graph_captures" not in got
    assert torch.equal(g._state.x, torch.full((4,), 3.0))
    launches.reset()


@pytest.mark.parametrize("name", ["cg", "cg_ir"])
def test_solvers_hold_graphs_and_bicgstab_gmres_do_not_use_them(A, name):
    cls, defaults = get_solver(name)
    solver = cls(A, device="cpu", **defaults)
    assert isinstance(solver._graphs, CgGraphs)
    for other in ("gmres_ir", "bicgstab_ir", "gmres", "bicgstab"):
        ocls, odef = get_solver(other)
        params = {**odef, "dtype": "float32"} if "_" not in other else odef
        assert ocls(A, device="cpu", **params)._graphs is None


@pytest.mark.parametrize("name,params", [
    ("cg", {"dtype": "float32", "rtol": 1e-6}),
    ("cg", {"dtype": "float64", "rtol": 1e-8}),
    ("cg_ir", {"rtol": 1e-10}),
    ("cg_ir", {"rtol": 1e-10, "precond": "amg_classical"}),
], ids=["cg-f32", "cg-f64", "cg_ir", "cg_ir-amg"])
def test_returned_x_survives_the_next_solve(A, name, params):
    cls, defaults = get_solver(name)
    solver = cls(A, device="cpu", **{**defaults, **params})
    x1 = solver.solve(rhs(A.nrows, seed=1)).x
    kept = x1.clone()
    x2 = solver.solve(rhs(A.nrows, seed=2)).x
    assert torch.equal(x1, kept) and not torch.equal(x1, x2)


# --------------------------------------------------------------- on a card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


CARD_SOLVES = [
    ("cg", {"dtype": "float32", "rtol": 1e-6}),
    ("cg", {"dtype": "float64", "rtol": 1e-8}),
    ("cg_ir", {"precond": "jacobi"}),
    ("cg_ir", {"precond": "chebyshev"}),
    ("cg_ir", {"precond": "block_jacobi"}),
    ("cg_ir", {"precond": "amg_classical"}),
]
CARD_IDS = ["cg-f32", "cg-f64", "cg_ir-jacobi", "cg_ir-chebyshev",
            "cg_ir-block_jacobi", "cg_ir-amg_classical"]


@pytest.fixture(scope="module")
def card_A():
    return poisson_2d(192)


def card_solver(A, name, params, device, graphed=True):
    cls, defaults = get_solver(name)
    solver = cls(A, device=str(device),
                 **{**defaults, "rtol": 1e-10, "ordering": "rcm", **params})
    if not graphed:
        solver._graphs = None
    return solver


def solves(solver, A, device, k=3):
    out = []
    for i in range(k):
        res = solver.solve(rhs(A.nrows, seed=10 + i, device=device))
        out.append((res.x, res.iters, res.extra.get("refine_passes")))
    torch.cuda.synchronize(device)
    return out


def kernel_counts():
    return {k: v for k, v in launches.read().items()
            if ":" not in k and "sync" not in k and not k.startswith("graph")}


@pytest.mark.cuda
@pytest.mark.parametrize("name,params", CARD_SOLVES, ids=CARD_IDS)
def test_graphed_loop_matches_eager_on_card(card_A, name, params,
                                            cuda_device):
    launches.reset()
    eager = solves(card_solver(card_A, name, params, cuda_device, False),
                   card_A, cuda_device)
    eager_counts = kernel_counts()
    launches.reset()
    solver = card_solver(card_A, name, params, cuda_device)
    graphed = solves(solver, card_A, cuda_device)
    assert kernel_counts() == eager_counts
    g = solver._graphs
    assert g.failed is None and set(g._graphs) == {"lsbench.cg.start",
                                                   "lsbench.cg.iter"}
    for (xe, ie, pe), (xg, ig, pg) in zip(eager, graphed):
        assert (ie, pe) == (ig, pg)
        assert torch.equal(xe, xg)
    launches.reset()


@pytest.mark.cuda
def test_graph_replays_are_counted_under_a_profiler(card_A, cuda_device):
    solver = card_solver(card_A, "cg_ir", {}, cuda_device)
    solves(solver, card_A, cuda_device, k=2)
    launches.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = solver.solve(rhs(card_A.nrows, seed=5, device=cuda_device))
    got = launches.read()
    passes = res.extra["refine_passes"]
    assert got["graph_replays:lsbench.cg.iter"] == res.iters
    assert got["span_n:lsbench.cg.iter"] == res.iters
    assert got["graph_replays:lsbench.cg.start"] == passes
    assert got["sell_f32"] == res.iters and got["sell_f64"] == passes
    assert "graph_captures" not in got and "graph_fallbacks" not in got
    launches.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cg", "cg_ir"])
def test_returned_x_is_not_the_graph_state_on_card(card_A, name,
                                                   cuda_device):
    params = {"dtype": "float32", "rtol": 1e-6} if name == "cg" else {}
    solver = card_solver(card_A, name, params, cuda_device)
    first = solves(solver, card_A, cuda_device, k=3)
    kept = [x.clone() for x, _, _ in first]
    solves(solver, card_A, cuda_device, k=2)
    for x, x0 in zip((x for x, _, _ in first), kept):
        assert torch.equal(x, x0)
    state = solver._graphs._state
    assert all(x.data_ptr() != state.x.data_ptr() for x, _, _ in first)


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["jacobi", "amg_classical"])
def test_graphed_peak_memory_within_one_percent(card_A, precond,
                                                cuda_device):
    """Allocated and reserved. The graphs' private pool holds the captured
    body's temporaries for good, where `max_memory_allocated` sees them
    only at capture: outside that pool the graphed solves reserve what the
    eager ones do, and the pool is a few of the allocator's segments."""
    peaks = {}
    for graphed in (False, True, False, True):   # the second pair counts
        gc.collect()   # the solver before, held by its lambdas' cycle
        torch.cuda.synchronize(cuda_device)
        torch.cuda.empty_cache()   # its pools and cached blocks
        torch.cuda.reset_peak_memory_stats(cuda_device)
        solver = card_solver(card_A, "cg_ir", {"precond": precond},
                             cuda_device, graphed)
        solves(solver, card_A, cuda_device)
        pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) != (0, 0))
        peaks[graphed] = (torch.cuda.max_memory_allocated(cuda_device),
                          torch.cuda.max_memory_reserved(cuda_device), pool)
        del solver
    (alloc, reserved, pool), (eager_alloc, eager_reserved, eager_pool) = (
        peaks[True], peaks[False])
    assert alloc <= 1.01 * eager_alloc, peaks
    assert reserved - pool <= 1.01 * eager_reserved, peaks
    assert eager_pool == 0 and 0 < pool <= 0.05 * eager_reserved, peaks


@pytest.mark.cuda
def test_ic0_is_captured_or_flagged(card_A, cuda_device):
    eager = solves(card_solver(card_A, "cg_ir", {"precond": "ic0"},
                               cuda_device, False), card_A, cuda_device)
    solver = card_solver(card_A, "cg_ir", {"precond": "ic0"}, cuda_device)
    launches.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = solves(solver, card_A, cuda_device)
    assert "graph_fallbacks" not in launches.read()
    g = solver._graphs
    assert g.failed is None
    assert set(g._graphs) == {"lsbench.cg.start", "lsbench.cg.iter"}
    for (xe, ie, pe), (xg, ig, pg) in zip(eager, got):
        assert (ie, pe) == (ig, pg) and torch.equal(xe, xg)
    launches.reset()
