"""The CG loop's in-place state and its CUDA graphs (`solvers/cg.py`:
`CgState`, `cg_start`, `cg_step`, `CgGraphs`; `ops/launches.py`:
`take_back`, `replayed`).

On the CPU:
- the in-place loop gives bit for bit the x, iteration count, rnorm and
  bnorm of the functional loop it replaced (a frozen copy below), with
  Jacobi, Chebyshev, block-Jacobi and classical-AMG preconditioning, in
  f32 and f64;
- a graph's captured launches are added to each kernel's count once per
  replay, and the block's slot count appears only under a profiler
  session;
- CPU tensors and the NaN switch leave the loop eager, and another loop
  on the same graphs takes a new state;
- the host's rule after a block of guarded iterations stops where the
  eager rule stops, and the block's slots follow the first pass; with a
  stand-in for CUDA's graphs, the block loop counts each slot's body once
  per iteration that ran and its guard once a slot, and raises where the
  if-nodes are missing or CUDA refuses a capture;
- a returned x does not change when the same solver solves again.

On a card (`pytest -m cuda tests/test_torch_cg_graph.py`): the graphed
loop against the eager one (x, iterations, launch counts, peak memory
allocated and reserved), also where a pass ends on a block's last slot,
where maxiter ends one mid-block and where b = 0; returned x kept apart
from the graphs' state, and IC(0)'s sweeps captured.
"""

import gc
import warnings
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from lsbench_tpu_torch.matrix.generate import poisson_2d
from lsbench_tpu_torch.ops import graph_if, launches, spmv_sell, tri_sweep
from lsbench_tpu_torch.solvers import get_solver
from lsbench_tpu_torch.solvers import cg as cg_module
from lsbench_tpu_torch.solvers.cg import (BLOCK, ITER, SLOTS, CgGraphs,
                                          CgState, block_goes_on,
                                          block_slots, build_matvec, cg_loop)
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
        launches.replayed(delta)
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
    launches.replayed(delta)
    assert spmv_sell.LAUNCHES["sell_f64"] == 6
    launches.reset()


def test_graph_keys_only_under_a_profiler():
    """A replay adds no key of its own; the block's slots are counted only
    while a session records."""
    launches.reset()
    keys = set(launches.read())
    slots = f"graph_slots:{BLOCK}"
    launches.replayed((), 3, SLOTS)
    launches.count(slots, SLOTS)
    assert set(launches.read()) == keys
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            launches.replayed((), 2, SLOTS)
            launches.count(slots, SLOTS)
        launches.replayed(())
    got = launches.read()
    assert set(got) == keys | {slots} and got[slots] == 3 * SLOTS
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


def test_graphs_take_a_new_state_for_another_loop(monkeypatch):
    """The captures bake in the loop's size, dtype, device, rtol, maxiter,
    SpMV and preconditioner: a change of any one makes a new state, whose
    first pass runs eagerly, to capture anew."""
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    g = CgGraphs()
    b = torch.zeros(8)
    parts = [b, torch.float32, 1e-5, 100, _same, _same]
    s0 = g.state(*parts)
    g._start_graph = g._block_graph = "captured"
    g._warm = True
    assert g.state(*parts) is s0 and g._start_graph and g._warm
    for i, other in [(0, torch.zeros(9)), (1, torch.float64), (2, 1e-6),
                     (3, 99), (4, lambda v: v), (5, lambda r: r)]:
        changed = list(parts)
        changed[i] = other
        g._start_graph = g._block_graph = "captured"
        g._warm = True
        assert g.state(*changed) is not s0
        assert g._start_graph is g._block_graph is None and not g._warm
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
    assert g._state is None and g._start_graph is g._block_graph is None
    with g.solving(torch.device("cpu")) as keep:
        assert keep(b) is b and not g.on


# ------------------------------------------------- blocks of guarded slots

@pytest.mark.parametrize("slots", [1, 3, 8, SLOTS])
def test_block_rule_stops_where_the_eager_rule_stops(slots):
    """A pass that needs `need` iterations, capped at maxiter: the slots'
    guards run at most that many, and the host's rule after each block
    ends the pass at the eager loop's count, one block after the last
    full one (none more where maxiter ends a block)."""
    for maxiter in (0, 1, 5, slots, slots + 1, 2 * slots, 1000):
        for need in range(0, 3 * slots + 3):
            eager = min(need, maxiter)
            it = enqueued = blocks = 0
            while True:
                for _ in range(slots):      # each slot's guard, on the card
                    if it < maxiter and it < need:
                        it += 1
                enqueued += slots
                blocks += 1
                if not block_goes_on(it, enqueued, maxiter):
                    break
            assert it == eager, (slots, maxiter, need)
            full = eager == maxiter and eager % slots == 0 and eager > 0
            assert blocks == eager // slots + (0 if full else 1)


def test_block_slots_follow_the_first_pass():
    """One slot more than the first pass's iterations, at most SLOTS, and
    SLOTS after a pass of none."""
    assert [block_slots(k) for k in (0, 1, 3, SLOTS - 1, SLOTS, 400)] == [
        SLOTS, 2, 4, SLOTS, SLOTS, SLOTS]


def test_guard_is_the_eager_stop_test():
    """`graph_if.go`, the plain version of the guard kernel."""
    it, limit = torch.zeros((), dtype=torch.int64), torch.zeros(
        (), dtype=torch.int64)
    rr, tol2 = torch.zeros(()), torch.zeros(())
    for i, r, t, m in [(0, 2.0, 1.0, 5), (5, 2.0, 1.0, 5), (0, 1.0, 1.0, 5),
                       (4, 0.5, 1.0, 9), (0, 0.0, 0.0, 5),
                       (0, float("nan"), 1.0, 5)]:
        it.fill_(i)
        limit.fill_(m)
        rr.fill_(r)
        tol2.fill_(t)
        go = graph_if.go(it, limit, rr, tol2)
        assert go.dtype == torch.bool and go.dim() == 0
        assert bool(go) == (i < m and r > t)


class FakeGraph:
    """CUDA's graph on the CPU: a capture runs nothing (the state is set
    back at its end), and a replay does what the card would, each
    if-node's guard on the state and, where it holds, it += 1 and one
    halving of rr (a stand-in iteration)."""
    state = None
    limit = None
    maxiter = 0
    capturing = None              # the graph being captured

    def __init__(self):
        self.ifs = 0

    def capture_begin(self, pool=None):
        FakeGraph.capturing = self
        s = FakeGraph.state
        self._saved = {k: getattr(s, k).clone() for k in CgState.__slots__}

    def capture_end(self):
        FakeGraph.capturing = None
        for k, v in self._saved.items():
            getattr(FakeGraph.state, k).copy_(v)

    def replay(self):
        s = FakeGraph.state
        for _ in range(self.ifs):
            if bool(graph_if.go(s.it, FakeGraph.limit, s.rr, s.tol2)):
                s.it.add_(1)
                s.rr.mul_(0.5)


@contextmanager
def fake_if_node(it, limit, value, bound, body, pool):
    """`graph_if.if_node` on the CPU: counts the if-node on the graph
    being captured, guarded by the loop's count and residual, and its
    guard's launch."""
    s = FakeGraph.state
    assert (it, value, bound) == (s.it, s.rr, s.tol2)
    assert limit.dtype == torch.int64 and int(limit) == FakeGraph.maxiter
    FakeGraph.capturing.ifs += 1
    graph_if.LAUNCHES["if_guard_f32"] += 1
    yield


@contextmanager
def refused_if_node(it, limit, value, bound, body, pool):
    raise RuntimeError("operation not supported when stream is capturing")
    yield


def no_graph_if(device):
    raise RuntimeError("nvcc not found: cannot build the CUDA kernels")


def fake_step(s):
    """A stand-in iteration: one counted launch (a wrapper counts at
    capture too) and, outside a capture, rr halved."""
    spmv_sell.LAUNCHES["sell_f32"] += 1
    if FakeGraph.capturing is None:
        s.rr.mul_(0.5)


def no_start(s):
    """The start's work is done by `fake_pass` itself."""


def host_read_start(s):
    """A start that reads the device on the host, which a capture
    refuses."""
    if FakeGraph.capturing is not None:
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")


def fake_graphs(monkeypatch, maxiter, if_node=fake_if_node,
                load=lambda device: None):
    """A loop's graphs and state of maxiter on stand-ins for CUDA's
    graphs."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(torch.cuda, "MemPool", object)
    monkeypatch.setattr(graph_if, "if_node", if_node)
    monkeypatch.setattr(graph_if, "load", load)
    g = CgGraphs()
    s = g.state(torch.zeros(4), torch.float32, 1e-5, maxiter, _same, _same)
    FakeGraph.state, FakeGraph.limit = s, g._limit
    FakeGraph.maxiter = maxiter
    return g


def fake_pass(g, need, maxiter, start=no_start):
    """One pass of the graphed loop that needs `need` iterations (rr starts
    at 1 and each iteration halves it; tol2 = 0.5**need): its start, then
    its iterations; returns their count."""
    s = g._state
    s.rr.fill_(1.0)
    s.it.zero_()
    s.tol2.fill_(0.5 ** need)
    g.start(start)
    return g.iterate(maxiter, fake_step)


def fake_passes(monkeypatch, needs, maxiter):
    """Passes that need `needs` iterations each; returns (the graphs, each
    pass's count)."""
    g = fake_graphs(monkeypatch, maxiter)
    return g, [fake_pass(g, need, maxiter) for need in needs]


NEEDS = [20, 2 * SLOTS, 3, SLOTS, 0, 40, SLOTS + 1]


@pytest.mark.parametrize("needs", [NEEDS, [3] + NEEDS, [0] + NEEDS],
                         ids=["long-first", "short-first", "zero-first"])
@pytest.mark.parametrize("maxiter", [1000, SLOTS + 5, 7, SLOTS])
def test_block_loop_counts_each_iteration_that_ran(monkeypatch, maxiter,
                                                   needs):
    launches.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        g, got = fake_passes(monkeypatch, needs, maxiter)
    want = [min(need, maxiter) for need in needs]
    assert got == want
    assert g._start_graph is not None and g._block_graph is not None
    slots = block_slots(want[0])
    assert g._slots == slots
    counts = launches.read()
    # The first pass is the eager loop (a read and a span an iteration);
    # every later block is one replay and one read.
    blocks = []
    for it in want[1:]:
        full = it == maxiter and it % slots == 0 and it > 0
        blocks.append(it // slots + (0 if full else 1))
    replays = counts[f"span_n:{BLOCK}"]
    assert replays == sum(blocks)
    assert counts[f"graph_slots:{BLOCK}"] == slots * replays
    assert counts["if_guard_f32"] == slots * replays    # run or skipped
    assert counts["sell_f32"] == sum(want)      # once an iteration that ran
    assert counts.get(f"span_n:{ITER}", 0) == want[0]
    # The eager loop reads once more where it stops short of maxiter.
    assert counts["host_syncs"] == want[0] + (want[0] < maxiter) + replays
    assert {k for k in counts if k.startswith("graph")} == {
        f"graph_slots:{BLOCK}"}
    launches.reset()


def test_block_loop_counts_kernels_without_a_profiler(monkeypatch):
    launches.reset()
    _, got = fake_passes(monkeypatch, NEEDS, 1000)
    counts = launches.read()
    assert counts["sell_f32"] == sum(got) == sum(NEEDS)
    assert not any(k.startswith(("graph", "span", "host")) for k in counts)
    launches.reset()


@pytest.mark.parametrize("how", ["unbuilt", "refused-start",
                                 "refused-block"])
def test_graphs_that_cannot_run_raise(monkeypatch, how):
    """On the card the loop has no stand-in for its graphs. Where the
    if-node library cannot be built or loaded, the first pass raises
    before any iteration; where CUDA refuses the start's or the block's
    capture, the second pass raises, after the first pass ran eagerly.
    No warning, no eager loop, and the next pass raises again."""
    maxiter = SLOTS + 5
    parts, start, match = {
        "unbuilt": ({"load": no_graph_if}, no_start, "nvcc not found"),
        "refused-start": ({}, host_read_start, "stream is capturing"),
        "refused-block": ({"if_node": refused_if_node}, no_start,
                          "stream is capturing"),
    }[how]
    launches.reset()
    g = fake_graphs(monkeypatch, maxiter, **parts)
    first = min(NEEDS[0], maxiter)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        if how != "unbuilt":
            assert fake_pass(g, NEEDS[0], maxiter, start) == first
        for _ in range(2):
            with pytest.raises(RuntimeError, match=match):
                fake_pass(g, NEEDS[1], maxiter, start)
    assert g.engages(torch.device("cuda"))
    assert g._block_graph is None
    assert (g._start_graph is None) == (how != "refused-block")
    ran = 0 if how == "unbuilt" else first
    assert launches.read()["sell_f32"] == ran
    launches.reset()


@pytest.mark.parametrize("name,params", [
    ("cg", {"dtype": "float32", "rtol": 1e-6}),
    ("cg_ir", {"rtol": 1e-10}),
    ("cg_ir", {"rtol": 1e-10, "precond": "amg_classical"}),
], ids=["cg-f32", "cg_ir", "cg_ir-amg"])
def test_cpu_solve_stays_eager_with_one_span_an_iteration(A, name, params):
    cls, defaults = get_solver(name)
    solver = cls(A, device="cpu", **{**defaults, **params})
    launches.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = solver.solve(rhs(A.nrows, seed=4))
    counts = launches.read()
    assert counts["span_n:lsbench.cg.iter"] == res.iters > 0
    assert not any(k.startswith("graph") or k.endswith(BLOCK)
                   for k in counts)
    assert solver._graphs._state is None
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
    """The kernels' launch counts, the if-node guards' aside: they run only
    in the graphed loop."""
    return {k: v for k, v in launches.read().items()
            if ":" not in k and "sync" not in k and not k.startswith("graph")
            and k not in graph_if.LAUNCHES}


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
    assert g._start_graph is not None and g._block_graph is not None
    for (xe, ie, pe), (xg, ig, pg) in zip(eager, graphed):
        assert (ie, pe) == (ig, pg)
        assert torch.equal(xe, xg)
    launches.reset()


@pytest.mark.cuda
def test_block_replays_are_counted_under_a_profiler(card_A, cuda_device):
    solver = card_solver(card_A, "cg_ir", {}, cuda_device)
    solves(solver, card_A, cuda_device, k=2)
    launches.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = solver.solve(rhs(card_A.nrows, seed=5, device=cuda_device))
    got = launches.read()
    passes = res.extra["refine_passes"]
    replays = got[f"span_n:{BLOCK}"]
    slots = solver._graphs._slots
    assert got[f"graph_slots:{BLOCK}"] == slots * replays
    assert got["if_guard_f32"] == slots * replays
    assert passes <= replays <= res.iters // slots + passes
    assert f"span_n:{ITER}" not in got
    assert got["sell_f32"] == res.iters and got["sell_f64"] == passes
    # A read a block, one a pass and two a solve.
    assert got["host_syncs"] == replays + passes + 1 + 2
    assert {k for k in got if k.startswith("graph")} == {
        f"graph_slots:{BLOCK}"}
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
    got = solves(solver, card_A, cuda_device)
    g = solver._graphs
    assert g._start_graph is not None and g._block_graph is not None
    for (xe, ie, pe), (xg, ig, pg) in zip(eager, got):
        assert (ie, pe) == (ig, pg) and torch.equal(xe, xg)


EDGE_SOLVES = [
    ("cg", {"dtype": "float32", "rtol": 1e-6}),
    ("cg_ir", {"precond": "jacobi"}),
    ("cg_ir", {"precond": "amg_classical"}),
    ("cg_ir", {"precond": "ic0"}),
]
EDGE_IDS = ["cg-f32", "cg_ir-jacobi", "cg_ir-amg_classical", "cg_ir-ic0"]


def pass_iterations(monkeypatch, solver, b):
    """The iterations of each pass of one eager solve of b."""
    from lsbench_tpu_torch.solvers import refine
    counts = []
    loop = cg_module.cg_loop

    def counted(*args, **kwargs):
        out = loop(*args, **kwargs)
        counts.append(out[1])
        return out
    with monkeypatch.context() as m:
        m.setattr(cg_module, "cg_loop", counted)
        m.setattr(refine, "cg_loop", counted)
        solver.solve(b)
    return counts


def ends_a_block(k):
    """A block size whose last slot is the k-th iteration: the least
    divisor of k from 8 up, or k."""
    return next(d for d in range(min(8, k), k + 1) if k % d == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["last_slot", "maxiter", "zero_b"])
@pytest.mark.parametrize("name,params", EDGE_SOLVES, ids=EDGE_IDS)
def test_graphed_blocks_match_eager_at_their_edges(card_A, name, params,
                                                   case, cuda_device,
                                                   monkeypatch):
    """Bit for bit the eager loop's x, iterations, passes and kernel
    counts, with no fallback, where a pass ends on a block's last slot
    (the block size set to divide the first pass's iterations), where
    maxiter ends a pass mid-block, and for b = 0."""
    n = card_A.nrows
    bs = [rhs(n, seed=21, device=cuda_device)] * 3
    if case == "zero_b":
        bs = [torch.zeros(n, dtype=torch.float64, device=cuda_device)] * 3
    if case == "maxiter":
        params = {**params,
                  "maxiter": 3 if "amg" in str(params) else SLOTS + 5}
    eager_solver = card_solver(card_A, name, params, cuda_device, False)
    if case == "last_slot":
        first = pass_iterations(monkeypatch, eager_solver, bs[0])[0]
        assert first > 0
        monkeypatch.setattr(cg_module, "SLOTS", ends_a_block(first))
    launches.reset()
    eager = [eager_solver.solve(b) for b in bs]
    eager_counts = kernel_counts()
    launches.reset()
    solver = card_solver(card_A, name, params, cuda_device)
    graphed = [solver.solve(b) for b in bs]
    torch.cuda.synchronize(cuda_device)
    assert kernel_counts() == eager_counts
    g = solver._graphs
    # cg_ir makes no pass for b = 0.
    assert (g._block_graph is not None) == (case != "zero_b" or name == "cg")
    for e, r in zip(eager, graphed):
        assert (e.iters, e.extra.get("refine_passes")) == (
            r.iters, r.extra.get("refine_passes"))
        assert torch.equal(e.x, r.x)
    if case == "zero_b":
        assert all(r.iters == 0 and not r.x.any() for r in graphed)
    launches.reset()
