"""The port's spans and counted host syncs (`ops/launches.py`): `span` and
`host_read` inside the solve, on the CPU at a small grid.

- With no profiler recording, `span()` is one shared no-op context and the
  solve adds no key to `launches.read()`.
- Under a `torch.profiler` session the Chrome trace holds the spans as
  the loops nest them: `lsbench.ir.pass` ⊃ `lsbench.cg.iter`, and
  `lsbench.amg.vcycle` ⊃ `level0` ⊃ `level1` … ⊃ `lsbench.amg.coarse`.
- The counts are the loops': one `lsbench.cg.iter` an inner iteration,
  one V-cycle an iteration plus one a pass, and `host_syncs` = iterations
  + 2·passes + 3 for `cg_ir`.
- Every other routed stop test counts its reads, and no solve changes a
  bit of x or its iteration count under the profiler.
"""

import json
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from lsbench_tpu_torch.matrix.generate import poisson_2d
from lsbench_tpu_torch.ops import launches
from lsbench_tpu_torch.solvers import get_solver

PRECONDS = ["jacobi", "amg_classical"]
ITER, PASS, VCYCLE = "lsbench.cg.iter", "lsbench.ir.pass", "lsbench.amg.vcycle"
COARSE = "lsbench.amg.coarse"


@pytest.fixture(scope="module")
def A():
    return poisson_2d(40)


def make(A, name="cg_ir", **params):
    cls, defaults = get_solver(name)
    return cls(A, device="cpu", **{**defaults, "rtol": 1e-10, **params})


def rhs(A, k=None):
    rng = np.random.default_rng(7)
    shape = A.nrows if k is None else (A.nrows, k)
    return torch.as_tensor(rng.standard_normal(shape))


def profiled(solver, b, path=None):
    """(result, the span and sync keys of `launches.read()`, the trace's
    user annotations) of one solve under a CPU profiler session."""
    launches.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = solver.solve(b)
    counts = {k: v for k, v in launches.read().items()
              if k.startswith("span_") or k in ("host_syncs", "sync_wait_ns")}
    events = []
    if path is not None:
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("cat") == "user_annotation"
                      and e.get("name", "").startswith("lsbench.")]
    return res, counts, events


def inside(child, parents, slack=1e-3):
    """Whether the event `child` lies within one of `parents` (µs)."""
    t0, t1 = child["ts"], child["ts"] + child["dur"]
    return any(p["ts"] - slack <= t0 and t1 <= p["ts"] + p["dur"] + slack
               for p in parents)


def test_span_with_no_profiler_is_one_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    s = launches.span(ITER)
    assert s is launches.span(VCYCLE)
    assert isinstance(s, nullcontext)
    with s, launches.span(PASS):
        pass
    assert launches.host_read(torch.tensor(2.5)) == 2.5
    assert launches.host_read(torch.tensor(1.0) > 0) is True


@pytest.mark.parametrize("precond", PRECONDS)
def test_solve_with_no_profiler_adds_no_key(A, precond):
    solver = make(A, precond=precond)
    launches.reset()
    before = launches.read()
    res = solver.solve(rhs(A))
    assert res.converged
    assert launches.read() == before


@pytest.mark.parametrize("precond", PRECONDS)
def test_spans_nest_in_the_trace(A, precond, tmp_path):
    solver = make(A, precond=precond)
    res, _, events = profiled(solver, rhs(A), tmp_path / "trace.json")
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    assert len(by[PASS]) == res.extra["refine_passes"]
    assert all(inside(e, by[PASS]) for e in by[ITER])
    if precond == "jacobi":
        assert set(by) == {PASS, ITER}
        return
    levels = sorted(k for k in by if k.startswith("lsbench.amg.level"))
    assert levels[0] == "lsbench.amg.level0" and len(levels) >= 2
    assert all(inside(e, by[PASS]) for e in by[VCYCLE])
    assert all(inside(e, by[VCYCLE]) for e in by["lsbench.amg.level0"])
    for lvl in range(1, len(levels)):
        assert all(inside(e, by[f"lsbench.amg.level{lvl - 1}"])
                   for e in by[f"lsbench.amg.level{lvl}"])
    assert all(inside(e, by[levels[-1]]) for e in by[COARSE])
    # Every apply but the first of each pass runs inside an iteration.
    in_iter = sum(inside(e, by[ITER]) for e in by[VCYCLE])
    assert in_iter == len(by[VCYCLE]) - res.extra["refine_passes"]


@pytest.mark.parametrize("precond", PRECONDS)
def test_counts_are_the_loops(A, precond):
    solver = make(A, precond=precond)
    res, counts, _ = profiled(solver, rhs(A))
    iters, passes = res.iters, res.extra["refine_passes"]
    assert counts[f"span_n:{ITER}"] == iters
    assert counts[f"span_n:{PASS}"] == passes
    assert counts["host_syncs"] == iters + 2 * passes + 3
    assert counts["sync_wait_ns"] > 0
    assert counts[f"span_ns:{PASS}"] > counts[f"span_ns:{ITER}"] > 0
    if precond == "amg_classical":
        applies = counts[f"span_n:{VCYCLE}"]
        assert applies == iters + passes
        assert counts[f"span_n:{COARSE}"] == applies
        assert counts["span_n:lsbench.amg.level0"] == applies
        assert counts[f"span_ns:{VCYCLE}"] > counts[f"span_ns:{COARSE}"]
    else:
        assert f"span_n:{VCYCLE}" not in counts


@pytest.mark.parametrize("precond", PRECONDS)
def test_profiler_changes_no_bit(A, precond):
    solver = make(A, precond=precond)
    b = rhs(A)
    plain = solver.solve(b)
    traced, _, _ = profiled(solver, b)
    assert torch.equal(plain.x, traced.x)
    assert plain.iters == traced.iters
    assert plain.extra == traced.extra


# The other routed stop tests: (solver, params, columns of b).
ROUTED = [
    ("bicgstab_ir", {}, None),
    ("gmres_ir", {"restart": 20}, None),
    ("block_cg", {"method": "shared"}, 3),
    ("block_cg", {"method": "simultaneous"}, 3),
    ("amg", {"coarsening": "classical"}, None),
    ("amg", {"coarsening": "classical", "dtype": "float32", "rtol": 1e-5},
     None),
]
IDS = ["bicgstab_ir", "gmres_ir", "block_cg-shared", "block_cg-simultaneous",
       "amg-ir", "amg-f32"]


@pytest.mark.parametrize("name,params,k", ROUTED, ids=IDS)
def test_routed_stop_tests_are_counted(A, name, params, k):
    solver = make(A, name, **params)
    b = rhs(A, k)
    plain = solver.solve(b)
    traced, counts, _ = profiled(solver, b)
    assert torch.equal(plain.x, traced.x) and plain.iters == traced.iters
    assert counts["host_syncs"] >= 2 and counts["sync_wait_ns"] > 0
    launches.reset()
    assert not any(":" in key or "sync" in key for key in launches.read())


def test_reset_forgets_spans_and_keeps_kernel_keys():
    launches.reset()
    kernel = launches.read()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with launches.span(ITER):
            launches.host_read(torch.tensor(1.0))
    got = launches.read()
    assert got[f"span_n:{ITER}"] == 1 and got["host_syncs"] == 1
    assert {k: got[k] for k in kernel} == kernel
    launches.reset()
    assert set(launches.read()) == set(kernel)
