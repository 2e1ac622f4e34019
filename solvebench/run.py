"""One run of one cell: set-up, a measured window of solves, the check.

    python3 -m solvebench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as `setup_s`, from the start of the process to the first
timed solve): the cell's matrix from the benchmark's own generator, the
reference's copy of it, the traffic's pool of products A·u_i on the card,
the program's solver (`get_solver(name)` on a `CsrMatrix` of those arrays,
with the program's setup cache in `solvebench/.cache/` where the
configuration turns it on), and warm-up solves on right-hand sides of
their own, which load every kernel this cell's solves launch.

The window is a closed loop with one caller, as a time-stepper that waits
for each solve before it sends the next: b of solve s is formed on the
card and synchronized, then the clock starts, the solver's `solve(b)`
runs, `torch.cuda.synchronize()` ends it. The window closes after the
first solve that ends `--seconds` after its start; the metrics are read
from every solve in it.

With `--trace 1` a profiled warm-up solve counts the device events of one
solve, and the first solves of the window, as many as keep the trace
under `EVENT_CAP` device events, run under `torch.profiler`; the per-layer
metrics read that trace, the program's launch counters and the solves'
own records. A trace that holds fewer f32 SELL kernel events than the
kernel's counter counted has lost events: the next solves are traced in
its place, and where every try lost some, the kernel metrics are left
out.

After the window: the peak memory is read, the program's state is freed,
and the reference judges the kept solutions (a seeded sample, and the
slowest solve's): the f64 relative residual of each against its b, by the
reference's own matvec. The configuration states the limit. Last, a run
that finds JAX or the JAX package among the loaded modules exits 1 with no
result. The last line of standard output is the
result; the last lines of standard error give each number compared
beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from solvebench import spec
from solvebench import trace as tr
from solvebench.peaks import peaks_of
from solvebench.reference import CsrReference, relres
from solvebench.rhs import RhsStream

BASE = spec.HERE                      # the benchmark's folder
ROOT = BASE.parent                    # the checkout's root
CACHE_DIR = BASE / ".cache"           # the program's setup cache
WARMUP_SOLVES = 2
EVENT_CAP = 60_000                    # device events in one trace
TRACE_TRIES = 3                       # traces where one lost events
BANNED = ("jax", "jaxlib", "flax", "lsbench_tpu")
SELL_F32 = "spmv_sell_f32_kernel"     # the program's f32 SELL kernel
CHECK_COLUMNS = 16                    # kept solutions judged at once


@dataclass
class SolveRecord:
    latency_s: float
    iters: int
    passes: int
    converged: bool


@dataclass
class Readings:
    """What the metric readers (`metrics/<name>.py`) read."""

    solves: list[SolveRecord]
    rhs_per_solve: int
    window_s: float
    setup_s: float
    memory_peak_bytes: int
    setup_breakdown: dict
    n: int
    nnz: int
    peaks: dict | None
    profiled: dict | None = None      # see `profile_readings`

    def cost(self, name: str):
        return spec.load_module(BASE, "costs", name)


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python3 -m solvebench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def program_setup_cache(on: bool, cache_dir: Path) -> None:
    """The program's documented `--cache` mode, kept in a fixed directory
    inside the checkout."""
    from lsbench_tpu_torch.harness import cache
    cache.enable(on)
    cache.set_cache_dir(cache_dir)


def make_solver(cfg: dict, A, device: torch.device, key: str = "solver"):
    from lsbench_tpu_torch.solvers import get_solver
    entry = cfg[key]
    cls, defaults = get_solver(entry["name"])
    return cls(A, device=str(device), **{**defaults, **entry["params"]})


def build_matrix(cfg: dict, matrix_overrides: dict | None = None):
    """(CsrMatrix for the program, the reference's copy), both from the
    benchmark's own generator."""
    from lsbench_tpu_torch.matrix.csr import CsrMatrix
    mspec = dict(cfg["matrix"])
    gen = spec.load_module(BASE, "matrices", mspec.pop("generator"))
    mspec.update(matrix_overrides or {})
    offs, cols, vals = gen.generate(**mspec)
    n = offs.size - 1
    return CsrMatrix(n, n, offs, cols, vals), CsrReference(offs, cols, vals)


def solve_once(solver, b) -> tuple[object, SolveRecord]:
    res = solver.solve(b)
    return res.x, SolveRecord(0.0, int(res.iters),
                              int(res.extra.get("refine_passes", 0)),
                              bool(res.converged))


def trace_events(prof) -> list[dict]:
    """The finished profiler's events, through its Chrome trace in a
    temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return tr.load_events(path)


def count_device_events(device, solver, b) -> int:
    """Device events of one solve under the profiler (a set-up step that
    also starts the profiler's tracing once before the window)."""
    with torch.profiler.profile(activities=_activities()) as prof:
        with torch.profiler.record_function(tr.SPAN):
            solver.solve(b)
            sync(device)
    return sum(e.get("cat") in tr.DEVICE_CATEGORIES
               for e in trace_events(prof))


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def run_window(solver, stream: RhsStream, device, seconds: float, s0: int,
               n_traced: int):
    """The measured window. Returns (records, window_s, kept solutions
    {solve index: host x}, the traced solves' summary or None).

    A kept solution (the seeded sample, and the slowest solve's) is copied
    to the host after its solve's clock stops; while the profiler runs it
    is held on the card and copied once the trace ends, so that the trace
    holds the solves' work alone. With `n_traced`, the first `n_traced`
    solves run under the profiler; where that trace lost kernel events
    (`profile_readings`), the next `n_traced` solves are traced in its
    place, up to `TRACE_TRIES` traces in all."""
    from lsbench_tpu_torch.ops import launches
    records: list[SolveRecord] = []
    kept: dict[int, torch.Tensor] = {}
    slow: tuple = (-1.0, -1, None)     # latency, solve index, x
    state = {"tracing": False, "tries": 0, "summary": None}
    batch: dict = {}

    def hold(x):
        x = x.detach()
        return x if state["tracing"] else x.to("cpu", copy=True)

    def start_trace():
        batch["prof"] = prof = torch.profiler.profile(
            activities=_activities())
        prof.start()
        # A few launches before the span, so that the device trace is
        # running when the first traced solve starts.
        for _ in range(8):
            torch.zeros(1, device=device).add_(1)
        sync(device)
        batch["span"] = torch.profiler.record_function(tr.SPAN)
        batch["span"].__enter__()
        batch["before"] = launches.read()
        batch["first"] = len(records)
        state["tracing"] = True

    def end_trace(again: bool):
        nonlocal slow
        batch["span"].__exit__(None, None, None)
        delta = {key: v - batch["before"].get(key, 0)
                 for key, v in launches.read().items()}
        batch["prof"].stop()
        state["tracing"] = False
        state["tries"] += 1
        for key, x in kept.items():
            if x.device.type != "cpu":
                kept[key] = hold(x)
        if slow[2].device.type != "cpu":
            slow = (slow[0], slow[1], hold(slow[2]))
        summary = profile_readings(batch.pop("prof"),
                                   records[batch["first"]:], delta)
        state["summary"] = summary
        if (again and summary is not None and not summary["events_complete"]
                and state["tries"] < TRACE_TRIES):
            log(f"trace {state['tries']}: {summary['sell_f32_events']} f32 "
                f"SELL kernel events against {delta.get('sell_f32', 0)} "
                "launches: events were lost, tracing the next solves")
            start_trace()

    if n_traced:
        start_trace()
    t_w0 = time.perf_counter()
    deadline = t_w0 + seconds
    s = s0
    while True:
        rf = (torch.profiler.record_function if state["tracing"]
              else nullcontext)
        with rf("solvebench.rhs"):
            b = stream.rhs(s)
            sync(device)
        t0 = time.perf_counter()
        with rf("solvebench.solve"):
            x, rec = solve_once(solver, b)
        with rf("solvebench.sync"):
            sync(device)
        t1 = time.perf_counter()
        rec.latency_s = t1 - t0
        records.append(rec)
        if stream.checked(s - s0) and len(kept) < stream.max_checks:
            kept[s] = hold(x)
        if rec.latency_s > slow[0]:
            slow = (rec.latency_s, s, kept[s] if s in kept else hold(x))
        if state["tracing"] and len(records) - batch["first"] == n_traced:
            end_trace(again=True)
        s += 1
        if t1 >= deadline:
            break
    window_s = time.perf_counter() - t_w0
    if state["tracing"]:
        end_trace(again=False)
    kept[slow[1]] = slow[2]
    return records, window_s, kept, state["summary"]


def judge(ref: CsrReference, stream: RhsStream, kept: dict, device) -> list:
    """The f64 relative residual of every kept solution, by the
    reference, against the b its solve was given."""
    out = []
    items = sorted(kept.items())
    for i in range(0, len(items), CHECK_COLUMNS):
        chunk = items[i:i + CHECK_COLUMNS]
        X = torch.stack([x.reshape(ref.n, -1) for _, x in chunk], dim=1)
        B = torch.stack([stream.rhs(s).reshape(ref.n, -1)
                         for s, _ in chunk], dim=1)
        X = X.reshape(ref.n, -1).to(device)
        B = B.reshape(ref.n, -1).to(device)
        out.extend(float(v) for v in relres(ref, X, B))
    return out


def profile_readings(prof, traced_records, traced_delta) -> dict | None:
    """The traced span's busy and idle time, its solves' iterations, the
    trace's device events and the launch-counter delta over the span. The
    trace holds the traced solves and a few warm-up launches before them,
    none an f32 SELL kernel, so its f32 SELL events and the counter's
    delta count the same launches where no event was lost."""
    summary = tr.summarize(trace_events(prof))
    if summary is None:
        return None
    summary["iters"] = sum(r.iters for r in traced_records)
    summary["solves"] = len(traced_records)
    summary["launches"] = traced_delta
    sell = sum(SELL_F32 in name for name, _ in summary["device_events"])
    outside = sum(SELL_F32 in name for name in summary["outside_span"])
    if outside:
        log(f"trace: {outside} of {sell} f32 SELL events start outside the "
            "host's span")
    launched = traced_delta.get("sell_f32", 0)
    summary["events_complete"] = sell == launched
    summary["sell_f32_events"] = sell
    return summary


def flush_writes(cache_dir: Path, since: float) -> None:
    """Wait until the setup-cache files this run wrote are on disk, so
    that their write-back does not run under the window (a set-up step of
    a checkout's first run; later runs write none)."""
    if not cache_dir.is_dir():
        return
    for path in cache_dir.iterdir():
        if path.is_file() and path.stat().st_mtime >= since:
            with open(path, "rb") as f:
                os.fsync(f.fileno())


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def run(args, device: torch.device, t_start: float,
        matrix_overrides: dict | None = None,
        cache_dir: Path = CACHE_DIR, solver_hook=None) -> tuple[dict, list]:
    """One run; returns (result, checks). `solver_hook(solver)` may wrap
    the solver the window drives (the tests plant faults with it)."""
    bench = spec.load_benchmark(ROOT)
    w = spec.cell(bench, args.workload)
    cfg = spec.load_config(ROOT, bench, w["config"])
    traffic = spec.load_traffic(BASE, w["traffic"])
    program_setup_cache(bool(cfg.get("setup_cache", False)), cache_dir)
    wall_start = time.time()

    A, ref = build_matrix(cfg, matrix_overrides)
    stream = RhsStream(traffic, ref, args.seed, device)
    solver = make_solver(cfg, A, device)
    if solver_hook is not None:
        solver = solver_hook(solver)
    setup_breakdown = dict(solver.setup_breakdown)
    # Warm-up on right-hand sides of their own (solve indices before the
    # window's).
    for s in range(WARMUP_SOLVES):
        solver.solve(stream.rhs(s))
    sync(device)
    n_traced = 0
    if args.trace:
        per_solve = count_device_events(device, solver,
                                        stream.rhs(WARMUP_SOLVES))
        n_traced = max(1, EVENT_CAP // max(per_solve, 1))
        log(f"trace: {per_solve} device events per solve, tracing "
            f"{n_traced} solves")
    s0 = WARMUP_SOLVES + 1
    flush_writes(cache_dir, wall_start)
    # What set-up left is not collected during the window.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    records, window_s, kept, profiled = run_window(
        solver, stream, device, args.seconds, s0, n_traced)
    gc.unfreeze()

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del solver, A
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    ctx = Readings(solves=records, rhs_per_solve=stream.k,
                   window_s=window_s, setup_s=setup_s,
                   memory_peak_bytes=peak, setup_breakdown=setup_breakdown,
                   n=ref.n, nnz=ref.nnz, peaks=peaks_of(kind),
                   profiled=profiled)
    if profiled is not None and not profiled["events_complete"]:
        log(f"trace: {profiled['sell_f32_events']} f32 SELL kernel events "
            f"against {profiled['launches'].get('sell_f32', 0)} launches: "
            "events were lost, the kernel metrics are left out")
    kind_of = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, args.workload, kind_of):
        value = spec.load_module(BASE, "metrics", m["name"]).read(ctx)
        if value is None:
            log(f"metric {m['name']}: nothing to read, left out")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    residuals = judge(ref, stream, kept, device)
    limit = float(cfg["guarantee"]["relres_max"])
    worst = max(residuals) if residuals else float("nan")
    if any(not np.isfinite(r) for r in residuals):
        worst = float("nan")
    log(f"check: {len(residuals)} solutions judged of {len(records)} solves")
    checks = [("worst_relres", worst, limit)]
    correct = bool(worst <= limit)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power"] = power_limit()
    result = {"correct": correct, "attempted": len(records) * stream.k,
              "failed": sum(not r.converged for r in records) * stream.k,
              "metrics": metrics, "device": dev}
    if profiled is not None:
        dev["busy_s"] = profiled["busy_us"] * 1e-6
        dev["window_s"] = profiled["span_us"] * 1e-6
        result["breakdown"] = {
            "device_ops": tr.top(profiled["device_by_name_us"]),
            "idle_gaps": tr.top(profiled["idle_by_host_us"])}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    found = banned_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: "
                         f"{', '.join(found)}")
    return result, checks


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    bench = spec.load_benchmark(ROOT)
    chips = spec.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"solvebench: needs {chips} CUDA device(s), have {have}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks = run(args, device, t_start)
    print(json.dumps(result), flush=True)
    for name, v, lim in checks:
        log(f"check {name}: {v!r} limit {lim!r}")
    return 0
