"""Device-time breakdown of one cg_ir solve on a CUDA card.

    python -m lsbench_tpu_torch.harness.profile_solve [--out FILE]

For each main-path matrix (RCM-ordered poisson_2d(512) and
random_spd(6408, 23); cg_ir, rtol 1e-10, b[i] = i — the solves chip_smoke.py
drives through the CLI):

1. set the solver up and solve once (kernel build, first launches);
2. time 3 unprofiled solves, each fenced with `torch.cuda.synchronize`;
   their median is `wall_s`;
3. run one solve under `torch.profiler` and export its Chrome trace;
4. from the trace's device events (categories `kernel`, `gpu_memcpy`,
   `gpu_memset`) take `busy_s`, the length of the union of their
   intervals, and the device time and launch count per kernel name.

`idle_share = 1 - busy_s / wall_s`. The profiler slows the host (it records
every launch), not the device, so the busy time of the profiled solve is
set against the unprofiled wall time of the same process. `spmv_ms` is the
inner f32 SpMV kernel's device time per CG iteration (one SpMV each), and
`spmv_gbps` the operator's stored blocks streamed in that time.

Prints one JSON object per matrix; `--out` also writes them, with the full
per-kernel table, to a file. Raises if the trace holds no device events.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from lsbench_tpu_torch.matrix.generate import poisson_2d, random_spd
from lsbench_tpu_torch.solvers.refine import CgIrSolver

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# Substrings of the inner f32 SpMV kernels' names in the trace.
INNER_KERNELS = ("spmv_bsr_f32_kernel", "spmv_bsr_classed_f32_kernel")


def _timed_solve(solver, b) -> tuple[float, object]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(b)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res


def _device_events(trace_path: str) -> list[dict]:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("cat") in DEVICE_CATEGORIES and "dur" in e]


def _union_us(events: list[dict]) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals (µs)."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def profile_matrix(label: str, A, device) -> dict:
    b = torch.as_tensor(np.arange(A.nrows, dtype=np.float64), device=device)
    solver = CgIrSolver(A, rtol=1e-10, ordering="rcm", device=device)
    _timed_solve(solver, b)
    walls, res = [], None
    for _ in range(3):
        wall, res = _timed_solve(solver, b)
        walls.append(wall)
    wall_s = statistics.median(walls)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_wall, _ = _timed_solve(solver, b)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = _device_events(path)
    if not events:
        raise RuntimeError(f"{label}: the profiler trace holds no device "
                           "events; time with CUDA events instead")

    by_name: dict[str, dict] = {}
    for e in events:
        d = by_name.setdefault(e["name"], {"device_ms": 0.0, "count": 0,
                                           "cat": e["cat"]})
        d["device_ms"] += e["dur"] / 1e3
        d["count"] += 1
    table = sorted(({"name": k, **v} for k, v in by_name.items()),
                   key=lambda d: -d["device_ms"])
    busy_s = _union_us(events) / 1e6
    inner_ms = sum(d["device_ms"] for d in table
                   if any(k in d["name"] for k in INNER_KERNELS))
    spmv_ms = inner_ms / max(res.iters, 1)
    nbytes = solver._op.bytes_streamed
    return {
        "matrix": label, "n": A.nrows, "nnz": A.nnz, "iters": res.iters,
        "passes": res.extra["refine_passes"],
        "inner_op": type(solver._op).__name__,
        "wall_s": wall_s, "walls_s": walls, "profiled_wall_s": prof_wall,
        "busy_s": busy_s, "idle_share": 1.0 - busy_s / wall_s,
        "inner_spmv_share": inner_ms / 1e3 / wall_s,
        "spmv_ms": spmv_ms, "spmv_bytes": nbytes,
        "spmv_gbps": nbytes / spmv_ms / 1e6 if spmv_ms > 0 else None,
        "kernels": table,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results (JSON) here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_solve: no CUDA device available")
        return 1
    device = torch.device("cuda")
    results = []
    for label, A in (("poisson_2d(512)", poisson_2d(512)),
                     ("random_spd(6408,23)", random_spd(6408, 23))):
        r = profile_matrix(label, A, device)
        results.append(r)
        top = r["kernels"][:8]
        print(json.dumps({k: v for k, v in r.items() if k != "kernels"}))
        for d in top:
            print(f"  {d['device_ms']:10.4f} ms {d['count']:7d}x "
                  f"[{d['cat']}] {d['name'][:100]}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
