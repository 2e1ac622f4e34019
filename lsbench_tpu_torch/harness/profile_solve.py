"""Device-time breakdown of one solve on a CUDA card.

    python -m lsbench_tpu_torch.harness.profile_solve [--out FILE]

For each case (RCM-ordered poisson_2d(512) and random_spd(6408, 23) with
the Jacobi preconditioner, and poisson_2d(512) with `amg_classical`,
`chebyshev`, `block_jacobi` and `ic0`; cg_ir, rtol 1e-10, b[i] = i;
gmres_ir (what fp64 `gmres` runs) with `amg_classical` on poisson_2d(512);
block CG (rtol 1e-10) and batched BiCGSTAB (`ginkgo`'s rtol 1e-4) on RCM
poisson_2d(512) with `--nrhs 8`'s right-hand sides; sparse_cholesky's
`level` schedule on AMD-ordered poisson_2d(512) — the solves
chip_smoke.py drives through the CLI):

1. set the solver up and solve once (kernel build, first launches);
2. time 3 unprofiled solves, each fenced with `torch.cuda.synchronize`;
   their median is `wall_s`;
3. run one solve under `torch.profiler` and export its Chrome trace;
4. from the trace's device events (categories `kernel`, `gpu_memcpy`,
   `gpu_memset`) take `busy_s`, the length of the union of their
   intervals, and the device time (the union of its events' intervals)
   and launch count per kernel name.

`idle_share = 1 - busy_s / wall_s`. The profiler slows the host (it records
every launch), not the device, so the busy time of the profiled solve is
set against the unprofiled wall time of the same process. With the Jacobi
preconditioner, `spmv_ms` is the inner f32 SpMV kernel's device time per CG
iteration (one SpMV each), and `spmv_gbps` the inner operator's layout
bytes (`bytes_streamed`) over that time; with the other preconditioners
the same kernels also run inside the V-cycle or the polynomial, so those
two are left out. `groups` sums the device time by kind
of kernel (K1-K5, the sliced-ELL kernels that replace K1, K2, K3 and K5
on the solver paths, QR, eigh, GEMM, PyTorch's elementwise and reduction
kernels, copies) by substrings of the kernel names (`GROUPS`).

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

import torch

from lsbench_tpu_torch.harness.bench import reference_rhs
from lsbench_tpu_torch.matrix.generate import poisson_2d, random_spd
from lsbench_tpu_torch.solvers.batched_bicgstab import BatchedBicgstabSolver
from lsbench_tpu_torch.solvers.block_cg import BlockCgSolver
from lsbench_tpu_torch.solvers.refine import CgIrSolver, GmresIrSolver
from lsbench_tpu_torch.solvers.sparse_cholesky import SparseCholeskySolver

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# Substrings of the inner f32 SpMV kernels' names in the trace: K1, the
# sliced-ELL f32 kernel that replaces K5 on the solver paths, and K5.
INNER_KERNELS = ("spmv_bsr_f32_kernel", "spmv_sell_f32_kernel",
                 "spmv_bsr_classed_f32_kernel")
# Kind of kernel → substrings of its names (lower case), first match wins.
GROUPS = (
    ("SELL SpMM (K3)", ("spmm_sell_f32_kernel",)),
    ("K3 spmm_bsr", ("spmm_bsr_f32_kernel",)),
    ("SELL f32", ("spmv_sell_f32_kernel",)),
    ("SELL f64", ("spmv_sell_f64_kernel",)),
    ("K2 f64acc", ("spmv_bsr_f64acc_kernel",)),
    ("K1/K5 spmv", ("spmv_bsr_f32_kernel", "spmv_bsr_classed_f32_kernel")),
    ("K4 well", ("spmv_well",)),
    ("tri sweep", ("tri_sweep_run_kernel", "tri_sweep_pair_kernel",
                   "tri_sweep_wide_kernel")),
    ("eigh", ("syev", "stedc", "sytrd", "steqr", "eigh")),
    ("QR", ("geqr", "orgqr", "ormqr", "larf", "householder")),
    ("cuSOLVER other", ("cusolver", "potrf", "trsm", "trsv", "lacpy",
                        "batch_eye", "copy_info")),
    ("cuBLAS GEMM/dot", ("gemm", "gemv", "xmma", "cutlass", "dot_kernel",
                         "splitkreduce", "reduce_1block")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index",
                     "where", "fill")),
    ("reduction", ("reduce",)),
)


def kernel_group(name: str, cat: str) -> str:
    if cat != "kernel":
        return cat
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


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


def profile_matrix(label: str, A, device, precond: str = "jacobi",
                   nrhs: int = 1, solver_cls=None, rtol: float = 1e-10,
                   **solver_kw) -> dict:
    b = torch.as_tensor(reference_rhs(A.nrows, nrhs), device=device)
    t0 = time.perf_counter()
    solver_cls = solver_cls or (BlockCgSolver if nrhs > 1 else CgIrSolver)
    solver_kw.setdefault("ordering", "rcm")
    solver = solver_cls(A, rtol=rtol, precond=precond, device=device,
                        **solver_kw)
    setup_s = time.perf_counter() - t0
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

    # Device time of a kernel name or group: the union of its events'
    # intervals, so that a kernel launched programmatically (the sweeps),
    # which may start while the one before it runs and wait for it, is not
    # counted twice.
    by_name: dict[str, list] = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    table = sorted(({"name": k, "device_ms": _union_us(v) / 1e3,
                     "count": len(v), "cat": v[0]["cat"]}
                    for k, v in by_name.items()),
                   key=lambda d: -d["device_ms"])
    by_group: dict[str, list] = {}
    for e in events:
        by_group.setdefault(kernel_group(e["name"], e["cat"]), []).append(e)
    groups = {g: {"device_ms": _union_us(v) / 1e3, "count": len(v)}
              for g, v in by_group.items()}
    busy_s = _union_us(events) / 1e6
    out = {
        "matrix": label, "solver": solver_cls.__name__, "precond": precond,
        "nrhs": nrhs, "n": A.nrows,
        "nnz": A.nnz, "iters": res.iters,
        "passes": res.extra.get("refine_passes"), **solver_kw,
        "inner_op": type(getattr(solver, "_op", None)).__name__,
        "setup_s": setup_s,
        "wall_s": wall_s, "walls_s": walls, "profiled_wall_s": prof_wall,
        "busy_s": busy_s, "idle_share": 1.0 - busy_s / wall_s,
        "groups": dict(sorted(groups.items(),
                              key=lambda kv: -kv[1]["device_ms"])),
    }
    if nrhs > 1:
        out["wall_ms_per_iter"] = wall_s * 1e3 / max(res.iters, 1)
    elif precond == "jacobi":
        inner_ms = sum(d["device_ms"] for d in table
                       if any(k in d["name"] for k in INNER_KERNELS))
        spmv_ms = inner_ms / max(res.iters, 1)
        nbytes = solver._op.bytes_streamed
        out.update(inner_spmv_share=inner_ms / 1e3 / wall_s, spmv_ms=spmv_ms,
                   spmv_bytes=nbytes,
                   spmv_gbps=nbytes / spmv_ms / 1e6 if spmv_ms > 0 else None)
    out["kernels"] = table
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results (JSON) here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_solve: no CUDA device available")
        return 1
    device = torch.device("cuda")
    results = []
    p512 = poisson_2d(512)
    for label, A, precond, nrhs, extra in (
            ("poisson_2d(512)", p512, "jacobi", 1, {}),
            ("random_spd(6408,23)", random_spd(6408, 23), "jacobi", 1, {}),
            ("poisson_2d(512)", p512, "amg_classical", 1, {}),
            ("poisson_2d(512)", p512, "chebyshev", 1, {}),
            ("poisson_2d(512)", p512, "block_jacobi", 1, {}),
            ("poisson_2d(512)", p512, "ic0", 1, {}),
            ("poisson_2d(512)", p512, "none", 1,
             {"solver_cls": SparseCholeskySolver, "ordering": "amd",
              "schedule": "level"}),
            ("poisson_2d(512)", p512, "amg_classical", 1,
             {"solver_cls": GmresIrSolver}),
            ("poisson_2d(512)", p512, "jacobi", 8, {}),
            ("poisson_2d(512)", p512, "jacobi", 8,
             {"solver_cls": BatchedBicgstabSolver, "rtol": 1e-4})):
        r = profile_matrix(label, A, device, precond, nrhs, **extra)
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
