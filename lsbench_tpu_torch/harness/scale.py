"""Scaling harness: nnz/s efficiency across rank counts (counterpart of
`lsbench_tpu/harness/scale.py`).

Runs fixed-iteration distributed CG (`rtol=0`, `maxiter=--iters`) at each
rank count D of `--devices`, so that every count does the same work:
throughput = nnz·iters / elapsed, and efficiency(D) = throughput(D) /
(D · throughput(1)), strong scaling on one matrix. `--mesh2d` adds the
2-D grid's CG on the most-square grid at D ≥ 4. Each D is one group of D
ranks (`launch.run_ranks`): on `--platform cuda` (the default) one card per
rank with NCCL, and counts above the cards are skipped; on `--platform
cpu` any count runs as gloo processes, which test the same collectives,
not a card's links. Rank 0's solve is timed between two barriers with the
device fenced, and the median of `--reps` is reported.

The stop rule of the fixed-iteration run is the JAX loop's: the
iteration continues while ‖r‖² > 0, so a system that CG solves exactly
before `--iters` stops there, in both packages alike.

Each record has the JAX tool's keys and `launches`, rank 0's kernel
launch counts over its solves (zeros on the CPU, which runs the kernels'
plain versions).

Usage:
    python -m lsbench_tpu_torch.scale --matrix m.txt --devices 1,2,4,8 \\
        --iters 100 [--mesh2d] [--ordering rcm] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from lsbench_tpu_torch.parallel.launch import run_ranks


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lsbench_tpu_torch.scale",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--matrix", required=True)
    p.add_argument("--devices", default="1,2,4,8",
                   help="comma-separated rank counts to sweep")
    p.add_argument("--iters", type=int, default=100,
                   help="fixed CG iterations per measurement")
    p.add_argument("--reps", type=int, default=3,
                   help="timed repetitions (median reported)")
    p.add_argument("--strategy", default="auto",
                   help="1-D exchange strategy: auto | halo | all_gather")
    p.add_argument("--ordering", default="none",
                   help="ordering applied inside the solvers (rcm enables "
                        "the halo strategy on unbanded matrices)")
    p.add_argument("--mesh2d", action="store_true",
                   help="also sweep 2-D (rows x cols) grids where D = r*c")
    p.add_argument("--platform", default="cuda",
                   help="cuda (default: one card per rank) | cpu (gloo "
                        "ranks)")
    p.add_argument("--json", action="store_true", help="emit JSON records")
    return p


def _mesh2d_shape(d: int) -> tuple[int, int]:
    """Most-square factorization r*c = d with r <= c."""
    r = int(d ** 0.5)
    while d % r:
        r -= 1
    return r, d // r


def _fence_barrier(mesh, x) -> None:
    """Wait for x on this rank's device, then for every rank."""
    from lsbench_tpu_torch.utils.fence import device_fence
    device_fence(x)
    t = torch.zeros(1, device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    float(t)


def _time_solver(mesh, solver, b, reps: int) -> float:
    """Median seconds of rank 0's fixed-iteration solve, after one untimed
    warm-up."""
    fn = solver.solve_fn()
    _fence_barrier(mesh, fn(b))
    ts = []
    for _ in range(reps):
        _fence_barrier(mesh, None)
        t0 = time.perf_counter()
        x = fn(b)
        _fence_barrier(mesh, x)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[reps // 2]


def _sweep_rank(mesh, A, iters, reps, strategy, ordering, grid) -> dict:
    """One rank count: the 1-D CG and, where `grid` = (r, c) is given, the
    r × c grid's CG in the same group. Returns each one's elapsed time and
    this rank's kernel launches (set up, warm-up and timed solves), and
    the 1-D strategy."""
    from lsbench_tpu_torch.ops import launches
    from lsbench_tpu_torch.parallel.dist_cg import DistributedCg

    launches.reset()
    b = np.arange(A.nrows, dtype=np.float64)
    solver = DistributedCg(A, mesh, rtol=0.0, maxiter=iters,
                           strategy=strategy, ordering=ordering)
    out = {"elapsed_s": _time_solver(mesh, solver, b, reps),
           "strategy": solver.strategy, "launches": launches.read()}
    if grid is not None:
        from lsbench_tpu_torch.parallel.dist2d import DistributedCg2d
        from lsbench_tpu_torch.parallel.mesh import as_grid
        launches.reset()
        s2 = DistributedCg2d(A, as_grid(mesh, *grid), rtol=0.0,
                             maxiter=iters, ordering=ordering)
        out["elapsed_2d_s"] = _time_solver(mesh, s2, b, reps)
        out["launches_2d"] = launches.read()
    return out


def _record(mesh: str, d: int, elapsed: float, work: int, base: float,
            strategy: str, launches: dict) -> dict:
    thru = work / elapsed
    return {"mesh": mesh, "devices": d, "elapsed_s": round(elapsed, 6),
            "nnz_per_s": round(thru, 1), "speedup": round(thru / base, 3),
            "efficiency": round(thru / (base * d), 3), "strategy": strategy,
            "launches": launches}


def run_sweep(A, counts, iters=100, reps=3, strategy="auto",
              ordering="none", mesh2d=False, platform="cuda",
              timeout: float = 600):
    """Rank-count sweep of fixed-iteration distributed CG on `A`, one
    `run_ranks(D, …)` per count. Returns the list of records (the
    importable core of `python -m lsbench_tpu_torch.scale`). On `cuda`,
    counts above the cards are skipped (the others' records are kept).
    Speedup and efficiency are relative to the first count's 1-D run."""
    if platform == "cuda":
        avail = torch.cuda.device_count()
        for d in counts:
            if d > avail:
                print(f"run_sweep: skipping {d} devices (have {avail})",
                      file=sys.stderr)
        counts = [d for d in counts if d <= avail]

    work = A.nnz * iters
    records = []
    base = None
    for d in counts:
        grid = None
        if mesh2d and d >= 4:
            r, c = _mesh2d_shape(d)
            grid = (r, c) if r > 1 else None
        out = run_ranks(d, _sweep_rank, A, iters, reps, strategy, ordering,
                        grid, platform=platform, timeout=timeout)[0]
        if base is None:
            base = work / out["elapsed_s"]
        records.append(_record(f"{d}x1", d, out["elapsed_s"], work, base,
                               out["strategy"], out["launches"]))
        if grid is not None:
            records.append(_record(f"{grid[0]}x{grid[1]}", d,
                                   out["elapsed_2d_s"], work, base, "2d",
                                   out["launches_2d"]))
    return records


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from lsbench_tpu_torch.matrix.io import read_matrix

    platform = args.platform.lower()
    if platform not in ("cuda", "cpu"):
        print(f"Unsupported platform '{args.platform}' (cuda | cpu).",
              file=sys.stderr)
        return 1
    if platform == "cuda" and not torch.cuda.is_available():
        print("--platform cuda: no CUDA device is available (use "
              "--platform cpu to run gloo ranks).", file=sys.stderr)
        return 1
    counts = [int(x) for x in args.devices.split(",") if x]
    if platform == "cuda":
        have = torch.cuda.device_count()
        usable = [d for d in counts if d <= have]
        skipped = [d for d in counts if d > have]
        if skipped:
            print(f"# skipping device counts {skipped}: only {have} devices "
                  f"({platform})", file=sys.stderr)
    else:
        usable = counts
    if not usable:
        print("no usable device counts", file=sys.stderr)
        return 1

    A = read_matrix(args.matrix)
    records = run_sweep(A, usable, iters=args.iters, reps=args.reps,
                        strategy=args.strategy, ordering=args.ordering,
                        mesh2d=args.mesh2d, platform=platform)

    hdr = f"{'mesh':>6} {'devices':>7} {'elapsed_s':>10} {'Gnnz/s':>8} " \
          f"{'speedup':>8} {'eff':>6} {'strategy':>10}"
    print(hdr)
    for r in records:
        print(f"{r['mesh']:>6} {r['devices']:>7} {r['elapsed_s']:>10.4f} "
              f"{r['nnz_per_s'] / 1e9:>8.3f} {r['speedup']:>8.2f} "
              f"{r['efficiency']:>6.2f} {r['strategy']:>10}")
    if args.json:
        for r in records:
            print(json.dumps({"matrix": args.matrix, "iters": args.iters,
                              "n": A.nrows, "nnz": A.nnz, **r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
