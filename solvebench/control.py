"""The readings that the correctness limit is set from.

    python3 -m solvebench.control --workload <cell> --seeds 1,2,3 --solves 24

For each seed, the cell's traffic (the same stream the benchmark's runs
draw, from the window's first solve on) is solved `--solves` times by the
program's solver as the cell runs it, and by the control: the
configuration's `control` entry, the program's own path in the nearest
precision below the one the configuration states (float32 for float64).
The reference judges every solution as a run does, and one JSON line per
seed and side gives the worst and the best relative residual. The last
line gives the lower reading (the program's worst over all seeds) and the
upper one (the control's best). One process serves every seed: the matrix,
its layouts and the hierarchy are the same for all of them; the control
may take only the first `--control-seeds` of them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from solvebench import run as bench_run
from solvebench import spec
from solvebench.rhs import RhsStream


def readings(cell: str, seeds: list[int], solves: int, device,
             control_seeds: int | None = None,
             matrix_overrides: dict | None = None, cache_dir=None) -> dict:
    """Both sides' readings on `seeds`; the control on the first
    `control_seeds` of them (all by default)."""
    bench = spec.load_benchmark(bench_run.ROOT)
    w = spec.cell(bench, cell)
    cfg = spec.load_config(bench_run.ROOT, bench, w["config"])
    traffic = spec.load_traffic(bench_run.BASE, w["traffic"])
    bench_run.program_setup_cache(bool(cfg.get("setup_cache", False)),
                                  cache_dir or bench_run.CACHE_DIR)
    A, ref = bench_run.build_matrix(cfg, matrix_overrides)
    solvers = {"program": bench_run.make_solver(cfg, A, device),
               "control": bench_run.make_solver(cfg, A, device,
                                                key="control")}
    out = {"program": [], "control": []}
    for i, seed in enumerate(seeds):
        stream = RhsStream(traffic, ref, seed, device)
        s0 = bench_run.WARMUP_SOLVES + 1
        for side, solver in solvers.items():
            if side == "control" and control_seeds is not None \
                    and i >= control_seeds:
                continue
            kept, iters = {}, []
            t0 = time.perf_counter()
            for s in range(s0, s0 + solves):
                res = solver.solve(stream.rhs(s))
                kept[s] = res.x.detach().to("cpu", copy=True)
                iters.append(int(res.iters))
            bench_run.sync(device)
            secs = time.perf_counter() - t0
            rr = bench_run.judge(ref, stream, kept, device)
            line = {"side": side, "seed": seed, "worst": max(rr),
                    "best": min(rr), "iters": iters, "seconds": secs}
            print(json.dumps(line), flush=True)
            out[side].append(line)
    out["lower"] = max(r["worst"] for r in out["program"])
    out["upper"] = min(r["best"] for r in out["control"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m solvebench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--solves", type=int, default=24)
    p.add_argument("--control-seeds", type=int, default=None,
                   help="run the control on the first this many seeds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("solvebench.control: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                   args.solves, device, args.control_seeds)
    print(json.dumps({"lower": out["lower"], "upper": out["upper"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
