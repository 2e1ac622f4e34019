"""Triangular sweeps of two source trees on one CUDA card, in turns.

    python3 sweep_turns.py [--parent DIR] [--order parent,change,change,parent]
        [--out FILE]

Compares the sweep kernels of this tree ("change") with those of another
checkout of the port ("parent", e.g. `git archive` of an earlier commit
unpacked into a directory), each turn in a fresh process that imports the
port from its own tree and builds that tree's kernels, so that two designs
are timed on one card within one call. The factors are made once, here:
the IC(0) factor of RCM poisson_2d(512), the sparse Cholesky factor of
AMD-ordered poisson_2d(512), and the IC(0) factor of RCM random_spd(6408,
23) (f64 only, as `cg --precond ic0` sweeps it); b is standard normal from
seed 11 (k = 1) and 12 (k = 8).

Each turn packs both sweeps of each factor (`pack_tri_host`, `upload_tri`:
the API both trees share), sweeps once to build and warm up, then takes
the median CUDA-event time of 20 sweeps, forward and backward, at k = 1
and k = 8 columns, with the launches of one sweep (`LAUNCHES`). The first
turn's x is the yardstick: every later turn's x must agree with it within
1e-5·max|x| (f32) or 1e-12·max|x| (f64). Prints one JSON object per turn
and a summary; `--out` writes them all.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.abspath(__file__)
TREE = os.path.dirname(HERE)
# label → dtypes swept
CASES = {"IC(0) poisson_2d(512) RCM": ("float32", "float64"),
         "AMD factor poisson_2d(512)": ("float32", "float64"),
         "IC(0) random_spd(6408,23) RCM": ("float64",)}


def make_factors(path: str) -> None:
    """Write the factors' CSC arrays and the right-hand sides to `path`."""
    from lsbench_tpu_torch.matrix.generate import poisson_2d, random_spd
    from lsbench_tpu_torch.ordering import get_ordering
    from lsbench_tpu_torch.solvers import sparse_cholesky as sc
    from lsbench_tpu_torch.solvers.ic0 import ic0_factor

    A512, rspd = poisson_2d(512), random_spd(6408, 23)
    As = sc.symmetrize(A512.permuted(get_ordering("amd", A512)))
    made = {
        "IC(0) poisson_2d(512) RCM":
            ic0_factor(A512.permuted(get_ordering("rcm", A512))),
        "AMD factor poisson_2d(512)":
            sc.numeric_factor(As, *sc.symbolic_rows(
                As, sc.elimination_tree(As))),
        "IC(0) random_spd(6408,23) RCM":
            ic0_factor(rspd.permuted(get_ordering("rcm", rspd)))}
    arrays = {}
    for i, label in enumerate(CASES):
        cp, ci, cx = made[label]
        n = len(cp) - 1
        arrays.update({f"cp{i}": cp, f"ci{i}": ci, f"cx{i}": cx,
                       f"b1_{i}": np.random.default_rng(11).standard_normal(n),
                       f"b8_{i}": np.random.default_rng(12).standard_normal(
                           (n, 8))})
    np.savez(path, **arrays)


def worker(factors: str, xs_out: str) -> dict:
    """One turn: the sweeps of every case in the tree on sys.path."""
    import torch

    import lsbench_tpu_torch
    from lsbench_tpu_torch.ops import tri_sweep as ts
    from lsbench_tpu_torch.solvers import sparse_cholesky as sc

    dev = torch.device("cuda")
    data = np.load(factors)
    rec, xs = {"tree": os.path.dirname(os.path.dirname(
        lsbench_tpu_torch.__file__)), "cases": {}}, {}

    def median_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    for i, (label, dtypes) in enumerate(CASES.items()):
        cp, ci, cx = data[f"cp{i}"], data[f"ci{i}"], data[f"cx{i}"]
        host, _ = sc.pack_tri_host(cp, ci, cx, len(cp) - 1)
        for dt in dtypes:
            dtype = getattr(torch, dt)
            state = sc.upload_tri(host, dtype, dev, plain=False)
            out = {}
            for k in (1, 8):
                b = torch.as_tensor(data[f"b{k}_{i}"], dtype=dtype,
                                    device=dev)
                for sweep, S in (("f", state.f), ("b", state.b)):
                    ts.reset_launches()
                    x = ts.tri_sweep(S, b)
                    torch.cuda.synchronize()
                    launches = sum(ts.LAUNCHES.values())
                    xs[f"{i}_{dt}_{k}_{sweep}"] = x.cpu().numpy()
                    out[f"{sweep}_k{k}_ms"] = median_ms(
                        lambda: ts.tri_sweep(S, b))
                    out[f"{sweep}_k{k}_launches"] = launches
            rec["cases"][f"{label} {dt}"] = out
            del state
            torch.cuda.empty_cache()
    np.savez(xs_out, **xs)
    return rec


def run_turn(tree: str, factors: str, xs_out: str) -> dict:
    """A turn in a fresh process that imports the port from `tree`."""
    code = ("import sys, runpy; sys.path.insert(0, sys.argv[1]); "
            "sys.argv = [sys.argv[2]] + sys.argv[3:]; "
            "runpy.run_path(sys.argv[0], run_name='__main__')")
    proc = subprocess.run(
        [sys.executable, "-c", code, tree, HERE, "--worker", factors,
         xs_out], cwd=tree, capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout of the port")
    ap.add_argument("--order", default="parent,change,change,parent")
    ap.add_argument("--out")
    ap.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(*args.worker)))
        return 0
    trees = {"change": TREE}
    if args.parent:
        trees["parent"] = os.path.abspath(args.parent)
    order = [t for t in args.order.split(",") if t in trees]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        factors = os.path.join(tmp, "factors.npz")
        make_factors(factors)
        ref = None
        for turn, name in enumerate(order):
            xs_path = os.path.join(tmp, f"x{turn}.npz")
            rec = run_turn(trees[name], factors, xs_path)
            xs = dict(np.load(xs_path))
            ref = ref or xs
            worst = 0.0
            for key, x in xs.items():
                tol = 1e-5 if "float32" in key else 1e-12
                err = float(np.abs(x - ref[key]).max()
                            / np.abs(ref[key]).max())
                if err > tol:
                    raise RuntimeError(f"turn {turn} ({name}) {key}: x "
                                       f"differs from turn 0 by {err:.3e}")
                worst = max(worst, err)
            rec.update(turn=turn, name=name, max_rel_diff_vs_turn0=worst)
            print(json.dumps(rec), flush=True)
            results.append(rec)
    summary = {}
    for rec in results:
        for case, out in rec["cases"].items():
            for key, v in out.items():
                if key.endswith("_ms"):
                    summary.setdefault(f"{case} {key}", {}).setdefault(
                        rec["name"], []).append(v)
    for key, by_tree in summary.items():
        print(f"{key}: " + "  ".join(
            f"{name} {' '.join(f'{v:.4f}' for v in vals)}"
            for name, vals in by_tree.items()))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"turns": results, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
