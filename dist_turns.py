"""Distributed and single-device solves of two source trees on one CUDA
card, in turns.

    python3 dist_turns.py --parent DIR [--order parent,change,change,parent]
        [--out FILE]

Runs the port's CLI on RCM poisson_2d(512) (b[i] = i, 3 timed trials
after 1 warm-up) from this tree ("change") and from another checkout of
the port ("parent", e.g. `git archive` of an earlier commit unpacked into
a directory), each command in a fresh process that imports the port from
its own tree, so that both are timed on one card within one call:

- `cg_ir --rtol 1e-10` on one card, at `--devices 1` (an NCCL group of
  one) and at `--devices 1 --mesh 1x1` (the 2-D grid's schedule);
- `cg_ir --precond amg_classical --rtol 1e-10` on one card and at
  `--devices 1`.

A command the tree's CLI refuses (exit 1) is skipped for that tree. Prints
one JSON object per command (tree, turn, solve_s, iters, refine_passes,
true_relres, setup_s) and a summary of each command's solve_s by tree;
`--out` writes them all.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

TREE = os.path.dirname(os.path.abspath(__file__))
BASE = ["--ordering", "rcm", "--rtol", "1e-10", "--trials", "3",
        "--warmups", "1", "--json"]
CASES = {
    "cg_ir": ["--solver", "cg_ir"],
    "cg_ir --devices 1": ["--solver", "cg_ir", "--devices", "1"],
    "cg_ir --devices 1 --mesh 1x1": ["--solver", "cg_ir", "--devices", "1",
                                     "--mesh", "1x1"],
    "cg_ir amg_classical": ["--solver", "cg_ir", "--precond",
                            "amg_classical"],
    "cg_ir amg_classical --devices 1": ["--solver", "cg_ir", "--precond",
                                        "amg_classical", "--devices", "1"],
}


def run(tree: str, matrix: str, argv: list) -> dict | None:
    """One CLI run from `tree`: its JSON record, or None if refused."""
    env = dict(os.environ, PYTHONPATH=tree)
    p = subprocess.run([sys.executable, "-m", "lsbench_tpu_torch",
                        "--matrix", matrix, *argv, *BASE], cwd=tree,
                       env=env, capture_output=True, text=True, timeout=600)
    if p.returncode == 1 and not p.stdout.strip():
        return None
    if p.returncode != 0:
        raise RuntimeError(f"{tree}: {argv} exited {p.returncode}:\n"
                           f"{p.stderr[-3000:]}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the other tree (its lsbench_tpu_torch/)")
    ap.add_argument("--order", default="parent,change,change,parent")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, TREE)
    import torch
    if not torch.cuda.is_available():
        print("dist_turns: no CUDA device available", file=sys.stderr)
        return 1
    from lsbench_tpu_torch.matrix.generate import poisson_2d
    from lsbench_tpu_torch.matrix.io import write_matrix

    trees = {"parent": os.path.abspath(args.parent), "change": TREE}
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        matrix = os.path.join(tmp, "poisson_2d_512.txt")
        write_matrix(poisson_2d(512), matrix)
        for turn, label in enumerate(args.order.split(",")):
            for case, argv in CASES.items():
                rec = run(trees[label], matrix, argv)
                if rec is None:
                    continue
                out = {"tree": label, "turn": turn, "case": case,
                       **{k: rec.get(k) for k in (
                           "solve_s", "iters", "refine_passes",
                           "true_relres", "setup_s", "device")}}
                records.append(out)
                print(json.dumps(out), flush=True)
    summary = {}
    for r in records:
        summary.setdefault(r["case"], {}).setdefault(r["tree"], []).append(
            r["solve_s"])
    print("summary solve_s: " + json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"records": records, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
