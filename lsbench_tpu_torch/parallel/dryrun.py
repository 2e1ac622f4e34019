"""Distributed dry run: one full solve of every distributed solver on n
ranks at a tiny size (counterpart of `lsbench_tpu/parallel/dryrun.py` and
of `__graft_entry__.dryrun_multichip`).

    python -m lsbench_tpu_torch.parallel.dryrun N [--platform cpu]

The n ranks come through `launch.run_ranks`, each a process that builds
every solver on its own mesh: on `cuda` an NCCL group with one card per
rank, on `cpu` gloo ranks. The CPU is used only when asked for: with fewer
cards than n on `cuda` the run exits 1 with "requested N devices, have M",
where the JAX hook falls back to a virtual CPU mesh.

Each solve holds the JAX dry run's asserts with the same tolerances, or
tighter where the port reaches more: the mixed-precision (IR) classes
gate at their rtol, 1e-8, where the JAX dry run gates at 1e-5 because its
interpret-mode double-float residual loses precision on the simulated
mesh; the port's f64 residual is native FP64.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from lsbench_tpu_torch.parallel.launch import run_ranks
from lsbench_tpu_torch.parallel.mesh import check_devices


def _check(cond: bool, what) -> None:
    """The dry run's assert, kept under `python -O`."""
    if not cond:
        raise AssertionError(what)


def _relres(A, x, b) -> float:
    from lsbench_tpu_torch.solvers.base import to_numpy
    return float(np.linalg.norm(b - A.matvec(to_numpy(x)))
                 / np.linalg.norm(b))


def _dryrun_rank(mesh, n_devices: int) -> dict:
    """Every solve of the dry run on this rank; returns {solve: (iters,
    host relres)} and the kernel launches of the rank's solves."""
    from lsbench_tpu_torch.matrix.generate import poisson_2d
    from lsbench_tpu_torch.ops import launches
    from lsbench_tpu_torch.parallel.dist_amg import (DistributedAmg,
                                                     DistributedAmgCg)
    from lsbench_tpu_torch.parallel.dist_bicgstab import DistributedBicgstab
    from lsbench_tpu_torch.parallel.dist_block_cg import DistributedBlockCg
    from lsbench_tpu_torch.parallel.dist_cg import DistributedCg
    from lsbench_tpu_torch.parallel.dist_cg_ir import (DistributedBicgstabIr,
                                                       DistributedCgIr,
                                                       DistributedGmresIr)
    from lsbench_tpu_torch.parallel.dist_gmres import DistributedGmres
    from lsbench_tpu_torch.solvers.base import to_numpy

    launches.reset()
    A = poisson_2d(8 * max(1, int(np.sqrt(n_devices))))  # tiny, shardable
    b = np.arange(A.nrows, dtype=np.float64)
    out = {}

    def solved(name, res, bar):
        r = _relres(A, res.x, b)
        _check(res.converged and r < bar, (name, res.iters, res.relres, r))
        out[name] = (int(res.iters), r)

    # Jacobi-CG: halo/all_gather SpMV + fused all-reduce iteration.
    solved("cg", DistributedCg(A, mesh, rtol=1e-10).solve(b), 1e-8)
    # AMG-preconditioned CG: every level row-partitioned.
    solved("amg_cg", DistributedAmgCg(A, mesh, rtol=1e-10, coarse_n=16,
                                      max_levels=3).solve(b), 1e-8)
    # The SELL f64 kernel on each rank's block (the JAX dry run's
    # local_spmv="bsr", its double-float BSR shard path).
    s = DistributedCg(A, mesh, rtol=1e-10, local_spmv="bsr")
    _check(s.local_spmv == "bsr", ("cg bsr", s.local_spmv))
    solved("cg bsr", s.solve(b), 1e-8)
    # GMRES and BiCGSTAB on the SELL f64 kernel.
    solved("gmres", DistributedGmres(A, mesh, rtol=1e-8, restart=20,
                                     local_spmv="bsr").solve(b), 1e-6)
    solved("bicgstab", DistributedBicgstab(A, mesh, rtol=1e-6,
                                           local_spmv="bsr").solve(b), 1e-4)
    # Fixed-cycle DistributedAmg (the hypre maxiter=2 protocol), level 0
    # on the SELL kernel.
    amg = DistributedAmg(A, mesh, cycles=2, coarse_n=16, max_levels=3,
                         local_spmv="bsr")
    res = amg.solve(b)
    _check(res.iters == 2 and np.isfinite(res.relres)
           and amg.local_spmv == "bsr",
           ("amg v fixed", res.iters, res.relres, amg.local_spmv))
    out["amg v fixed"] = (res.iters, _relres(A, res.x, b))
    # The K-cycle (the parAlmond protocol over the ranks).
    res = DistributedAmg(A, mesh, cycles=1, cycle="k", coarse_n=16,
                         max_levels=3).solve(b)
    _check(res.iters == 1 and np.isfinite(res.relres),
           ("amg k fixed", res.iters, res.relres))
    out["amg k fixed"] = (res.iters, _relres(A, res.x, b))
    # Mixed precision: f32 inner solves on the SELL f32 kernel, the f64
    # residual on the SELL f64 kernel.
    solved("cg_ir", DistributedCgIr(A, mesh, rtol=1e-8,
                                    local_spmv="bsr").solve(b), 1e-8)
    solved("bicgstab_ir", DistributedBicgstabIr(
        A, mesh, rtol=1e-8, local_spmv="bsr").solve(b), 1e-8)
    solved("gmres_ir", DistributedGmresIr(
        A, mesh, rtol=1e-8, restart=20, local_spmv="bsr").solve(b), 1e-8)
    # k right-hand sides through one exchange per iteration.
    k = 3
    rng = np.random.default_rng(0)
    B = np.column_stack([b] + [rng.standard_normal(A.nrows)
                               for _ in range(k - 1)])
    res = DistributedBlockCg(A, mesh, nrhs=k, rtol=1e-6).solve(B)
    X = to_numpy(res.x)
    worst = max(np.linalg.norm(B[:, j] - A.matvec(X[:, j]))
                / np.linalg.norm(B[:, j]) for j in range(k))
    _check(worst < 1e-4, ("block_cg k=3", res.iters, worst))
    out["block_cg k=3"] = (int(res.iters), float(worst))

    if n_devices % 2 == 0 and n_devices >= 4:
        _grid_solves(mesh, n_devices, A, b, solved, out)
    return {"solves": out, "launches": launches.read()}


def _grid_solves(mesh, n_devices, A, b, solved, out) -> None:
    """The 2 × (n/2) grid's CG, AMG-CG, CG-IR and block CG."""
    from lsbench_tpu_torch.parallel.dist2d import (DistributedBlockCg2d,
                                                   DistributedCg2d)
    from lsbench_tpu_torch.parallel.dist_amg2d import DistributedAmgCg2d
    from lsbench_tpu_torch.parallel.dist_cg_ir import DistributedCgIr2d
    from lsbench_tpu_torch.parallel.mesh import as_grid
    from lsbench_tpu_torch.solvers.base import to_numpy

    grid = as_grid(mesh, 2, n_devices // 2)
    solved("cg 2d", DistributedCg2d(A, grid, rtol=1e-10,
                                    local_spmv="bsr").solve(b), 1e-8)
    solved("amg_cg 2d", DistributedAmgCg2d(A, grid, rtol=1e-8, coarse_n=16,
                                           max_levels=3).solve(b), 1e-7)
    solved("cg_ir 2d", DistributedCgIr2d(A, grid, rtol=1e-8,
                                         local_spmv="bsr").solve(b), 1e-8)
    rng = np.random.default_rng(1)
    B = np.column_stack([b, rng.standard_normal(A.nrows)])
    res = DistributedBlockCg2d(A, grid, nrhs=2, rtol=1e-6).solve(B)
    X = to_numpy(res.x)
    worst = max(np.linalg.norm(B[:, j] - A.matvec(X[:, j]))
                / np.linalg.norm(B[:, j]) for j in range(2))
    _check(worst < 1e-4, ("block_cg 2d k=2", res.iters, worst))
    out["block_cg 2d k=2"] = (int(res.iters), float(worst))


def run_dryrun(n_devices: int, platform: str = "cuda",
               timeout: float = 300) -> dict:
    """Every distributed solve on n ranks (`run_ranks`); raises
    RuntimeError with the rank's traceback if a solve misses its bar.
    Returns rank 0's {"solves": {name: (iters, host relres)}, "launches":
    its kernel launch counts}."""
    return run_ranks(n_devices, _dryrun_rank, n_devices, platform=platform,
                     timeout=timeout)[0]


def dryrun_multichip(n_devices: int, platform: str = "cuda") -> dict:
    """The dry run on n ranks, after checking that `platform` has them:
    on `cuda` fewer cards than n raise ValueError("requested N devices,
    have M"), with no fall-back to the CPU."""
    check_devices(n_devices, platform)
    return run_dryrun(n_devices, platform)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lsbench_tpu_torch.parallel.dryrun",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    try:
        out = dryrun_multichip(args.n_devices, args.platform)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    for name, (iters, rel) in out["solves"].items():
        print(f"{name}: iters={iters} relres={rel:.3e}")
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
