"""Command-line entry point (counterpart of `lsbench_tpu/harness/cli.py`):
the reference command-line surface, on PyTorch and one CUDA device.

Flags and defaults mirror `lsbench_init` (lsbench.c:84-135) as the JAX
package has them: `--matrix` (required), `--solver`, `--ordering`,
`--precision`, `--verbose`, `--trials` (default 100); an unknown solver
warns and falls back to the default (lsbench.c:31-33); an unknown ordering
warns and defaults to AMD (lsbench.c:47-49); fp16 is rejected with rc=1.
RHS convention r[i] = i (lsbench.c:158-160).

`--platform cuda` (the default) needs a CUDA device and exits 1 without
one: there is no silent CPU run. `--platform cpu` runs the kernels' plain
PyTorch versions. `--cache`/`--cache-dir` turn on the setup cache
(`harness/cache.py`), `--profile-dir` traces the timed loop and
`--roofline` reports the solver's SpMV against the card's HBM peak
(`harness/profile.py`), `--debug-nans` makes every kernel wrapper raise on a
NaN (`utils/debug.py`). `--devices N` runs the row-partitioned solver of
the JAX CLI's mapping on N ranks (`parallel/`): this process is rank 0 and
the others are spawned; on `--platform cuda` each rank takes one card and
the group is NCCL, on `--platform cpu` the ranks are gloo processes;
the AMG family (`amg`, `hypre`, `amgx`, `paralmond`, `--precond amg*`)
runs the row-partitioned cycle (`parallel/dist_amg.py`). `--mesh RxC` lays
the N ranks on an R × C grid (`parallel/dist2d.py`, `dist_amg2d.py`).
`--coordinator HOST:PORT --num-processes P --process-id i` joins P
processes started apart, on one host or several (`parallel/mesh.py
init_distributed`). With `--devices N` the N global ranks are split
evenly: process i runs L = N/P of them, global ranks i·L .. i·L + L − 1
(itself the first, the others spawned), on its own cards 0..L−1, and the
ranks meet through a TCPStore at the coordinator. The JAX CLI's mesh
spans the first N global devices instead, whatever each process holds;
here N must be a multiple of P, else the run exits 1. Every process
prints the record, as every JAX process does: x is gathered on every
rank, so the records agree. Without `--devices`, `--coordinator` only
validates and records the process, and each process runs the
single-device solve, as in the JAX CLI.
A layout, preconditioner or solve schedule that is not ported yet exits 1
with a message, and nothing else is substituted for it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from lsbench_tpu_torch.harness.bench import (BenchRecord, reference_rhs,
                                             run_bench)
from lsbench_tpu_torch.matrix.io import MatrixFormatError, read_matrix
from lsbench_tpu_torch.parallel.mesh import (GROUP_TIMEOUT_S, check_devices,
                                             distributed_process,
                                             init_distributed, make_mesh_2d,
                                             make_row_mesh)
from lsbench_tpu_torch.solvers.base import get_solver, list_solvers

ORDERINGS = ("none", "rcm", "amd", "metis")

PRECISION_DTYPES = {
    "fp64": "float64",
    "fp32": "float32",
    "fp32_ir": "mixed",  # f32 inner solve + f64 iterative refinement
}


# The reference defaults to its CHOLMOD backend (CMakeLists.txt:5): here the
# `cholmod` alias of the direct Cholesky solver.
DEFAULT_SOLVER = "cholmod"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lsbench-torch",
        description="Sparse linear-solver benchmark harness (PyTorch/CUDA)",
    )
    p.add_argument("--matrix", required=True, help="matrix text file (nnz base header + COO triplets)")
    p.add_argument("--solver", default=None,
                   help=f"one of: {', '.join(list_solvers())}")
    p.add_argument("--ordering", default="none", help="none | rcm | amd | metis")
    p.add_argument("--precision", default="fp64",
                   help="fp64 | fp32 | fp32_ir (fp16 rejected)")
    p.add_argument("--verbose", type=int, nargs="?", const=1, default=0)
    p.add_argument("--trials", type=int, default=100)
    p.add_argument("--warmups", type=int, default=2, help="untimed warmup solves")
    p.add_argument("--rtol", type=float, default=None, help="override solver residual tolerance")
    p.add_argument("--maxiter", type=int, default=None)
    p.add_argument("--precond", default=None,
                   help="override preconditioner "
                        "(none|jacobi|block_jacobi|chebyshev|amg|"
                        "amg_classical|ic0)")
    p.add_argument("--nrhs", type=int, default=1,
                   help="solve this many right-hand sides at once (cg "
                        "family routes to block_cg, bicgstab/ginkgo to "
                        "batched_bicgstab, the Cholesky family solves all "
                        "columns together; column 0 is the reference RHS "
                        "r[i]=i, extras are seeded random)")
    p.add_argument("--json", action="store_true", help="emit a JSON record after the CSV line")
    p.add_argument("--platform", default="cuda",
                   help="cuda (default; exits 1 without a CUDA device) | "
                        "cpu (the kernels' plain PyTorch versions)")
    p.add_argument("--opt", action="append", default=[], metavar="KEY=VALUE",
                   help="extra solver parameter (repeatable)")
    p.add_argument("--roofline", action="store_true",
                   help="report the solver's SpMV against the card's HBM "
                        "peak (L2-cold device time per application)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler chrome trace of the timed "
                        "loop into this directory")
    p.add_argument("--cache", action="store_true",
                   help="cache setup products (orderings, sparse Cholesky "
                        "factors, AMG hierarchies) keyed by matrix hash")
    p.add_argument("--cache-dir", default=None,
                   help="setup cache directory (implies --cache; default "
                        "$LSBENCH_CACHE_DIR or ~/.cache/lsbench_tpu_torch)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError on a NaN out of any "
                        "kernel wrapper (the sanitizer role; syncs each "
                        "call)")
    p.add_argument("--devices", type=int, default=None,
                   help="solve on N ranks over a block-row partition (one "
                        "card each on cuda, gloo processes on cpu)")
    p.add_argument("--mesh", default=None, metavar="RxC",
                   help="2-D rank grid for --devices runs, e.g. 2x2 "
                        "(cg/cg_ir/bicgstab/ginkgo/gmres fp32_ir, --nrhs k "
                        "block CG, --precond amg: all_gather over the grid "
                        "column, reduce-scatter over the grid row)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process: where process 0's first rank "
                        "serves the store the ranks meet through; with "
                        "--devices N each of the processes runs N/P of "
                        "the N ranks")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process: the number of processes (omit "
                        "with --process-id to read WORLD_SIZE and RANK)")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-process: this process's id")
    return p


def _resolve_solver_name(name: str | None) -> str:
    if name is None:
        return DEFAULT_SOLVER
    try:
        get_solver(name)
        return name.lower()
    except KeyError:
        # Reference behavior: warn and default (lsbench.c:31-33).
        print(f"Invalid solver: \"{name}\". Defaulting to {DEFAULT_SOLVER}.",
              file=sys.stderr)
        return DEFAULT_SOLVER


def _resolve_ordering(name: str) -> str:
    if name.lower() in ORDERINGS:
        return name.lower()
    # Reference behavior: warn and default to AMD (lsbench.c:47-49).
    print(f"Invalid ordering: \"{name}\". Defaulting to AMD.", file=sys.stderr)
    return "amd"


def _parse_opt_value(v: str):
    """KEY=VALUE values: int, float, bool, or string."""
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


@dataclass
class _Prepared:
    """What every rank of a run needs, resolved from the command line."""
    A: object
    b: np.ndarray
    solver_name: str
    cls: type
    params: dict
    ordering: str
    precision: str
    platform: str
    dist: tuple | None  # (class, kwargs, grid or None): the distributed solver


def _prepare(args) -> _Prepared | int:
    """Validate the command line, read the matrix and resolve the solver;
    an int is the exit code of a refusal (its message printed)."""
    precision = args.precision.lower()
    if precision not in PRECISION_DTYPES:
        print(f"Precision '{args.precision}' is not implemented "
              f"(supported: {', '.join(PRECISION_DTYPES)}).", file=sys.stderr)
        return 1
    platform = args.platform.lower()
    if platform not in ("cuda", "cpu"):
        print(f"Unsupported platform '{args.platform}' (cuda | cpu).",
              file=sys.stderr)
        return 1
    if platform == "cuda" and not torch.cuda.is_available():
        print("--platform cuda: no CUDA device is available (use "
              "--platform cpu to run the plain PyTorch versions).",
              file=sys.stderr)
        return 1
    if args.coordinator:
        try:
            pid = init_distributed(args.coordinator, args.num_processes,
                                   args.process_id)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        nproc = distributed_process().num_processes
        if args.devices is not None and args.devices % nproc:
            print(f"--devices {args.devices} is not a multiple of the "
                  f"{nproc} processes: each process runs --devices / "
                  "--num-processes ranks", file=sys.stderr)
            return 1
        if args.verbose >= 1:
            print(f"distributed: process {pid}/{nproc}, "
                  f"{args.devices or nproc} global devices", file=sys.stderr)
    if args.devices is not None:
        try:
            check_devices(_local_ranks(args)[1], platform)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
    device = torch.device(platform)

    solver_name = _resolve_solver_name(args.solver)
    ordering = _resolve_ordering(args.ordering)

    if args.cache or args.cache_dir:
        from lsbench_tpu_torch.harness import cache
        cache.enable(True)
        if args.cache_dir:
            cache.set_cache_dir(args.cache_dir)
    if args.debug_nans:
        from lsbench_tpu_torch.utils.debug import enable_debug_nans
        enable_debug_nans(True)

    try:
        A = read_matrix(args.matrix)
    except FileNotFoundError:
        # Reference: err(EXIT_FAILURE, "Unable to open file ...") lsbench-csr.c:32
        print(f"Unable to open file \"{args.matrix}\" for reading.", file=sys.stderr)
        return 1
    except MatrixFormatError as e:
        print(str(e), file=sys.stderr)
        return 1
    if args.verbose >= 1:
        print(f"matrix {args.matrix}: n={A.nrows} nnz={A.nnz} "
              f"({A.nnz / A.nrows:.1f} nnz/row)", file=sys.stderr)

    b = reference_rhs(A.nrows, max(args.nrhs, 1))
    if args.nrhs > 1:
        # Routed by the resolved solver (ginkgo is judged as bicgstab).
        resolved_cls, _ = get_solver(solver_name)
        if resolved_cls.name in ("cg", "cg_ir"):
            solver_name = "block_cg"
            if precision == "fp64":
                print("nrhs: cg with multiple RHS runs as block_cg "
                      "(f32 SpMM inner + f64 refinement, mode "
                      "fp32_ir).", file=sys.stderr)
        elif resolved_cls.name == "bicgstab":
            # k independent BiCGSTAB recurrences batched on one SpMM per
            # half-step (block CG would share a Krylov space across
            # unrelated RHS).
            solver_name = "batched_bicgstab"
            print("nrhs: bicgstab/ginkgo with multiple RHS runs as "
                  "batched BiCGSTAB (f32 SpMM inner + f64 refinement, "
                  "mode fp32_ir).", file=sys.stderr)
        elif resolved_cls.name not in ("block_cg", "batched_bicgstab",
                                       "cholesky", "cholesky_ir"):
            print(f"--nrhs > 1 is implemented for the cg family "
                  f"(block_cg), bicgstab/ginkgo (batched BiCGSTAB), and "
                  f"the Cholesky family (cholmod/cusolver/cholesky_ir: "
                  f"one product or two triangular solves for all columns "
                  f"per refinement pass); got '{solver_name}' (for gmres "
                  f"run one RHS per solve).",
                  file=sys.stderr)
            return 1

    cls, params = get_solver(solver_name)
    if precision == "fp32_ir":
        # Remap the resolved target (so alias presets such as ginkgo's
        # rtol=1e-4/jacobi survive) onto its iterative-refinement twin.
        ir_map = {"cg": "cg_ir", "cholesky": "cholesky_ir",
                  "gmres": "gmres_ir", "bicgstab": "bicgstab_ir"}
        target = ir_map.get(cls.name, cls.name)
        if target not in ("block_cg", "batched_bicgstab") \
                and not target.endswith("_ir"):
            # AMG (amg, hypre, amgx, paralmond) runs its fp64 converge
            # mode as f32 cycles + f64 refinement already; block_cg and
            # batched_bicgstab are their own IR form.
            print(f"Precision 'fp32_ir' is only implemented for the cg, "
                  f"cholesky, gmres, and bicgstab solver families (got "
                  f"'{solver_name}').",
                  file=sys.stderr)
            return 1
        cls, _ = get_solver(target)
        if solver_name in ir_map:
            solver_name = target
        params["dtype"] = "mixed"
    else:
        params["dtype"] = PRECISION_DTYPES[precision]
    params["ordering"] = ordering
    params["device"] = device
    if args.rtol is not None:
        params["rtol"] = args.rtol
    if args.maxiter is not None:
        params["maxiter"] = args.maxiter
    if args.precond is not None:
        params["precond"] = args.precond
    for kv in args.opt:
        if "=" not in kv:
            print(f"--opt expects KEY=VALUE, got '{kv}'", file=sys.stderr)
            return 1
        k, v = kv.split("=", 1)
        params[k] = _parse_opt_value(v)

    dist_solver = None
    if args.devices is not None:
        dist_solver = _make_distributed(solver_name, args, params)
        if dist_solver is None:
            return 1
    return _Prepared(A=A, b=b, solver_name=solver_name, cls=cls,
                     params=params, ordering=ordering, precision=precision,
                     platform=platform, dist=dist_solver)


def _make_distributed(solver_name: str, args, params):
    """Map a solver name onto its partitioned implementation, as the JAX
    CLI's `_make_distributed` does (lsbench_tpu/harness/cli.py:357-519):
    (class, keyword arguments, grid shape (pr, pc) or None for the row
    partition), or None with the refusal printed."""
    from lsbench_tpu_torch.parallel import (dist_amg, dist_bicgstab,
                                            dist_block_cg, dist_cg,
                                            dist_cg_ir, dist_gmres)

    kw = {}
    if args.rtol is not None:
        kw["rtol"] = args.rtol
    if args.maxiter is not None:
        kw["maxiter"] = args.maxiter
    dtype = params.get("dtype", "float64")
    mixed = dtype == "mixed"
    classical = dict(coarsening="classical", theta=0.5, interp="jacobi",
                     interp_passes=3, interp_omega=0.5, pmax=8)

    if args.mesh:
        if solver_name not in ("cg", "cg_ir", "bicgstab", "bicgstab_ir",
                               "ginkgo", "gmres", "gmres_ir", "block_cg"):
            print("--mesh RxC supports cg/gmres/bicgstab/ginkgo "
                  "(point/none or amg preconditioning) and multi-RHS "
                  "block_cg.", file=sys.stderr)
            return None
        from lsbench_tpu_torch.parallel import dist2d
        try:
            pr, pc = (int(t) for t in args.mesh.lower().split("x"))
        except ValueError:
            print(f"--mesh expects RxC (e.g. 2x4), got '{args.mesh}'",
                  file=sys.stderr)
            return None
        if pr * pc != args.devices:
            print(f"--mesh {args.mesh} needs {pr*pc} devices but "
                  f"--devices={args.devices}", file=sys.stderr)
            return None
        grid = (pr, pc)
        if "local_spmv" in params:
            kw["local_spmv"] = params["local_spmv"]
        kw["ordering"] = params.get("ordering", "none")
        if solver_name == "block_cg":
            kw.setdefault("rtol", 1e-10)
            return (dist2d.DistributedBlockCg2d,
                    dict(kw, nrhs=max(args.nrhs, 1)), grid)
        if (solver_name in ("cg", "cg_ir")
                and args.precond in ("amg", "amg_classical")):
            from lsbench_tpu_torch.parallel.dist_amg2d import \
                DistributedAmgCg2d
            kw.pop("local_spmv", None)  # the hierarchy is ELL on 2-D only
            if args.precond == "amg_classical":
                kw.update(classical)
            for k in ("coarsening", "theta", "interp", "interp_passes",
                      "interp_omega", "pmax", "smoother", "degree",
                      "pre_sweeps", "post_sweeps", "coarse_n"):
                if k in params:
                    kw[k] = params[k]
            return DistributedAmgCg2d, dict(kw, dtype=dtype), grid
        if mixed or solver_name.endswith("_ir"):
            if solver_name in ("bicgstab", "bicgstab_ir", "ginkgo"):
                kw.setdefault("rtol",
                              1e-4 if solver_name == "ginkgo" else 1e-10)
                return dist_cg_ir.DistributedBicgstabIr2d, kw, grid
            kw.setdefault("rtol", 1e-10)
            if solver_name in ("gmres", "gmres_ir"):
                if "restart" in params:
                    kw["restart"] = params["restart"]
                return dist_cg_ir.DistributedGmresIr2d, kw, grid
            return dist_cg_ir.DistributedCgIr2d, kw, grid
        if solver_name in ("gmres", "gmres_ir"):
            print("--mesh RxC gmres runs as fp32_ir (the f64 Arnoldi has "
                  "no 2-D path; use --precision fp32_ir).", file=sys.stderr)
            return None
        if solver_name in ("bicgstab", "ginkgo"):
            if solver_name == "ginkgo":
                kw.setdefault("rtol", 1e-4)  # ginkgo.cpp:61
            return dist2d.DistributedBicgstab2d, dict(kw, dtype=dtype), grid
        return dist2d.DistributedCg2d, dict(kw, dtype=dtype), grid

    if solver_name in ("amg", "hypre", "amgx", "paralmond"):
        # The alias presets pass through, "cycles" and "cycle" included:
        # `--solver hypre --devices N` builds the single-device alias's
        # hierarchy, `paralmond` runs the K-cycle over the ranks.
        for k in ("cycles", "cycle", "coarsening", "theta", "interp",
                  "interp_passes", "interp_omega", "pmax", "smoother",
                  "degree", "pre_sweeps", "post_sweeps"):
            if k in params:
                kw[k] = params[k]
        return dist_amg.DistributedAmg, dict(kw, dtype=dtype), None
    if solver_name in ("cg", "cg_ir") and args.precond in ("amg",
                                                           "amg_classical"):
        if args.precond == "amg_classical":
            kw.update(classical)
        if solver_name == "cg_ir" or mixed:
            # f32 AMG-CG inner solves + f64 refinement: the 1e-10 AMG
            # route over the ranks.
            kw.setdefault("rtol", 1e-10)
            return dist_amg.DistributedAmgCgIr, kw, None
        return dist_amg.DistributedAmgCg, dict(kw, dtype=dtype), None
    kw["ordering"] = params.get("ordering", "none")
    # Distributed --opt knobs (the AMG branches forward their own).
    for k in ("local_spmv", "strategy", "inner_rtol", "max_refine",
              "row_align", "precond", "block_size", "restart"):
        if k in params:
            kw[k] = params[k]
    if solver_name in ("bicgstab", "ginkgo", "bicgstab_ir"):
        if solver_name == "ginkgo":
            kw.setdefault("rtol", 1e-4)  # ginkgo.cpp:61
        if mixed or solver_name == "bicgstab_ir":
            return dist_cg_ir.DistributedBicgstabIr, kw, None
        return dist_bicgstab.DistributedBicgstab, dict(kw, dtype=dtype), None
    if solver_name == "cg_ir" or (solver_name == "cg" and mixed):
        kw.setdefault("rtol", 1e-10)
        return dist_cg_ir.DistributedCgIr, kw, None
    if solver_name == "cg":
        return dist_cg.DistributedCg, dict(kw, dtype=dtype), None
    if solver_name in ("gmres", "gmres_ir"):
        if mixed or solver_name == "gmres_ir":
            kw.setdefault("rtol", 1e-10)
            return dist_cg_ir.DistributedGmresIr, kw, None
        return dist_gmres.DistributedGmres, dict(kw, dtype=dtype), None
    if solver_name == "block_cg":
        kw.setdefault("rtol", 1e-10)
        return (dist_block_cg.DistributedBlockCg,
                dict(kw, nrhs=max(args.nrhs, 1)), None)
    print(f"solver '{solver_name}' has no distributed implementation "
          "(distributed: cg, cg_ir, block_cg, gmres, gmres_ir, bicgstab, "
          "bicgstab_ir, ginkgo, amg, hypre, amgx, paralmond; all Krylov "
          "families accept --precision fp32_ir).", file=sys.stderr)
    return None


def _local_ranks(args) -> tuple[int, int]:
    """(global rank of this process's first rank, ranks this process
    runs) of `--devices N`: all N on one host, N/P for each of the P
    processes of a `--coordinator` group."""
    if not args.coordinator:
        return 0, args.devices
    info = distributed_process()
    local = args.devices // info.num_processes
    return info.process_id * local, local


def _run(args, prep: _Prepared, ranks: tuple | None = None) -> int:
    """Set up the solver, run the timed trials and print the record. With
    `ranks` = (n, rank, local_rank, init_file) this process is global
    rank `rank` of a group of n, the `local_rank`-th of its process: it
    builds its shard of the distributed solver, runs the same
    (collective) trials as every rank, and prints only as its process's
    first rank. The ranks meet through the FileStore `init_file`, or at
    `--coordinator`."""
    # Device (and group) initialization outside the setup timer,
    # attributed on its own.
    t0 = time.perf_counter()
    mesh = None
    if ranks is not None:
        n, rank, local, init_file = ranks
        grid = prep.dist[2]
        meet = (init_file, prep.platform, args.coordinator, local)
        mesh = (make_row_mesh(n, rank, *meet) if grid is None else
                make_mesh_2d(*grid, rank, *meet))
        device = mesh.device
    else:
        device = torch.device(prep.platform)
    try:
        torch.empty(0, device=device)
        backend_init_s = time.perf_counter() - t0
        return _bench_and_report(args, prep, device, mesh, backend_init_s)
    finally:
        if mesh is not None:
            mesh.close()


def _bench_and_report(args, prep: _Prepared, device, mesh,
                      backend_init_s: float) -> int:
    A, b = prep.A, prep.b
    report = mesh is None or mesh.local_rank == 0
    t0 = time.perf_counter()
    try:
        if mesh is not None:
            dist_cls, kw, _ = prep.dist
            solver = dist_cls(A, mesh, **kw)
        else:
            solver = prep.cls(A, **prep.params)
    except (NotImplementedError, ValueError) as e:
        if mesh is None and isinstance(e, ValueError):
            raise
        # A shard that cannot be built is refused on every rank alike.
        if report:
            print(str(e), file=sys.stderr)
        return 1
    setup_s = time.perf_counter() - t0

    bench = dict(trials=args.trials, warmups=args.warmups,
                 matrix_name=args.matrix, ordering=prep.ordering,
                 precision=prep.precision, setup_s=setup_s)
    if args.profile_dir and report:
        from lsbench_tpu_torch.harness.profile import trace
        with trace(args.profile_dir, device):
            rec = run_bench(solver, b, **bench)
    else:
        rec = run_bench(solver, b, **bench)
    if not report:
        return 0
    # Report under the reference's original solver name for comparability.
    rec.solver = prep.solver_name
    rec.extra["backend_init_s"] = backend_init_s
    rec.extra["device"] = (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")

    if args.roofline:
        op = solver.matvec_op()
        if op is None:
            print("roofline: solver has no streaming SpMV", file=sys.stderr)
        else:
            from lsbench_tpu_torch.harness.profile import spmv_roofline
            mv, nnz, stream, x_dtype = op
            x0 = torch.as_tensor(
                np.random.default_rng(0).random(solver.A.ncols),
                dtype=x_dtype, device=device)
            rec.extra["roofline"] = spmv_roofline(mv, x0, nnz, stream)

    print(BenchRecord.CSV_HEADER)
    print(rec.csv_line())
    if args.json or args.verbose >= 1:
        print(json.dumps(rec.to_json()))
    return 0


def _run_ranks(argv: list, args, prep: _Prepared) -> int:
    """`--devices N`: this process is the first of its ranks (global rank
    0 without `--coordinator`); its other ranks are spawned processes that
    run the same command line (`parallel/launch.py`). The exit code is
    nonzero if any of them failed."""
    from lsbench_tpu_torch.parallel import launch

    n = args.devices
    offset, local = _local_ranks(args)
    threads = torch.get_num_threads()
    with (contextlib.nullcontext() if args.coordinator
          else launch.rendezvous()) as init_file:
        procs = launch.spawn_cli_ranks(argv, n, init_file, offset, local)
        rc = 1
        try:
            # The ranks share the host's cores (and spin while they wait).
            torch.set_num_threads(launch.threads_per_rank(local))
            rc = _run(args, prep, (n, offset, 0, init_file))
        finally:
            torch.set_num_threads(threads)
            # A rank that failed leaves the others waiting in a collective
            # until the group's timeout: stop them at once.
            codes = launch.stop(procs, GROUP_TIMEOUT_S + 30 if rc == 0
                                else 0)
    failed = [(offset + r + 1, c) for r, c in enumerate(codes) if c != 0]
    for rank, code in failed:
        print(f"--devices {n}: rank {rank} "
              + ("did not finish" if code is None else f"exited {code}"),
              file=sys.stderr)
    return rc or (1 if failed else 0)


def run_rank(argv: list, rank: int, local_rank: int, n: int,
             init_file: str | None) -> int:
    """Global rank `rank` of `--devices n`, the `local_rank`-th (≥ 1) of
    its process: the command line as the process's first rank ran it
    (which printed its messages), in the group of `init_file` or of
    `--coordinator`."""
    args = build_parser().parse_args(argv)
    with contextlib.redirect_stderr(io.StringIO()):
        prep = _prepare(args)
    if isinstance(prep, int):
        return prep
    return _run(args, prep, (n, rank, local_rank, init_file))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    prep = _prepare(args)
    if isinstance(prep, int):
        return prep
    if args.devices is None:
        return _run(args, prep)
    return _run_ranks(argv, args, prep)


if __name__ == "__main__":
    sys.exit(main())
