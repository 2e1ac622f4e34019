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
PyTorch versions. Flags whose machinery is not ported yet exit 1 with a
message; a layout, preconditioner or solve schedule that is not ported yet
does too, and nothing else is substituted for it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from lsbench_tpu_torch.harness.bench import (BenchRecord, reference_rhs,
                                             run_bench)
from lsbench_tpu_torch.matrix.io import MatrixFormatError, read_matrix
from lsbench_tpu_torch.solvers.base import get_solver, list_solvers

ORDERINGS = ("none", "rcm", "amd", "metis")

PRECISION_DTYPES = {
    "fp64": "float64",
    "fp32": "float32",
    "fp32_ir": "mixed",  # f32 inner solve + f64 iterative refinement
}

# Flags of the JAX CLI whose machinery is not ported yet (ROADMAP.md).
_NOT_PORTED = (("devices", "--devices"), ("mesh", "--mesh"),
               ("roofline", "--roofline"), ("profile_dir", "--profile-dir"),
               ("cache", "--cache"), ("cache_dir", "--cache-dir"),
               ("coordinator", "--coordinator"),
               ("debug_nans", "--debug-nans"))
# Solvers of the JAX package's registry that are not ported yet: refused,
# where an unknown name would fall back to the default solver. None.
_NOT_PORTED_SOLVERS = ()


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
    # Accepted so reference command lines parse; not ported yet.
    p.add_argument("--roofline", action="store_true", help="not yet ported")
    p.add_argument("--profile-dir", default=None, help="not yet ported")
    p.add_argument("--cache", action="store_true", help="not yet ported")
    p.add_argument("--cache-dir", default=None, help="not yet ported")
    p.add_argument("--devices", type=int, default=None, help="not yet ported")
    p.add_argument("--mesh", default=None, metavar="RxC", help="not yet ported")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="not yet ported")
    p.add_argument("--num-processes", type=int, default=None,
                   help="with --coordinator (not yet ported)")
    p.add_argument("--process-id", type=int, default=None,
                   help="with --coordinator (not yet ported)")
    p.add_argument("--debug-nans", action="store_true", help="not yet ported")
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    precision = args.precision.lower()
    if precision not in PRECISION_DTYPES:
        print(f"Precision '{args.precision}' is not implemented "
              f"(supported: {', '.join(PRECISION_DTYPES)}).", file=sys.stderr)
        return 1
    for attr, flag in _NOT_PORTED:
        if getattr(args, attr):
            print(f"{flag} is not yet ported to lsbench_tpu_torch "
                  "(see ROADMAP.md).", file=sys.stderr)
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
    device = torch.device(platform)

    if args.solver is not None and args.solver.lower() in _NOT_PORTED_SOLVERS:
        print(f"solver '{args.solver}' is not yet ported to "
              "lsbench_tpu_torch (see ROADMAP.md).", file=sys.stderr)
        return 1
    solver_name = _resolve_solver_name(args.solver)
    ordering = _resolve_ordering(args.ordering)

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

    # Device initialization outside the setup timer, attributed on its own.
    t0 = time.perf_counter()
    torch.empty(0, device=device)
    backend_init_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    try:
        solver = cls(A, **params)
    except NotImplementedError as e:
        print(str(e), file=sys.stderr)
        return 1
    setup_s = time.perf_counter() - t0

    rec = run_bench(solver, b, trials=args.trials, warmups=args.warmups,
                    matrix_name=args.matrix, ordering=ordering,
                    precision=precision, setup_s=setup_s)
    # Report under the reference's original solver name for comparability.
    rec.solver = solver_name
    rec.extra["backend_init_s"] = backend_init_s
    rec.extra["device"] = (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")

    print(BenchRecord.CSV_HEADER)
    print(rec.csv_line())
    if args.json or args.verbose >= 1:
        print(json.dumps(rec.to_json()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
