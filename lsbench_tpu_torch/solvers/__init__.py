from lsbench_tpu_torch.solvers.base import (SolveResult, Solver, get_solver,
                                            list_solvers, register_solver)

# Importing solver modules registers them.
from lsbench_tpu_torch.solvers import cg  # noqa: F401
from lsbench_tpu_torch.solvers import bicgstab  # noqa: F401
from lsbench_tpu_torch.solvers import gmres  # noqa: F401
from lsbench_tpu_torch.solvers import refine  # noqa: F401
from lsbench_tpu_torch.solvers import direct  # noqa: F401
from lsbench_tpu_torch.solvers import sparse_cholesky  # noqa: F401
from lsbench_tpu_torch.solvers import band_cholesky  # noqa: F401
from lsbench_tpu_torch.solvers import amg  # noqa: F401
from lsbench_tpu_torch.solvers import batched_bicgstab  # noqa: F401
from lsbench_tpu_torch.solvers import block_cg  # noqa: F401
from lsbench_tpu_torch.solvers.base import register_alias

# The JAX package's presets (lsbench_tpu/solvers/__init__.py), unchanged.
# Ginkgo: BiCGSTAB + Jacobi, implicit resnorm ≤ 1e-4 × initial
# (ginkgo.cpp:55-64).
register_alias("ginkgo", "bicgstab", precond="jacobi", rtol=1e-4)
# CHOLMOD: ordering and factorization at setup, the timed solve is the
# triangular solves (cholmod-impl.h:25-26,44-63).
register_alias("cholmod", "cholesky", refactor_each_solve=False)
# cusolver csrlsvchol: factor and solve in every timed trial
# (cusparse.c:183-194).
register_alias("cusolver", "cholesky", refactor_each_solve=True)
# Hypre BoomerAMG: classical AMG, fixed 2 V-cycles (maxiter=2 tol=0,
# hypre.c:129,185-186), with the internals tuned on the reference workload:
# θ=0.5, direct interpolation improved by 3 damped (ω=0.5) Jacobi passes,
# truncated to 8/row, Chebyshev degree 3, V(2,2).
register_alias("hypre", "amg", cycles=2, coarsening="classical", theta=0.5,
               interp="jacobi", interp_passes=3, interp_omega=0.5, pmax=8,
               degree=3, pre_sweeps=2, post_sweeps=2)
# AmgX: CLASSICAL selector, 1 V-cycle (amgx.c:78-86), same internals.
register_alias("amgx", "amg", cycles=1, coarsening="classical", theta=0.5,
               interp="jacobi", interp_passes=3, interp_omega=0.5, pmax=8,
               degree=3, pre_sweeps=2, post_sweeps=2)
# parAlmond: one K-cycle application over smoothed pairwise aggregates
# (paralmond.cpp:118-140).
register_alias("paralmond", "amg", cycles=1, cycle="k",
               coarsening="sa_pairwise", degree=3,
               pre_sweeps=2, post_sweeps=2)

__all__ = ["SolveResult", "Solver", "get_solver", "list_solvers",
           "register_solver"]
