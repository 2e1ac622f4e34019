from lsbench_tpu_torch.solvers.base import (SolveResult, Solver, get_solver,
                                            list_solvers, register_solver)

# Importing solver modules registers them. The reference backend aliases
# (ginkgo, cholmod, cusolver, hypre, amgx, paralmond) register with their
# target solvers as those are ported (ROADMAP.md Queue 1).
from lsbench_tpu_torch.solvers import cg  # noqa: F401
from lsbench_tpu_torch.solvers import refine  # noqa: F401

__all__ = ["SolveResult", "Solver", "get_solver", "list_solvers",
           "register_solver"]
