"""lsbench_tpu_torch — the PyTorch/CUDA port of lsbench_tpu.

A sparse linear-solver library and benchmark harness for one NVIDIA H100:
the reference's COO matrices are read into a host CSR, reordered (RCM),
laid out as 8×128 block-sparse rows, and solved by CG or by mixed-precision
CG with f64 iterative refinement, whose SpMVs are hand-written CUDA kernels
(`csrc/bsr_spmv.cu`). Modules mirror `lsbench_tpu/` one for one; this
package imports neither jax nor `lsbench_tpu`, holds no global dtype or
device state, and takes the device explicitly at every layout constructor
and solver.
"""

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.io import read_matrix
from lsbench_tpu_torch.solvers.base import SolveResult, get_solver, list_solvers

__version__ = "0.1.0"

__all__ = ["CsrMatrix", "read_matrix", "SolveResult", "get_solver",
           "list_solvers"]
