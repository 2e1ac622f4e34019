"""Host simulation of the `--solver ginkgo --nrhs k` refinement.

    python -m lsbench_tpu_torch.harness.sim_bicgstab [--grid 512] [--nrhs 8]

Runs the port's BiCGSTAB recurrence (`solvers/bicgstab.py`,
`batched_bicgstab_loop`, with its shadow restart) in f32 on the CPU, with
scipy's f32 CSR product in place of the SpMM kernel and the f64 residual on the host,
on RCM poisson_2d(grid) with the CLI's `--nrhs` right-hand sides and the
defaults of `BatchedBicgstabSolver` (rtol 1e-4, inner rtol 1e-5, Jacobi, 6
passes). Prints each refinement pass's inner iterations and worst-column
relres, then the totals. It needs no card and little memory (the CSR
operator and a few (n, k) blocks), so it shows at the card's sizes how the
f32 recurrence converges; the card sums in another order, so its counts
differ.
"""

from __future__ import annotations

import argparse
import inspect
import sys

import numpy as np
import scipy.sparse as sp
import torch

from lsbench_tpu_torch.harness.bench import reference_rhs
from lsbench_tpu_torch.matrix.generate import poisson_2d
from lsbench_tpu_torch.ordering import get_ordering
from lsbench_tpu_torch.solvers.batched_bicgstab import BatchedBicgstabSolver
from lsbench_tpu_torch.solvers.bicgstab import batched_bicgstab_loop


def simulate(grid: int, nrhs: int, out=sys.stdout) -> dict:
    """Run the refinement; return {"iters", "passes", "relres"} (worst
    column) and print one line per pass to `out`."""
    defaults = {k: p.default for k, p in inspect.signature(
        BatchedBicgstabSolver).parameters.items()}
    rtol, max_refine = defaults["rtol"], defaults["max_refine"]
    inner_rtol = min(defaults["inner_rtol"], 0.1 * rtol)

    A = poisson_2d(grid)
    perm = get_ordering("rcm", A)
    Ap = A.permuted(perm)
    H = sp.csr_matrix((Ap.vals, Ap.cols, Ap.offs), shape=Ap.shape)
    H32 = H.astype(np.float32)
    dinv = torch.as_tensor(1.0 / Ap.diagonal(), dtype=torch.float32)

    def matmat(V):
        return torch.from_numpy(np.ascontiguousarray(H32 @ V.numpy()))

    B = reference_rhs(A.nrows, nrhs).reshape(A.nrows, nrhs)[perm]
    B = torch.as_tensor(B)
    bnorm2 = (B * B).sum(dim=0)
    X, R, rr = torch.zeros_like(B), B, bnorm2
    iters = passes = 0
    while passes < max_refine and bool((rr > rtol ** 2 * bnorm2).any()):
        scale = torch.sqrt(rr)
        D, it, _, _ = batched_bicgstab_loop(
            matmat, lambda V: dinv[:, None] * V, (R / scale).float(),
            inner_rtol, 10 * A.nrows, torch.float32)
        D = torch.where(torch.isfinite(D), D, 0.0)
        X = X + D.double() * scale
        R = B - torch.from_numpy(H @ X.numpy())
        rr = (R * R).sum(dim=0)
        iters += it
        passes += 1
        relres = float(torch.sqrt(rr / bnorm2).max())
        print(f"pass {passes}: inner iterations {it}, worst relres "
              f"{relres:.3e}", file=out)
    relres = float(torch.sqrt(rr / bnorm2).max())
    print(f"poisson_2d({grid}) RCM, nrhs {nrhs}: {iters} iterations, "
          f"{passes} of {max_refine} passes, worst relres {relres:.3e}",
          file=out)
    return {"iters": iters, "passes": passes, "relres": relres}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--nrhs", type=int, default=8)
    args = ap.parse_args(argv)
    simulate(args.grid, args.nrhs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
