"""AMG-preconditioned CG on the 2-D grid (counterpart of
`lsbench_tpu/parallel/dist_amg2d.py`).

Every hierarchy operator (A_l, P_l, R_l) is a rectangular 2-D-partitioned
matrix applied with the fine level's schedule (`dist2d.py`): an all_gather
over the grid column, the local gather-ELL product, one reduce-scatter
over the grid row. A level-l vector lives in P = pr·pc chunks of csize_l
entries; P_l maps level-(l+1) chunks to level-l chunks (csize_r = csize_l,
csize_c = csize_{l+1}), R_l the reverse. The smoothers are diagonal and
add no collective; the coarsest system is solved on every rank from a
replicated dense Cholesky factor after one all_gather over all ranks. The
local products stay gather-ELL, as the JAX CLI runs this class ("the
hierarchy is ELL-on-2-D only"); the SELL kernels run the 2-D Krylov
classes' operators.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.parallel.dist2d import build_2d_plan, spmv_2d_local
from lsbench_tpu_torch.parallel.dist_amg import (_pad_size, coarse_factor,
                                                 make_dist_cycle,
                                                 replicated_coarse_solve)
from lsbench_tpu_torch.parallel.dist_cg import dist_cg_loop
from lsbench_tpu_torch.parallel.dist_spmv import RowShard
from lsbench_tpu_torch.parallel.mesh import GridMesh
from lsbench_tpu_torch.parallel.perm import resolve_dist_ordering
from lsbench_tpu_torch.solvers.amg import AmgOptions, build_matrix_hierarchy
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, true_relres
from lsbench_tpu_torch.solvers.cg import as_dtype


class DistributedAmgCg2d(Solver):
    """AMG-preconditioned CG over a (rows × cols) grid: one V-cycle per
    iteration as M⁻¹ inside the fused-reduction CG."""

    name = "dist_amg_cg2d"

    def __init__(self, A: CsrMatrix, mesh: GridMesh, dtype=torch.float64,
                 rtol=1e-8, maxiter=None, theta=None, coarsening="sa",
                 smoother="chebyshev", degree=2, interp="direct",
                 interp_passes=1, interp_omega=1.0, pmax=4,
                 pre_sweeps=1, post_sweeps=1, coarse_n=64, max_levels=12,
                 jacobi_scale=4.0 / 3.0, cheby_lower=0.30,
                 ordering="rcm", **params):
        super().__init__(A, **params)
        if not isinstance(mesh, GridMesh):
            raise ValueError("DistributedAmgCg2d needs a (rows, cols) grid "
                             "mesh (mesh.make_mesh_2d), got a row mesh")
        self.mesh = mesh
        self.dtype = dt = as_dtype(dtype)
        self.rtol = float(rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))
        pr, pc = mesh.pr, mesh.pc
        P_ = pr * pc
        self.n = A.nrows

        t0 = time.perf_counter()
        Ap, self._ord = resolve_dist_ordering(A, ordering)
        self.setup_breakdown["ordering_s"] = time.perf_counter() - t0
        opts = AmgOptions(theta=theta, coarsening=coarsening,
                          smoother=smoother, degree=degree, interp=interp,
                          interp_passes=interp_passes,
                          interp_omega=interp_omega, pmax=pmax,
                          pre_sweeps=pre_sweeps, post_sweeps=post_sweeps,
                          coarse_n=coarse_n, max_levels=max_levels,
                          jacobi_scale=jacobi_scale, cheby_lower=cheby_lower,
                          reorder_coarse=True)
        self.opts = opts
        t0 = time.perf_counter()
        mats, Acoarse = build_matrix_hierarchy(
            Ap, opts, breakdown=self.setup_breakdown, device=mesh.device)
        self.setup_breakdown["hierarchy_s"] = time.perf_counter() - t0
        self.n_levels = len(mats) + 1
        self.rhos = [float(m["rho"]) for m in mats]

        t0 = time.perf_counter()
        sizes = [m["A"].nrows for m in mats] + [Acoarse.nrows]
        pads = [_pad_size(s, P_) for s in sizes]
        csizes = [p // P_ for p in pads]
        self.n_pad, self.pads, self.csizes = pads[0], pads, csizes
        dev, i, j, c = mesh.device, mesh.i, mesh.j, mesh.rank

        def op(M, cs_r, cs_c):
            plan = build_2d_plan(M, pr, pc, dt, csize_r=cs_r, csize_c=cs_c)
            vals = plan.vals[i, j].to(dev)
            cols = plan.cols[i, j].to(device=dev, dtype=torch.int64)
            return lambda x_l: spmv_2d_local(mesh, vals, cols, x_l)

        levels = []
        for lvl, m in enumerate(mats):
            cs, cs_next = csizes[lvl], csizes[lvl + 1]
            dinv = np.zeros(pads[lvl])
            dinv[: sizes[lvl]] = m["dinv"]
            levels.append(dict(
                a=op(m["A"], cs, cs), p=op(m["P"], cs, cs_next),
                r=op(m["R"], cs_next, cs),
                dinv=torch.as_tensor(dinv[c * cs: (c + 1) * cs], dtype=dt,
                                     device=dev),
                rho=self.rhos[lvl]))
        Lc = coarse_factor(Acoarse, pads[-1], dt, dev)
        self._cycle = make_dist_cycle(
            mesh, levels, opts,
            replicated_coarse_solve(mesh, Lc, csizes[-1]))
        self._fine_mv = (levels[0]["a"] if levels
                         else op(Ap, csizes[0], csizes[0]))
        self._rows = RowShard(mesh, self.n, csizes[0], self._ord)
        self.setup_breakdown["layout_s"] = time.perf_counter() - t0

    def _run(self, b):
        cycle = self._cycle
        return dist_cg_loop(self.mesh, self._fine_mv,
                            lambda r: cycle(r, torch.zeros_like(r)),
                            self._rows.local(b, self.dtype), self.rtol,
                            self.maxiter)

    def solve(self, b) -> SolveResult:
        x_l, iters, rr, bb = self._run(b)
        relres = float(torch.sqrt(rr / torch.where(bb > 0, bb, 1.0)))
        x = self._rows.gather(x_l)
        true_rel = true_relres(self.A, x, b)
        return SolveResult(x=x, iters=int(iters), relres=relres,
                           converged=true_rel <= self.rtol,
                           extra={"levels": self.n_levels,
                                  "mesh": (self.mesh.pr, self.mesh.pc),
                                  "local_spmv": "ell",
                                  "true_relres": true_rel})

    def solve_fn(self):
        return lambda b: self._run(b)[0]
