"""Distributed AMG: the row-partitioned V- and K-cycle (counterpart of
`lsbench_tpu/parallel/dist_amg.py`).

- The host builds the single-device hierarchy (`solvers/amg.py
  build_matrix_hierarchy`, SA or classical coarsening) of the RCM-ordered
  matrix, with every coarse level renumbered by RCM and aligned to the
  fine positions, so that every level's operators stay banded.
- Every level's A, P and R are row-partitioned over the ranks, each level
  padded to its own multiple of 8 rows per rank (`_pad_size`); vectors are
  row-partitioned per level. Each operator application moves the H
  boundary rows of its source vector to the neighbours (`dist_spmv.py`:
  `build_halo_plan` for A, `build_rect_halo_plan` for P and R, whose row
  and source blocks differ); an operator whose reach exceeds one
  neighbour block gathers the whole source vector (`fetch_global`) and
  keeps global column ids. The choice is made per operator and recorded
  (`_halos`, `_p_halos`, `_r_halos`, the JAX package's fields).
- Level 0's A runs the SELL kernels on the rank's block after the halo
  exchange, where the JAX package runs its Pallas BSR kernels inside
  `shard_map`: `spmv_sell` (f32, K1) or `spmv_sell_f64` (f64, K2), the
  port's rule wherever the level-0 halo plan builds, on the CPU their
  plain versions. Coarse levels, P and R are gather-ELL products, as in
  the JAX package.
- Padding rows carry a zero inverse diagonal and zero rows of P and R.
  The coarsest system is solved on every rank from a replicated dense
  Cholesky factor padded with identity rows, after one all_gather.
- The Jacobi and Chebyshev smoothers need no reductions; the K-cycle's
  coarse correction (the parAlmond role) adds two FCG steps with fused
  all_reduces at every level. Every rank takes the same branches: they
  depend only on the level and on all-reduced values.

`DistributedAmg` is the standalone solver (the hypre/AmgX fixed-cycle
protocol, or converge mode), `DistributedAmgCg` the cycle as the
preconditioner of the distributed CG, `DistributedAmgCgIr` f32 AMG-CG
inner solves with the f64 refinement of `dist_cg_ir.py`. The JAX package
runs each as one `shard_map` program with device-side loops; here each
stop test reads one all-reduced scalar on the host (device-side loops are
later work).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.parallel.dist_cg import dist_cg_loop
from lsbench_tpu_torch.parallel.dist_cg_ir import dist_refine_loop
from lsbench_tpu_torch.parallel.dist_spmv import (RowShard, _round_up,
                                                  build_dist_matvec,
                                                  build_halo_plan,
                                                  build_halo_sell_plan,
                                                  build_rect_halo_plan,
                                                  fused_psum,
                                                  halo_spmv_local,
                                                  halo_spmv_sell_f64_local,
                                                  halo_spmv_sell_local)
from lsbench_tpu_torch.parallel.mesh import RowMesh, fetch_global
from lsbench_tpu_torch.parallel.perm import resolve_dist_ordering
from lsbench_tpu_torch.solvers.amg import (AmgOptions,
                                           build_matrix_hierarchy,
                                           coarse_cholesky)
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, true_relres
from lsbench_tpu_torch.solvers.cg import as_dtype
from lsbench_tpu_torch.utils.precision import full_f32


def _pad_size(n: int, n_dev: int, align: int = 8) -> int:
    return _round_up(max(1, -(-n // n_dev)), align) * n_dev


def _ell_padded(M: CsrMatrix, n_pad: int, dtype):
    """Row-padded ELL arrays (n_pad, k) with global column ids; padding
    rows and slots hold value 0 (column 0)."""
    counts = np.diff(M.offs)
    k = max(int(counts.max(initial=0)), 1)
    vals = np.zeros((n_pad, k))
    cols = np.zeros((n_pad, k), dtype=np.int32)
    rows_idx = M.row_indices()
    slot = np.arange(M.nnz) - M.offs[rows_idx]
    vals[rows_idx, slot] = M.vals
    cols[rows_idx, slot] = M.cols
    return torch.as_tensor(vals).to(dtype), torch.as_tensor(cols)


def coarse_factor(Acoarse: CsrMatrix, n_pad: int, dtype, device):
    """The replicated dense Cholesky factor of the coarsest operator
    (`solvers/amg.py::coarse_cholesky`), padded to n_pad with identity
    rows."""
    n = Acoarse.nrows
    Lc = torch.eye(n_pad, dtype=dtype)
    Lc[:n, :n] = coarse_cholesky(Acoarse, dtype, "cpu")
    return Lc.to(device)


def replicated_coarse_solve(mesh: RowMesh, Lc: torch.Tensor, nloc: int):
    """The coarse solve on the rank's rows: one all_gather of the
    right-hand side (global rank order is vector order, on the row mesh
    and on the grid alike), two triangular solves on every rank, and the
    rank's slice."""
    lo = mesh.rank * nloc

    def solve(b_l):
        bf = fetch_global(mesh, b_l, Lc.shape[0])
        y = torch.linalg.solve_triangular(Lc, bf[:, None], upper=False)
        x = torch.linalg.solve_triangular(Lc.mT, y, upper=True)
        return x[lo: lo + nloc, 0]
    return solve


def make_dist_cycle(mesh: RowMesh, levels: list, opts: AmgOptions,
                    coarse_solve):
    """cycle(b_l, x_l) → x_l: one V- or K-cycle on this rank's rows. Each
    entry of `levels` holds the level's operator applications "a", "r"
    and "p" (collective calls on local blocks), its local inverse
    diagonal "dinv" and its spectral bound "rho". The smoothers and the
    K-cycle's coefficients are the JAX package's."""
    nlev = len(levels)

    def jacobi(L, b_l, x_l):
        om = opts.jacobi_scale / L["rho"]
        for _ in range(opts.degree):
            x_l = x_l + om * L["dinv"] * (b_l - L["a"](x_l))
        return x_l

    def chebyshev(L, b_l, x_l):
        lmax = 1.1 * L["rho"]
        lmin = opts.cheby_lower * L["rho"]
        theta = (lmax + lmin) / 2.0
        delta = (lmax - lmin) / 2.0
        sigma = theta / delta
        rho_k = 1.0 / sigma
        r = b_l - L["a"](x_l)
        d = (L["dinv"] * r) / theta
        for _ in range(opts.degree - 1):
            x_l = x_l + d
            r = r - L["a"](d)
            rho_k1 = 1.0 / (2.0 * sigma - rho_k)
            d = (rho_k1 * rho_k) * d + (2.0 * rho_k1 / delta) * (
                L["dinv"] * r)
            rho_k = rho_k1
        return x_l + d

    # The JAX package's rule: Chebyshev, or else Jacobi.
    smooth = chebyshev if opts.smoother == "chebyshev" else jacobi

    def coarse_correct(lvl: int, rc_l):
        """One recursive cycle (V), or two FCG steps preconditioned by the
        cycle (K-cycle, Notay; the parAlmond role, paralmond.cpp:118-140),
        whose inner products are fused all_reduces at every level."""
        if lvl == nlev:
            return coarse_solve(rc_l)
        if opts.cycle == "v":
            return cycle(lvl, rc_l, torch.zeros_like(rc_l))
        A = levels[lvl]["a"]
        eps = 1e-30
        u = cycle(lvl, rc_l, torch.zeros_like(rc_l))
        v = A(u)
        rho1, alpha1 = fused_psum(mesh, torch.dot(u, v), torch.dot(u, rc_l))
        rho1 = rho1 + eps
        rt = rc_l - (alpha1 / rho1) * v
        w = cycle(lvl, rt, torch.zeros_like(rt))
        z = A(w)
        gamma, wz, alpha2 = fused_psum(mesh, torch.dot(v, w),
                                       torch.dot(w, z), torch.dot(w, rt))
        rho2 = wz - gamma * gamma / rho1 + eps
        return ((alpha1 / rho1 - gamma * alpha2 / (rho1 * rho2)) * u
                + (alpha2 / rho2) * w)

    def cycle(lvl: int, b_l, x_l):
        if lvl == nlev:
            return coarse_solve(b_l)
        L = levels[lvl]
        for _ in range(opts.pre_sweeps):
            x_l = smooth(L, b_l, x_l)
        r_l = b_l - L["a"](x_l)
        ec_l = coarse_correct(lvl + 1, L["r"](r_l))
        x_l = x_l + L["p"](ec_l)
        for _ in range(opts.post_sweeps):
            x_l = smooth(L, b_l, x_l)
        return x_l

    def run(b_l, x_l):
        with full_f32():  # the coarse solves and dots out of TF32
            return cycle(0, b_l, x_l)
    return run


def _ell_apply(mesh: RowMesh, vals, cols, halo, n_src_pad):
    """The gather-ELL application of a local block: after a halo exchange
    of the source vector, or on the whole gathered source vector."""
    if halo is not None:
        return lambda x_l: halo_spmv_local(mesh, halo, vals, cols, x_l)

    def apply(x_l):
        full = fetch_global(mesh, x_l, n_src_pad)
        return torch.sum(vals * full[cols], dim=1)
    return apply


class _DistAmgBase(Solver):
    """Shared setup: the row-partitioned hierarchy on this rank and its
    cycle (`self._cycle`, `self._fine_mv`)."""

    def __init__(self, A: CsrMatrix, mesh: RowMesh, dtype=torch.float64,
                 theta=None, coarsening="sa", smoother="chebyshev", degree=2,
                 interp="direct", interp_passes=1, interp_omega=1.0, pmax=4,
                 pre_sweeps=1, post_sweeps=1, coarse_n=64, cycle="v",
                 max_levels=12, jacobi_scale=4.0 / 3.0, cheby_lower=0.30,
                 ordering="rcm", comm="auto", local_spmv="auto", **params):
        super().__init__(A, **params)
        self.mesh = mesh
        self.dtype = dt = as_dtype(dtype)
        self.n = A.nrows
        n_dev = self.n_dev = mesh.size
        if comm not in ("auto", "halo", "all_gather"):
            raise ValueError(f"unknown comm '{comm}' "
                             "(auto | halo | all_gather)")
        if local_spmv not in ("auto", "bsr", "ell"):
            raise ValueError(f"unknown local_spmv '{local_spmv}' "
                             "(auto | bsr | ell)")

        # RCM of the fine level and of every coarse level keeps every
        # operator banded, so the smoother matvecs can use the O(halo)
        # exchange instead of the O(n) all_gather.
        t0 = time.perf_counter()
        Ap, self._ord = resolve_dist_ordering(A, ordering)
        self.setup_breakdown["ordering_s"] = time.perf_counter() - t0
        self._Ap = Ap  # the permuted operator (for the f64 residual)
        opts = AmgOptions(theta=theta, coarsening=coarsening, cycle=cycle,
                          smoother=smoother, degree=degree, interp=interp,
                          interp_passes=interp_passes,
                          interp_omega=interp_omega, pmax=pmax,
                          pre_sweeps=pre_sweeps, post_sweeps=post_sweeps,
                          coarse_n=coarse_n, max_levels=max_levels,
                          jacobi_scale=jacobi_scale, cheby_lower=cheby_lower,
                          reorder_coarse=(comm != "all_gather"))
        self.opts = opts
        t0 = time.perf_counter()
        mats, Acoarse = build_matrix_hierarchy(
            Ap, opts, breakdown=self.setup_breakdown, device=mesh.device)
        self.setup_breakdown["hierarchy_s"] = time.perf_counter() - t0
        self.n_levels = len(mats) + 1
        self.comm = comm

        t0 = time.perf_counter()
        sizes = [m["A"].nrows for m in mats] + [Acoarse.nrows]
        pads = [_pad_size(s, n_dev) for s in sizes]
        self.n_pad, self.pads = pads[0], pads
        self.rhos = [float(m["rho"]) for m in mats]
        dev, rank = mesh.device, mesh.rank
        want_sell = local_spmv != "ell"

        def local(t, nloc):  # this rank's rows of a host array, on dev
            return t[rank * nloc: (rank + 1) * nloc].to(dev)

        self._fine_sell = None  # level 0's SELL plan when it engages
        self._halos = []    # per level: A's halo width, or None
        self._p_halos = []  # per level: P's halo, or None (all_gather)
        self._r_halos = []  # per level: R's halo, or None
        levels = []
        for lvl, m in enumerate(mats):
            npf, npc = pads[lvl], pads[lvl + 1]
            nlf, nlc = npf // n_dev, npc // n_dev
            halo = None
            if comm in ("auto", "halo"):
                plan = build_halo_plan(m["A"], n_dev, dt)
                if not plan.needs_all_gather:
                    halo, av, ac = plan.halo, plan.vals, plan.cols
            if halo is None:
                av, ac = _ell_padded(m["A"], npf, dt)
            self._halos.append(halo)
            if lvl == 0 and want_sell and halo is not None:
                sp = build_halo_sell_plan(m["A"], n_dev, rank, (dt,),
                                          device=dev)
                self._fine_sell = sp
                if dt == torch.float64:
                    def a_apply(x_l, sp=sp):
                        return halo_spmv_sell_f64_local(mesh, sp, x_l)
                else:
                    def a_apply(x_l, sp=sp):
                        return halo_spmv_sell_local(mesh, sp, x_l).to(dt)
            else:
                a_apply = _ell_apply(mesh, local(av, nlf),
                                     local(ac, nlf).long(), halo, npf)
            # The transfers: rectangular halo plans (fine and coarse
            # blocks differ); R reads the fine vector, P the coarse one.
            p_halo = r_halo = None
            if comm in ("auto", "halo"):
                pp = build_rect_halo_plan(m["P"], n_dev, nlf, nlc, dt)
                if not pp.needs_all_gather:
                    p_halo, pv, pcols = pp.halo, pp.vals, pp.cols
                rp = build_rect_halo_plan(m["R"], n_dev, nlc, nlf, dt)
                if not rp.needs_all_gather:
                    r_halo, rv, rcols = rp.halo, rp.vals, rp.cols
            if p_halo is None:
                pv, pcols = _ell_padded(m["P"], npf, dt)
            if r_halo is None:
                rv, rcols = _ell_padded(m["R"], npc, dt)
            self._p_halos.append(p_halo)
            self._r_halos.append(r_halo)
            dinv = np.zeros(npf)
            dinv[: sizes[lvl]] = m["dinv"]
            levels.append(dict(
                a=a_apply,
                p=_ell_apply(mesh, local(pv, nlf), local(pcols, nlf).long(),
                             p_halo, npc),
                r=_ell_apply(mesh, local(rv, nlc), local(rcols, nlc).long(),
                             r_halo, npf),
                dinv=local(torch.as_tensor(dinv, dtype=dt), nlf),
                rho=self.rhos[lvl]))
        self.local_spmv = "bsr" if self._fine_sell is not None else "ell"

        # Coarsest: the replicated dense factor padded with identity rows.
        Lc = coarse_factor(Acoarse, pads[-1], dt, dev)
        self._cycle = make_dist_cycle(
            mesh, levels, opts,
            replicated_coarse_solve(mesh, Lc, pads[-1] // n_dev))
        if levels:
            self._fine_mv = levels[0]["a"]
        else:  # the matrix is its own coarsest level
            self._fine_mv = build_dist_matvec(Ap, mesh, dt).matvec
        self._rows = RowShard(mesh, self.n, pads[0] // n_dev, self._ord)
        self.setup_breakdown["layout_s"] = time.perf_counter() - t0

    def _extra(self) -> dict:
        return {"levels": self.n_levels, "n_devices": self.n_dev,
                "local_spmv": self.local_spmv,
                "halos": {"A": self._halos, "P": self._p_halos,
                          "R": self._r_halos}}


class DistributedAmg(_DistAmgBase):
    """Standalone distributed AMG: the fixed-cycle protocol (hypre
    maxiter=k tol=0, AmgX, parAlmond; `converged` means the protocol
    completed) or converge-to-rtol mode, judged on the host f64 true
    residual."""

    name = "dist_amg"

    def __init__(self, A: CsrMatrix, mesh: RowMesh, cycles=None, rtol=1e-8,
                 maxiter=100, **kw):
        super().__init__(A, mesh, **kw)
        self.cycles = int(cycles) if cycles is not None else None
        self.rtol = float(rtol)
        self.maxiter = int(maxiter)

    def _run(self, b):
        mesh, cycle, fine = self.mesh, self._cycle, self._fine_mv
        b_l = self._rows.local(b, self.dtype)
        (bb,) = fused_psum(mesh, torch.dot(b_l, b_l))
        x_l = torch.zeros_like(b_l)
        if self.cycles is not None:
            for _ in range(self.cycles):
                x_l = cycle(b_l, x_l)
            r_l = b_l - fine(x_l)
            (rr,) = fused_psum(mesh, torch.dot(r_l, r_l))
            return x_l, rr, bb, self.cycles
        tol2 = (self.rtol ** 2) * bb
        rr, it = bb, 0
        while it < self.maxiter and bool(rr > tol2):
            x_l = cycle(b_l, x_l)
            r_l = b_l - fine(x_l)
            (rr,) = fused_psum(mesh, torch.dot(r_l, r_l))
            it += 1
        return x_l, rr, bb, it

    def solve(self, b) -> SolveResult:
        x_l, rr, bb, iters = self._run(b)
        rnorm, bnorm = float(torch.sqrt(rr)), float(torch.sqrt(bb))
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        x = self._rows.gather(x_l)
        extra = self._extra()
        if self.cycles is not None:
            # Fixed-cycle protocol (hypre tol=0): the residual is data.
            conv = True
        else:
            # Converge mode: the host f64 TRUE residual decides.
            true_rel = true_relres(self.A, x, b)
            extra["true_relres"] = true_rel
            conv = true_rel <= self.rtol
        return SolveResult(x=x, iters=int(iters), relres=relres,
                           converged=conv, extra=extra)

    def solve_fn(self):
        return lambda b: self._run(b)[0]


class DistributedAmgCg(_DistAmgBase):
    """AMG-preconditioned CG over the row partition: one cycle per
    iteration as M⁻¹ inside the fused-reduction CG of `dist_cg.py`."""

    name = "dist_amg_cg"

    def __init__(self, A: CsrMatrix, mesh: RowMesh, rtol=1e-8, maxiter=None,
                 **kw):
        super().__init__(A, mesh, **kw)
        self.rtol = float(rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))

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
                           extra={**self._extra(), "true_relres": true_rel})

    def solve_fn(self):
        return lambda b: self._run(b)[0]


class DistributedAmgCgIr(_DistAmgBase):
    """Mixed-precision distributed AMG-CG: f32 AMG-CG inner solves (the f32
    cycle, level 0 on the SELL f32 kernel) and the f64 refinement of
    `dist_cg_ir.py`, its residual through the SELL f64 kernel on the
    1-D operator (`build_dist_matvec`). The f32 cycle's recursive residual
    departs from the true one far above 1e-10; the refinement reaches the
    reference's direct tolerance."""

    name = "dist_amg_cg_ir"

    def __init__(self, A: CsrMatrix, mesh: RowMesh, rtol=1e-10,
                 inner_rtol=1e-5, maxiter=None, max_refine=6, **kw):
        kw["dtype"] = torch.float32  # the cycle is f32 by construction
        super().__init__(A, mesh, **kw)
        self.rtol = float(rtol)
        self.inner_rtol = float(inner_rtol)
        self.maxiter = (int(maxiter) if maxiter is not None
                        else max(10 * A.nrows, 1000))
        self.max_refine = int(max_refine)
        # The f64 operator's partition must be the hierarchy's level 0:
        # both pad to multiples of 8 rows per rank.
        dm64 = build_dist_matvec(self._Ap, mesh, torch.float64, row_align=8)
        if dm64.n_pad != self.n_pad:
            raise AssertionError(f"f64 operator pads to {dm64.n_pad} rows, "
                                 f"the hierarchy to {self.n_pad}")
        self._mv64 = dm64.matvec

    def _inner(self, rhs32):
        cycle = self._cycle
        x, it, _, _ = dist_cg_loop(self.mesh, self._fine_mv,
                                   lambda r: cycle(r, torch.zeros_like(r)),
                                   rhs32, self.inner_rtol, self.maxiter)
        return x, it

    def _run(self, b):
        return dist_refine_loop(self.mesh, self._rows.local(b, torch.float64),
                                self.rtol, self.max_refine, self._inner,
                                self._mv64)

    def solve(self, b) -> SolveResult:
        x_l, rr, bb, iters, passes = self._run(b)
        rnorm, bnorm = float(torch.sqrt(rr)), float(torch.sqrt(bb))
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        x = self._rows.gather(x_l)
        true_rel = true_relres(self.A, x, b)
        return SolveResult(x=x, iters=int(iters), relres=relres,
                           converged=true_rel <= self.rtol or bnorm == 0.0,
                           extra={"refine_passes": passes, **self._extra(),
                                  "true_relres": true_rel,
                                  "precision_mode": "fp32_ir_auto"})

    def solve_fn(self):
        return lambda b: self._run(b)[0]
