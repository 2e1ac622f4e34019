"""Algebraic multigrid — the Hypre BoomerAMG / AmgX / parAlmond role
(counterpart of `lsbench_tpu/solvers/amg.py`).

Setup runs on the host in NumPy, line for line the JAX package's, so both
packages build the same hierarchy bit for bit: strength, aggregation or
classical coarsening (`solvers/classical_amg.py`), prolongator smoothing,
Galerkin RAP (`ops/spgemm.py`), the coarse alignment. `build_hierarchy`
then picks each operator's device layout with the JAX package's cost model
and constants, unchanged: window-ELL (kernel K4, `ops/interp_well.py`) for
banded narrow operators where it wins, dense for tiny coarse levels, and
otherwise (where the JAX package takes uniform or class-padded BSR, K1 or
K5) the sliced-ELL f32 kernel (`ops/spmv_sell.py`). The cycle is eager
PyTorch over those
operators: V or K cycles; Chebyshev, Jacobi, ℓ1-Jacobi or hybrid ℓ1-GS
smoothing; a dense Cholesky solve on the coarsest level.

Precision takes the JAX package's TPU branch on every device: fp64
fixed-cycle runs the cycles in f32 (`fp32_cycles_auto`), fp64 converge
mode runs f32 V-cycles with the f64 residual on the sliced-ELL f64 product
(`fp32_ir_auto`), which takes K2's place. On the JAX package's non-TPU
branch the hierarchy would be f64, where window-ELL refuses to build and
every level would run on the f64 product.

The hierarchy cache (`--cache`) and its device re-setup
(`HierarchyRefresher`, `ops/spgemm_device.py`) are not ported.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from lsbench_tpu_torch.matrix.bsr import BC, BR, GPS
from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ops.interp_well import TR, WindowEll, spmv_well
from lsbench_tpu_torch.ops.spgemm import rap, spgemm
from lsbench_tpu_torch.ordering.rcm import rcm_ordering
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu_torch.solvers.cg import (as_dtype, build_matvec, full_f32,
                                          permutation, resolve_layout)
from lsbench_tpu_torch.solvers.refine import f64_residual_matvec


# --------------------------------------------------------------- host setup

def strength_graph(A: CsrMatrix, theta: float) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric strength: keep off-diag (i,j) with
    |a_ij| >= theta * sqrt(|a_ii a_jj|). Returns (offs, cols) adjacency."""
    r, c, v = A.to_coo()
    d = np.abs(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    off = r != c
    strong = off & (np.abs(v) >= theta * np.sqrt(d[r] * d[c]))
    if not strong.any():
        return np.zeros(A.nrows + 1, dtype=np.int64), np.zeros(0, dtype=np.int32)
    G = CsrMatrix.from_coo(r[strong], c[strong], np.ones(strong.sum()),
                           nrows=A.nrows, ncols=A.nrows, sum_duplicates=False)
    return G.offs, G.cols


def aggregate(A: CsrMatrix, theta: float) -> tuple[np.ndarray, int]:
    """Greedy distance-1 aggregation on the strength graph → (agg_id per
    node, n_aggregates). Isolated nodes become singletons."""
    n = A.nrows
    offs, cols = strength_graph(A, theta)
    agg = np.full(n, -1, dtype=np.int64)
    nagg = 0
    # Pass 1: roots whose strong neighborhood is fully unaggregated.
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = cols[offs[i]:offs[i + 1]]
        if (agg[nbrs] >= 0).any():
            continue
        agg[i] = nagg
        agg[nbrs] = nagg
        nagg += 1
    # Pass 2: attach leftovers to an adjacent aggregate.
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = cols[offs[i]:offs[i + 1]]
        assigned = nbrs[agg[nbrs] >= 0]
        if assigned.size:
            agg[i] = agg[assigned[0]]
    # Pass 3: remaining isolated nodes → singletons.
    for i in range(n):
        if agg[i] < 0:
            agg[i] = nagg
            nagg += 1
    return agg, nagg


def pairwise_aggregate(A: CsrMatrix, npass: int = 2,
                       beta: float = 0.25) -> tuple[np.ndarray, int]:
    """Notay-style (double) pairwise aggregation (AGMG; the aggregation
    behind parAlmond-class K-cycle AMG): each pass matches every
    unaggregated node with its strongest negative coupling among
    unaggregated neighbours (|a_ij| ≥ beta · max negative coupling), so
    `npass=2` gives aggregates of ≤ 4 nodes."""
    n = A.nrows
    Ac = A
    cur = np.arange(n, dtype=np.int64)  # node -> current coarse id
    for _ in range(npass):
        m = Ac.nrows
        r, c, v = Ac.to_coo()
        d = Ac.diagonal()
        sign = np.where(d >= 0, 1.0, -1.0)
        neg = (r != c) & (v * sign[r] < 0)
        w = np.where(neg, -v * sign[r], 0.0)
        rowmax = np.zeros(m)
        np.maximum.at(rowmax, r, w)

        # Greedy matching, visiting rows by ascending number of strong
        # neighbours (Notay's priority: constrained nodes first).
        strong = neg & (w >= beta * rowmax[r]) & (w > 0)
        sr, sc, sw = r[strong], c[strong], w[strong]
        deg = np.bincount(sr, minlength=m)
        order = np.argsort(deg, kind="stable")
        sidx = np.argsort(sr, kind="stable")
        sr_s, sc_s, sw_s = sr[sidx], sc[sidx], sw[sidx]
        start = np.searchsorted(sr_s, np.arange(m + 1))

        mate = np.full(m, -1, dtype=np.int64)
        for i in order:
            if mate[i] >= 0:
                continue
            lo, hi = start[i], start[i + 1]
            if lo == hi:
                mate[i] = i  # singleton
                continue
            cands = sc_s[lo:hi]
            free = mate[cands] < 0
            if not free.any():
                mate[i] = i
                continue
            j = cands[free][np.argmax(sw_s[lo:hi][free])]
            mate[i] = j
            mate[j] = i

        rep = np.minimum(np.arange(m), mate)
        uniq, cmap = np.unique(rep, return_inverse=True)
        cur = cmap[cur]
        # Coarse operator for the next pass (piecewise-constant Galerkin).
        P = CsrMatrix.from_coo(np.arange(m), cmap, np.ones(m),
                               nrows=m, ncols=uniq.size,
                               sum_duplicates=False)
        Ac = rap(P.transpose(), Ac, P)

    return cur, Ac.nrows


def tentative_prolongator(agg: np.ndarray, nagg: int,
                          nullspace: np.ndarray | None = None) -> CsrMatrix:
    """Piecewise-constant P from the near-nullspace vector (default: the
    constant vector), normalized per aggregate."""
    n = agg.size
    ns = np.ones(n) if nullspace is None else np.asarray(nullspace, np.float64)
    norms = np.zeros(nagg)
    np.add.at(norms, agg, ns * ns)
    norms = np.sqrt(np.where(norms > 0, norms, 1.0))
    vals = ns / norms[agg]
    return CsrMatrix.from_coo(np.arange(n), agg, vals, nrows=n, ncols=nagg,
                              sum_duplicates=False)


def smooth_prolongator(A: CsrMatrix, T: CsrMatrix, omega_scale: float = 4.0 / 3.0
                       ) -> CsrMatrix:
    """P = (I - ω D⁻¹ A) T with ω = omega_scale / ρ(D⁻¹A) (power estimate),
    the classic smoothed-aggregation damping."""
    dinv = 1.0 / np.where(A.diagonal() != 0, A.diagonal(), 1.0)
    rho = estimate_rho_dinv_a(A, dinv)
    omega = omega_scale / max(rho, 1e-30)
    AT = spgemm(A, T)
    r1, c1, v1 = T.to_coo()
    r2, c2, v2 = AT.to_coo()
    return CsrMatrix.from_coo(
        np.concatenate([r1, r2]), np.concatenate([c1, c2]),
        np.concatenate([v1, -omega * dinv[r2] * v2]),
        nrows=T.nrows, ncols=T.ncols)


def estimate_rho_dinv_a(A: CsrMatrix, dinv: np.ndarray, iters: int = 12) -> float:
    """Power iteration for ρ(D⁻¹A) on the host."""
    rng = np.random.default_rng(0)
    x = rng.random(A.nrows) + 0.1
    rho = 1.0
    for _ in range(iters):
        y = dinv * A.matvec(x)
        nrm = np.linalg.norm(y)
        if nrm == 0:
            return 1.0
        rho = nrm / np.linalg.norm(x)
        x = y / nrm
    return float(rho)


@dataclass
class AmgOptions:
    """The JAX package's options, same names and defaults (see
    `lsbench_tpu/solvers/amg.py::AmgOptions` for each one's reference)."""

    cycle: str = "v"             # "v" or "k" (Notay K-cycle, parAlmond)
    coarsening: str = "sa"       # "sa", "pairwise", "sa_pairwise", "classical"
    theta: float | None = None   # strong threshold; None → 0.08 SA, 0.25 classical
    interp: str = "direct"       # classical: "direct", "jacobi" or "ext+i"
    strength: str = "classical"  # classical strength: "classical" or "abs"
    interp_passes: int = 1       # Jacobi-improvement passes (interp="jacobi")
    interp_omega: float = 1.0    # damping of those passes
    pmax: int = 4                # interpolation truncation (entries/row)
    smoother: str = "chebyshev"  # "chebyshev", "jacobi", "l1_jacobi", "l1_gs"
    degree: int = 2              # Chebyshev degree / Jacobi sweeps
    jacobi_scale: float = 4.0 / 3.0  # ω = scale / ρ(D⁻¹A)
    cheby_lower: float = 0.30    # λmin = lower·ρ
    pre_sweeps: int = 1
    post_sweeps: int = 1
    max_levels: int = 12
    coarse_n: int = 128          # direct-solve size
    min_coarsen_ratio: float = 0.9  # stop if n_coarse > ratio * n
    reorder_coarse: bool = False  # RCM-renumber each coarse level
    align_coarse: bool = True    # anchor coarse numbering to fine position
    dense_level_bytes: int = 8 << 20  # dense matvec for levels at most this


def _coarsen_level(Al: CsrMatrix, opts: AmgOptions, level: int
                   ) -> tuple[CsrMatrix | None, int]:
    """One coarsening step → (P, n_coarse); P=None means stop."""
    if opts.coarsening == "classical":
        from lsbench_tpu_torch.solvers.classical_amg import classical_coarsen
        theta = 0.25 if opts.theta is None else opts.theta
        return classical_coarsen(Al, theta, seed=level, interp=opts.interp,
                                 strength=opts.strength, pmax=opts.pmax,
                                 interp_passes=opts.interp_passes,
                                 interp_omega=opts.interp_omega)
    if opts.coarsening in ("pairwise", "sa_pairwise"):
        beta = 0.25 if opts.theta is None else opts.theta
        agg, nagg = pairwise_aggregate(Al, npass=2, beta=beta)
        if nagg == 0:
            return None, 0
        T = tentative_prolongator(agg, nagg)
        if opts.coarsening == "sa_pairwise":
            return smooth_prolongator(Al, T), nagg
        return T, nagg
    theta = 0.08 if opts.theta is None else opts.theta
    agg, nagg = aggregate(Al, theta)
    if nagg == 0:
        return None, 0
    T = tentative_prolongator(agg, nagg)
    return smooth_prolongator(Al, T), nagg


def align_coarse_levels(mats, Acoarse):
    """Renumber every coarse level so coarse ids follow the mean fine
    position of their interpolatory sets (stable argsort over P's column
    supports). With a banded fine operator this keeps every coarse operator
    banded and oriented like the finer level, which keeps the window-ELL
    windows narrow. Pure renumbering: rho unchanged, dinv permuted."""
    mats = [dict(m) for m in mats]
    for l in range(len(mats)):
        P = mats[l]["P"]
        pr, pc, pv = P.to_coo()
        nc = P.ncols
        pos_sum = np.zeros(nc)
        cnt = np.zeros(nc)
        np.add.at(pos_sum, pc, pr.astype(np.float64))
        np.add.at(cnt, pc, 1.0)
        order = np.argsort(pos_sum / np.maximum(cnt, 1.0), kind="stable")
        if np.array_equal(order, np.arange(nc)):
            continue
        rank = np.empty(nc, dtype=np.int64)
        rank[order] = np.arange(nc)
        P2 = CsrMatrix.from_coo(pr, rank[pc], pv, nrows=P.nrows, ncols=nc,
                                sum_duplicates=False)
        mats[l]["P"] = P2
        mats[l]["R"] = P2.transpose()
        if l + 1 < len(mats):
            nxt = mats[l + 1]
            nxt["A"] = nxt["A"].permuted(order)
            nxt["dinv"] = np.asarray(nxt["dinv"])[order]
            if "dinv_l1" in nxt:
                nxt["dinv_l1"] = np.asarray(nxt["dinv_l1"])[order]
            # The next level's P lives in level-(l+1) ROW coordinates.
            nr, ncc, nv = nxt["P"].to_coo()
            nxt["P"] = CsrMatrix.from_coo(rank[nr], ncc, nv,
                                          nrows=nxt["P"].nrows,
                                          ncols=nxt["P"].ncols,
                                          sum_duplicates=False)
            nxt["R"] = nxt["P"].transpose()
        else:
            Acoarse = Acoarse.permuted(order)
    return mats, Acoarse


def build_matrix_hierarchy(A: CsrMatrix, opts: AmgOptions):
    """Host coarsening loop → (level_mats, A_coarse). Each level entry is
    dict(A, P, R, dinv, dinv_l1, rho) in CSR; A_coarse is the final
    (direct-solve) operator. The JAX package's loop without its cache
    branches."""
    mats = []
    Al = A
    while (Al.nrows > opts.coarse_n and len(mats) < opts.max_levels):
        P, nagg = _coarsen_level(Al, opts, len(mats))
        if P is None or nagg >= opts.min_coarsen_ratio * Al.nrows:
            break
        if opts.reorder_coarse:
            # Renumber the coarse space by RCM of the coarse operator so
            # every level stays banded.
            Ac0 = rap(P.transpose(), Al, P)
            cperm = rcm_ordering(Ac0)
            cinv = np.empty_like(cperm)
            cinv[cperm] = np.arange(cperm.size)
            pr, pc, pv = P.to_coo()
            P = CsrMatrix.from_coo(pr, cinv[pc], pv, nrows=P.nrows,
                                   ncols=P.ncols, sum_duplicates=False)
        R = P.transpose()
        Ac = rap(R, Al, P)
        d = Al.diagonal()
        dinv = 1.0 / np.where(d != 0, d, 1.0)
        # ℓ1 diagonal d_i = a_ii + Σ_{j≠i}|a_ij| (hypre relax type 8).
        rl, cl_, vl = Al.to_coo()
        l1 = d.copy()
        offm = rl != cl_
        np.add.at(l1, rl[offm], np.abs(vl[offm]))
        dinv_l1 = 1.0 / np.where(l1 != 0, l1, 1.0)
        rho = estimate_rho_dinv_a(Al, dinv)
        mats.append(dict(A=Al, P=P, R=R, dinv=dinv, dinv_l1=dinv_l1,
                         rho=rho))
        Al = Ac
    if opts.align_coarse and mats:
        return align_coarse_levels(mats, Al)
    return mats, Al


def l1_gs_blocks(M: CsrMatrix, block: int = 128):
    """Host build of the hybrid ℓ1-GS per-block factors (hypre relax type
    8): exact GS within each 128-row tile, ℓ1-compensated Jacobi across.

    Returns (Lblk, d_l1): Lblk[k] = strictly-lower within-block part of A
    plus diag(d_l1) (padding rows get unit diagonal), d_l1 of length n. The
    symmetric sweep uses Lblkᵀ for the up-sweep (A is SPD)."""
    n = M.nrows
    nb = -(-n // block)
    r, c, v = M.to_coo()
    rb, cb = r // block, c // block
    d = M.diagonal()
    d_l1 = d.copy()
    off_block = rb != cb
    np.add.at(d_l1, r[off_block], np.abs(v[off_block]))
    d_l1 = np.where(d_l1 != 0, d_l1, 1.0)
    Lblk = np.zeros((nb, block, block))
    wl = (~off_block) & (c < r)           # within-block strict lower
    Lblk[rb[wl], r[wl] % block, c[wl] % block] = v[wl]
    rows = np.arange(nb * block)
    diag = np.ones(nb * block)
    diag[:n] = d_l1
    Lblk[rows // block, rows % block, rows % block] = diag
    return Lblk, d_l1


def coarse_cholesky(Al: CsrMatrix, dtype, device) -> torch.Tensor:
    """Dense factor of the coarsest operator (symmetrized), on the host."""
    dense = Al.to_dense()
    dense = (dense + dense.T) * 0.5
    L = np.linalg.cholesky(dense + 1e-30 * np.eye(Al.nrows))
    return torch.as_tensor(L, dtype=dtype, device=device)


def _bsr_bytes(M: CsrMatrix, itemsize: int = 4) -> int:
    """Streamed bytes of the padded-BSR layout without building it."""
    r, c, _ = M.to_coo()
    keys = (r // BR).astype(np.int64) * (1 << 32) + c // BC
    uq = np.unique(keys)
    groups = -(-M.nrows // BR)
    ng = -(-groups // GPS) * GPS
    cnt = np.bincount((uq >> 32).astype(np.int64), minlength=ng)
    return int(ng * max(int(cnt.max()), 1) * BR * BC * itemsize)


# ---------------------------------------------------------- device layouts

# The JAX package's cost model for window-ELL against BSR, with its v5e
# rates unchanged so that both packages choose the same layout per
# operator (recalibrating them for Hopper is ROADMAP work): the TPU
# window-ELL kernel is compare-bound at ~1.1e12 one-hot elements/s, the BSR
# kernel stream-bound at ~7e11 B/s on its padded stream.
WELL_EL_RATE = 1.1e12
BSR_STREAM_BPS = 7.0e11


def device_hierarchy(mats, Acoarse: CsrMatrix, opts: AmgOptions, dtype,
                     layout: str, device):
    """Device layouts of a host hierarchy → (level_params, level_aps,
    coarse_factor). `level_params[l]` holds the operators ("a", "p", "r")
    and inverse diagonals as tensors; `level_aps[l]` the apply functions,
    the spectral bound and the sizes."""
    itemsize = torch.empty(0, dtype=dtype).element_size()

    def per_level(M):
        # Dense only when far cheaper by bytes than the sparse stream
        # (degenerate near-dense coarse operators).
        if layout not in ("bsr", "bsr_xla"):
            return layout
        dense_bytes = M.nrows * M.ncols * itemsize
        if (dense_bytes <= opts.dense_level_bytes
                and dense_bytes * 4 < _bsr_bytes(M)):
            return "dense"
        return layout

    def _try_well(M, slack: float):
        """WindowEll for a banded narrow operator, or None: it must stream
        ≥4x fewer bytes than BSR and the apply model must predict ≤ slack x
        the BSR stream time (1.0 for smoother operators, 1.5 for the
        once-per-cycle transfers)."""
        lay = per_level(M)
        if lay not in ("bsr", "bsr_classed", "bsr_xla"):
            return None, lay
        op = WindowEll.from_csr(M, dtype=dtype, max_k=24, max_j=16,
                                device="cpu")
        if op is None:
            return None, lay
        bsr = _bsr_bytes(M)
        if op.bytes_streamed * 4 >= bsr:
            return None, lay
        t_well = op.n_pad * op.k_real * op.j_blocks * TR / WELL_EL_RATE
        if t_well > slack * (bsr / BSR_STREAM_BPS):
            return None, lay
        return op, lay

    def operator_matvec(M, slack: float):
        op, lay = _try_well(M, slack)
        if op is not None:
            return spmv_well, op.to(device)
        return build_matvec(M, lay, device, dtype=dtype)

    level_params, level_aps = [], []
    for m in mats:
        a_ap, a_op = operator_matvec(m["A"], slack=1.0)
        p_ap, p_op = operator_matvec(m["P"], slack=1.5)
        r_ap, r_op = operator_matvec(m["R"], slack=1.5)
        lp = dict(
            a=a_op, p=p_op, r=r_op,
            inv_diag=torch.as_tensor(m["dinv"], dtype=dtype, device=device),
            inv_l1=torch.as_tensor(m["dinv_l1"], dtype=dtype, device=device))
        if opts.smoother == "l1_gs":
            Lblk, d_l1 = l1_gs_blocks(m["A"])
            pad = Lblk.shape[0] * Lblk.shape[1]
            dpad = np.ones(pad)
            dpad[: d_l1.size] = d_l1
            lp["gs_l"] = torch.as_tensor(Lblk, dtype=dtype, device=device)
            lp["gs_d"] = torch.as_tensor(dpad, dtype=dtype, device=device)
        level_params.append(lp)
        level_aps.append(dict(a=a_ap, p=p_ap, r=r_ap, rho=m["rho"],
                              n_fine=m["A"].nrows, n_coarse=m["P"].ncols))
    return level_params, level_aps, coarse_cholesky(Acoarse, dtype, device)


def build_hierarchy(A: CsrMatrix, opts: AmgOptions, dtype, layout: str,
                    device):
    """Host setup and device layouts → (level_params, level_aps,
    coarse_factor)."""
    mats, Al = build_matrix_hierarchy(A, opts)
    return device_hierarchy(mats, Al, opts, dtype, layout, device)


# -------------------------------------------------------------- device cycle

def make_vcycle(level_aps, opts: AmgOptions, dtype) -> Callable:
    """Return vcycle(level_params, coarse_L, b, x0) -> x: one cycle over the
    hierarchy, in `dtype`. Call it under `full_f32()` so that the dense
    products and triangular solves stay out of TF32."""

    def coarse_solve(coarse_L, b):
        y = torch.linalg.solve_triangular(coarse_L, b[:, None], upper=False)
        return torch.linalg.solve_triangular(coarse_L.mT, y, upper=True)[:, 0]

    def jacobi_smooth(ap, L, b, x):
        om = opts.jacobi_scale / ap["rho"]
        for _ in range(opts.degree):
            x = x + om * L["inv_diag"] * (b - ap["a"](L["a"], x))
        return x

    def chebyshev_smooth(ap, L, b, x):
        """Chebyshev polynomial smoother on D⁻¹A over [lower·ρ, 1.1·ρ]
        (hypre's cheby smoother family, order = opts.degree)."""
        mv = lambda v: ap["a"](L["a"], v)
        dinv = L["inv_diag"]
        lmax = 1.1 * ap["rho"]
        lmin = opts.cheby_lower * ap["rho"]
        theta = (lmax + lmin) / 2.0
        delta = (lmax - lmin) / 2.0
        sigma = theta / delta
        rho_k = 1.0 / sigma
        r = b - mv(x)
        d = (dinv * r) / theta
        for _ in range(opts.degree - 1):
            x = x + d
            r = r - mv(d)
            rho_k1 = 1.0 / (2.0 * sigma - rho_k)
            d = (rho_k1 * rho_k) * d + (2.0 * rho_k1 / delta) * (dinv * r)
            rho_k = rho_k1
        return x + d

    def l1_jacobi_smooth(ap, L, b, x):
        """ℓ1-Jacobi: x += D_ℓ1⁻¹ (b − Ax), convergent without damping."""
        for _ in range(opts.degree):
            x = x + L["inv_l1"] * (b - ap["a"](L["a"], x))
        return x

    def l1_gs_smooth(ap, L, b, x):
        """Hybrid ℓ1-symmetric-GS: one SpMV and two batched triangular
        solves per sweep, x += (D+U)⁻¹ D (L+D)⁻¹ (b − Ax) blockwise."""
        blk = L["gs_l"]                       # (nb, B, B) lower, ℓ1 diag
        dpad = L["gs_d"]                      # (nb*B,) ℓ1 diag, 1-padded
        nb, Bb, _ = blk.shape
        n = ap["n_fine"]
        for _ in range(opts.degree):
            r = b - ap["a"](L["a"], x)
            rp = torch.zeros(nb * Bb, dtype=dtype, device=b.device)
            rp[:n] = r
            z1 = torch.linalg.solve_triangular(blk, rp.view(nb, Bb, 1),
                                               upper=False)
            w = dpad.view(nb, Bb, 1) * z1
            z = torch.linalg.solve_triangular(blk.mT, w, upper=True)
            x = x + z.reshape(-1)[:n]
        return x

    smooth = {"chebyshev": chebyshev_smooth,
              "jacobi": jacobi_smooth,
              "l1_jacobi": l1_jacobi_smooth,
              "l1_gs": l1_gs_smooth}[opts.smoother]
    nlev = len(level_aps)

    def coarse_correct(levels, coarse_L, lvl: int, rc):
        """Approximate solve of A_lvl e = rc by one cycle (V) or two Krylov
        steps preconditioned by the cycle (K-cycle, Notay — parAlmond)."""
        if lvl == nlev:
            return coarse_solve(coarse_L, rc)
        if opts.cycle == "v":
            return cycle(levels, coarse_L, lvl, rc, torch.zeros_like(rc))
        ap, L = level_aps[lvl], levels[lvl]
        mv = lambda v: ap["a"](L["a"], v)
        eps = 1e-30
        u = cycle(levels, coarse_L, lvl, rc, torch.zeros_like(rc))
        v = mv(u)
        rho1 = torch.dot(u, v) + eps
        alpha1 = torch.dot(u, rc)
        rt = rc - (alpha1 / rho1) * v
        w = cycle(levels, coarse_L, lvl, rt, torch.zeros_like(rt))
        z = mv(w)
        gamma = torch.dot(v, w)
        rho2 = torch.dot(w, z) - gamma * gamma / rho1 + eps
        alpha2 = torch.dot(w, rt)
        return (alpha1 / rho1 - gamma * alpha2 / (rho1 * rho2)) * u \
            + (alpha2 / rho2) * w

    def cycle(levels, coarse_L, lvl: int, b, x):
        if lvl == nlev:
            return coarse_solve(coarse_L, b)
        ap, L = level_aps[lvl], levels[lvl]
        for _ in range(opts.pre_sweeps):
            x = smooth(ap, L, b, x)
        r = b - ap["a"](L["a"], x)
        rc = ap["r"](L["r"], r)
        ec = coarse_correct(levels, coarse_L, lvl + 1, rc)
        x = x + ap["p"](L["p"], ec)
        for _ in range(opts.post_sweeps):
            x = smooth(ap, L, b, x)
        return x

    def vcycle(level_params, coarse_L, b, x0):
        return cycle(level_params, coarse_L, 0, b.to(dtype), x0.to(dtype))

    return vcycle


# ------------------------------------------------------------------- solver

@register_solver("amg")
class AmgSolver(Solver):
    """Standalone AMG: fixed-cycle mode (cycles=k, like Hypre maxiter=2
    tol=0) or converge mode (rtol + maxiter)."""

    def __init__(self, A: CsrMatrix, dtype=torch.float64, cycles=None,
                 rtol=1e-8, maxiter=100, theta=None, coarsening="sa",
                 interp="direct", smoother="chebyshev", strength="classical",
                 interp_passes=1, pmax=4, interp_omega=1.0,
                 degree=2, cycle="v", pre_sweeps=1, post_sweeps=1,
                 coarse_n=128, max_levels=12, layout="auto", ordering="none",
                 device="cuda", **params):
        super().__init__(A, **params)
        self.device = torch.device(device)
        self.dtype = as_dtype(dtype)
        self.cycles = int(cycles) if cycles is not None else None
        self.rtol = float(rtol)
        self.maxiter = int(maxiter)
        self._precision_mode = None
        self._ir = False
        if self.dtype == torch.float64 and self.cycles is not None:
            # Fixed-cycle protocol (hypre maxiter=2 tol=0, AmgX
            # max_iters=1): x after k cycles has a residual of ~1e-1..1e-2,
            # far above f32 resolution. The JAX package's TPU branch.
            print("amg: fixed-cycle fp64 executes the cycles in f32 (mode "
                  "fp32_cycles_auto; cycle residuals ~1e-1 dwarf f32 "
                  "rounding).", file=sys.stderr)
            self.dtype = torch.float32
            self._precision_mode = "fp32_cycles_auto"
        if self.dtype == torch.float64 and self.cycles is None:
            # Converge mode: AMG iteration is iterative refinement with the
            # V-cycle as the inner solve: f32 cycles + an f64 residual on
            # the sliced-ELL f64 product, once per cycle.
            print("amg: converge-mode fp64 executes as f32 V-cycles + f64 "
                  "residual refinement (mode fp32_ir_auto).", file=sys.stderr)
            self.dtype = torch.float32
            self._precision_mode = "fp32_ir_auto"
            self._ir = True
        self.layout = resolve_layout(layout, self.dtype)
        if str(ordering).lower() not in ("none", ""):
            print(f"amg: --ordering {ordering} has no effect "
                  "(AMG coarsening is permutation-invariant); ignoring.",
                  file=sys.stderr)

        opts = AmgOptions(cycle=cycle, theta=theta, coarsening=coarsening,
                          interp=interp, smoother=smoother, strength=strength,
                          interp_passes=interp_passes, pmax=pmax,
                          interp_omega=interp_omega,
                          degree=degree, pre_sweeps=pre_sweeps,
                          post_sweeps=post_sweeps, coarse_n=coarse_n,
                          max_levels=max_levels)
        self.opts = opts
        self._perm = self._inv = None
        Ah = A
        if smoother == "l1_gs":
            # Internal RCM banding (the 128-row tiles must hold graph
            # neighbourhoods), undone on the returned x; coarse levels
            # stay banded too.
            Ah, self._perm, self._inv = permutation("rcm", A, self.device)
            opts.reorder_coarse = True
        t0 = time.perf_counter()
        self._levels, level_aps, self._coarse_L = build_hierarchy(
            Ah, opts, self.dtype, self.layout, self.device)
        self.setup_breakdown["hierarchy_s"] = time.perf_counter() - t0
        self.n_levels = len(level_aps) + 1
        self._vcycle = make_vcycle(level_aps, opts, self.dtype)
        if level_aps:
            ap0, op0 = level_aps[0]["a"], self._levels[0]["a"]
        else:
            ap0, op0 = build_matvec(Ah, self.layout, self.device,
                                    dtype=self.dtype)
        self._fine_mv = lambda x: ap0(op0, x)
        if self._ir:
            self._resid_mv = f64_residual_matvec(Ah, op0, self.device)

    def _cycle(self, b, x):
        return self._vcycle(self._levels, self._coarse_L, b, x)

    def _solve_fixed(self, b):
        x = torch.zeros_like(b)
        for _ in range(self.cycles):
            x = self._cycle(b, x)
        r = b - self._fine_mv(x)
        return x, torch.dot(r, r), torch.dot(b, b), self.cycles

    def _solve_ir(self, b):
        """x += Vcycle32(r / ‖r‖)·‖r‖ with the f64 residual carried, one
        f64 SpMV (`spmv_sell_f64`) per cycle; the stop test reads rr on
        the host."""
        bb = torch.dot(b, b)
        tol2 = (self.rtol ** 2) * bb
        x, r, rr, it = torch.zeros_like(b), b, bb, 0
        while it < self.maxiter and bool(rr > tol2):
            scale = torch.sqrt(rr)
            safe = torch.where(scale > 0, scale, 1.0)
            r32 = r.to(torch.float32) * (1.0 / safe).to(torch.float32)
            z32 = self._cycle(r32, torch.zeros_like(r32))
            z32 = torch.where(torch.isfinite(z32), z32, 0.0)
            x = x + (z32 * safe.to(torch.float32)).to(torch.float64)
            r = b - self._resid_mv(x)
            rr = torch.dot(r, r)
            it += 1
        return x, rr, bb, it

    def _solve_plain(self, b):
        bb = torch.dot(b, b)
        tol2 = (self.rtol ** 2) * bb
        x, rr, it = torch.zeros_like(b), bb, 0
        while it < self.maxiter and bool(rr > tol2):
            x = self._cycle(b, x)
            r = b - self._fine_mv(x)
            rr = torch.dot(r, r)
            it += 1
        return x, rr, bb, it

    def _run(self, b):
        b = torch.as_tensor(b, device=self.device)
        b = b.to(torch.float64 if self._ir else self.dtype)
        if self._perm is not None:
            b = b[self._perm]
        with full_f32():
            if self.cycles is not None:
                out = self._solve_fixed(b)
            elif self._ir:
                out = self._solve_ir(b)
            else:
                out = self._solve_plain(b)
        x, rr, bb, iters = out
        if self._inv is not None:
            x = x[self._inv]
        return x, rr, bb, iters

    def solve(self, b) -> SolveResult:
        x, rr, bb, iters = self._run(b)
        rnorm, bnorm = float(torch.sqrt(rr)), float(torch.sqrt(bb))
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        extra = {"levels": self.n_levels}
        if self.cycles is not None:
            # Fixed-cycle protocol: "converged" is not the contract (hypre
            # tol=0); the residual is reported as data.
            extra = {"mode": f"fixed_{self.cycles}_cycles", **extra}
            converged = True
        else:
            converged = relres <= self.rtol or bnorm == 0.0
        if self._precision_mode:
            extra["precision_mode"] = self._precision_mode
        return SolveResult(x=x, iters=int(iters), relres=relres,
                           converged=converged, extra=extra)

    def solve_fn(self):
        return lambda b: self._run(b)[0]


def amg_precond(A: CsrMatrix, dtype, device, **amg_params):
    """One V-cycle as a CG preconditioner (symmetric: the same smoother
    before and after). With the ℓ1-GS smoother A is RCM-banded internally
    and the cycle applied as Pᵀ M⁻¹ P, so it stays SPD for CG."""
    dtype = as_dtype(dtype)
    layout = resolve_layout(amg_params.pop("layout", "auto"), dtype)
    opts = AmgOptions(**amg_params)
    perm = inv = None
    if opts.smoother == "l1_gs":
        A, perm, inv = permutation("rcm", A, device)
        opts.reorder_coarse = True
    level_params, level_aps, coarse_L = build_hierarchy(A, opts, dtype,
                                                        layout, device)
    vcycle = make_vcycle(level_aps, opts, dtype)

    def apply(state, r):
        lv, cL = state
        if perm is not None:
            r = r[perm]
        with full_f32():
            z = vcycle(lv, cL, r, torch.zeros_like(r))
        if inv is not None:
            z = z[inv]
        return z

    return (level_params, coarse_L), apply
