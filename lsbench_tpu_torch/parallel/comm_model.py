"""Static per-iteration communication accounting and a strong-scaling model
(counterpart of `lsbench_tpu/parallel/comm_model.py`).

1. **Exact communication volumes.** Every distributed solver's collective
   schedule is static: it is fixed at setup by the halo, 2-D and
   hierarchy plans. `cg_comm_volume`, `cg2d_comm_volume` and
   `amg_comm_volume` derive the bytes and the collective calls per
   iteration from the same plans the port's solvers build
   (`dist_spmv.build_halo_plan`, `dist2d._chunks`, a `_DistAmgBase`'s
   resolved per-level strategies). The volumes are the JAX package's,
   field by field. tests/test_torch_comm_model.py holds them to the JAX
   functions and to the calls the port's ranks really make.

2. **A parameterized link model.** `predict_efficiency` combines a volume
   with a measured single-device time per iteration t_1 and a link's rate
   and per-hop latency:

       t_D = t_1/D  +  bytes_per_spmv/link_rate  +  hop_latency · hops(D)
       eff = (t_1/D) / t_D

   hops(D): a fused all-reduce of ≤ 3 scalars is latency-bound, 2·(D−1)
   ring hops; the two halo sends of one SpMV go left and right at once,
   1 hop; a gather or scatter collective adds its ring hops. Compute
   splits as t_1/D because the single-device SpMV streams memory, and
   memory bandwidth grows with the cards. It is a model, not a
   measurement: no card-to-card time of the port has been measured.

What one collective call is in the port, where the JAX package counts
XLA collectives in a trace:

- a "ppermute" is one `isend` of `dist_spmv._halo_exchange`, which sends
  each neighbour the H boundary rows in one `dist.batch_isend_irecv`: a
  middle rank sends 2 per SpMV, an end rank 1, and a group of one none;
- a "psum" is one `dist.all_reduce` of `dist_spmv.fused_psum`;
- an all_gather is one `dist.all_gather` (`mesh.fetch_global`: the
  all_gather strategy, an operator that gathers, the coarse solve), or
  one `dist2d._all_gather` (`dist2d.gather_cols`, over the grid column);
- a psum_scatter is one `dist2d._reduce_scatter` (`dist2d.scatter_rows`,
  over the grid row).

The counts are a middle rank's. At D = 1 they keep the JAX values (2
ppermutes per halo SpMV, the calls XLA traces on a one-device mesh), and
`predict_efficiency` prices none of them there.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.parallel.dist2d import _chunks
from lsbench_tpu_torch.parallel.dist_spmv import build_halo_plan

# Link defaults for one H100 SXM card; neither is a measurement of the port.
# NVLink 4: 900 GB/s in both directions together, 450 GB/s in each (NVIDIA's
# H100 SXM data sheet).
NVLINK4_GBPS = 450.0
# One NCCL hop over NVLink: an assumption of the order of NCCL's small-message
# latency within one NVLink host (a few µs); not measured here, not published
# as one figure.
NVLINK_HOP_LATENCY_S = 3e-6


def _itemsize(dtype) -> int:
    return torch.empty(0, dtype=dtype).element_size()


@dataclass
class CommVolume:
    """Per-device, per-CG-iteration communication of a distributed solver."""
    strategy: str            # halo | all_gather | 2d
    n_devices: int
    halo: int | None         # H (halo strategy only)
    bytes_per_spmv: int      # payload bytes moved per device per SpMV
    ppermutes_per_spmv: int  # point-to-point sends per SpMV
    psums_per_iter: int      # fused scalar all-reduces per CG iteration
    psum_scalars: int        # total scalars carried by those all-reduces
    gather_hops_per_spmv: int = 0  # ring hops of the gather/scatter
    #                         collectives per SpMV: D−1 for a 1-D
    #                         all_gather, (pr−1)+(pc−1) for the 2-D
    #                         all_gather + reduce-scatter pair

    @property
    def bytes_per_iter(self) -> int:
        # 1 SpMV per CG iteration + the all-reduce payloads (f64 scalars).
        return self.bytes_per_spmv + self.psum_scalars * 8


def cg_comm_volume(A: CsrMatrix, n_devices: int, dtype=torch.float32,
                   strategy: str = "auto", row_align: int = 8) -> CommVolume:
    """Distributed CG (`dist_cg.py`) communication, from the halo plan the
    solver builds. Per iteration: 1 SpMV (2 sends of H rows on the halo
    path, or one all_gather of the complement on the fallback) + 2 fused
    all-reduces (p·Ap, then r·z with r·r: 3 scalars)."""
    itemsize = _itemsize(dtype)
    plan = build_halo_plan(A, n_devices, dtype, row_align=row_align)
    use_halo = strategy == "halo" or (strategy == "auto"
                                      and not plan.needs_all_gather)
    if n_devices == 1:
        # Collectives in a group of one move nothing.
        return CommVolume("halo" if use_halo else "all_gather", 1,
                          plan.halo if use_halo else None, 0,
                          2 if use_halo else 0, 2, 3)
    if use_halo:
        return CommVolume("halo", n_devices, plan.halo,
                          2 * plan.halo * itemsize, 2, 2, 3)
    return CommVolume("all_gather", n_devices, None,
                      (plan.n_pad - plan.nloc) * itemsize, 0, 2, 3,
                      gather_hops_per_spmv=n_devices - 1)


def cg2d_comm_volume(A: CsrMatrix, pr: int, pc: int,
                     dtype=torch.float32) -> CommVolume:
    """2-D distributed CG (`dist2d.py`): per SpMV one all_gather over the
    grid column ((pr−1)·csize in, pr−1 ring hops) and one reduce-scatter
    over the grid row ((pc−1)·csize out, pc−1 hops); 2 fused all-reduces
    over all ranks per iteration. csize is the plan's chunk rule
    (`dist2d._chunks`): building the O(nnz) plan to read one size would
    defeat host-side accounting at scale."""
    itemsize = _itemsize(dtype)
    csize, _ = _chunks(A, pr, pc, 8, None, None)
    bytes_spmv = ((pr - 1) + (pc - 1)) * csize * itemsize
    return CommVolume("2d", pr * pc, None, bytes_spmv, 0, 2, 3,
                      gather_hops_per_spmv=(pr - 1) + (pc - 1))


def predict_efficiency(t1_iter_s: float, cv: CommVolume,
                       link_gbps: float = NVLINK4_GBPS,
                       hop_latency_s: float = NVLINK_HOP_LATENCY_S):
    """Strong-scaling prediction: (efficiency, t_iter at D in seconds).

    `t1_iter_s` is a measured single-device time per iteration. The
    defaults describe one H100 SXM host: `link_gbps` is NVLink 4's 450 GB/s
    per direction (NVIDIA's published figure, not a measurement) and
    `hop_latency_s` 3 µs per hop, an assumption of the order of NCCL's
    small-message latency over NVLink (no measured or published figure
    stands behind it). Pass both to model another fabric."""
    D = cv.n_devices
    if D == 1:
        return 1.0, t1_iter_s
    t_bw = cv.bytes_per_spmv / (link_gbps * 1e9)
    hops = (cv.psums_per_iter * 2 * (D - 1) + cv.ppermutes_per_spmv // 2
            + cv.gather_hops_per_spmv)
    t_lat = hops * hop_latency_s
    t_d = t1_iter_s / D + t_bw + t_lat
    return (t1_iter_s / D) / t_d, t_d


@dataclass
class AmgLevelComm:
    """Per-device communication of ONE VISIT to a hierarchy level (a
    V-cycle visits each level once per cycle; a K-cycle visits level l
    2^l times; the visit multipliers are folded into the *_per_cycle
    totals)."""
    level: int
    a_strategy: str          # halo | all_gather (A_l smoother/residual mv)
    a_halo: int | None
    a_applies: int           # A_l matvecs per visit
    r_strategy: str          # restriction R_l (fine → coarse)
    r_halo: int | None
    p_strategy: str          # prolongation P_l (coarse → fine)
    p_halo: int | None
    ppermutes: int           # collective CALLS at this level per visit
    all_gathers: int
    bytes: int               # payload bytes per device per visit (D ≥ 2)


@dataclass
class AmgCommVolume:
    """Per-device communication of the distributed AMG cycle and of one
    AMG-preconditioned CG iteration (`dist_amg.py`), from the halo plans
    the solver built."""
    n_devices: int
    levels: list
    coarse_gather_bytes: int      # the replicated coarse solve's all_gather
    ppermutes_per_cycle: int
    all_gathers_per_cycle: int    # the coarse-grid gather(s) included
    bytes_per_cycle: int
    psums_per_cycle: int          # K-cycle: the FCG inner products (2
    #                               fused all-reduces per coarse_correct
    #                               entry; a V-cycle has 0)
    # One DistributedAmgCg iteration = 1 cycle (the preconditioner) +
    # 1 fine-level matvec + 2 fused all-reduces (p·Ap; r·z with r·r).
    psums_per_iter: int
    psum_scalars: int
    ppermutes_per_iter: int
    all_gathers_per_iter: int
    bytes_per_iter_payload: int

    def as_comm_volume(self) -> CommVolume:
        """Adapter so that `predict_efficiency` prices an AMG-CG
        iteration."""
        D = self.n_devices
        return CommVolume(
            "amg_cg", D, None, self.bytes_per_iter_payload,
            self.ppermutes_per_iter, self.psums_per_iter, self.psum_scalars,
            gather_hops_per_spmv=self.all_gathers_per_iter * (D - 1))


def amg_comm_volume(solver) -> AmgCommVolume:
    """Account a port `_DistAmgBase` solver's cycle (`dist_amg.py`).

    Reads the solver's resolved per-level strategies (`_halos`,
    `_p_halos`, `_r_halos`: None means the operator gathers its whole
    source vector) and its smoother protocol: each smoother application
    runs `degree` A-matvecs (Chebyshev and Jacobi alike), so one visit
    runs (pre+post)·degree + 1 A-applies, 1 R and 1 P, and the cycle one
    all_gather for the replicated coarse solve. Counts are collective
    calls; bytes are the D ≥ 2 payloads.

    Item size: every exchange carries the solver's dtype. Level 0's SELL
    product (`_fine_sell`) exchanges x in the product's precision, the
    dtype again: f64 for an f64 solver, f32 for the f32 cycle of
    `DistributedAmgCgIr`. The JAX package's rule, 8 bytes on level 0 when
    its double-float BSR kernel runs an f64 solver, gives the same sizes.
    """
    D = solver.n_dev
    opts = solver.opts
    isz = _itemsize(solver.dtype)
    a_applies = (opts.pre_sweeps + opts.post_sweeps) * opts.degree + 1
    nlev = solver.n_levels - 1
    kcycle = getattr(opts, "cycle", "v") == "k"
    levels = []
    pp_cyc = ag_cyc = by_cyc = ps_cyc = 0
    visits = 1  # times level l is entered per top-level cycle
    for lvl in range(nlev):
        npf, npc = solver.pads[lvl], solver.pads[lvl + 1]
        nlf, nlc = npf // D, npc // D
        ha, hr, hp = (solver._halos[lvl], solver._r_halos[lvl],
                      solver._p_halos[lvl])
        # One A-matvec's collective cost (also the K-cycle FCG extra).
        if ha is not None:
            a_pp, a_ag, a_by = 2, 0, 2 * ha * isz
        else:
            a_pp, a_ag, a_by = 0, 1, (npf - nlf) * isz
        pp = a_applies * a_pp
        ag = a_applies * a_ag
        by = a_applies * a_by
        if hr is not None:
            pp += 2
            by += 2 * hr * isz
        else:
            ag += 1
            by += (npf - nlf) * isz
        if hp is not None:
            pp += 2
            by += 2 * hp * isz
        else:
            ag += 1
            by += (npc - nlc) * isz
        # K-cycle: level l (l ≥ 1) is entered visits(l−1) times through
        # coarse_correct, each entry running 2 recursive cycles (so visits
        # double per level) + 2 extra A-matvecs + 2 fused all-reduces.
        entries = visits
        if kcycle and lvl >= 1:
            visits = 2 * entries
        levels.append(AmgLevelComm(
            level=lvl,
            a_strategy="halo" if ha is not None else "all_gather",
            a_halo=ha, a_applies=a_applies,
            r_strategy="halo" if hr is not None else "all_gather",
            r_halo=hr,
            p_strategy="halo" if hp is not None else "all_gather",
            p_halo=hp,
            ppermutes=pp, all_gathers=ag, bytes=by))
        pp_cyc += visits * pp
        ag_cyc += visits * ag
        by_cyc += visits * by
        if kcycle and lvl >= 1:
            pp_cyc += entries * 2 * a_pp
            ag_cyc += entries * 2 * a_ag
            by_cyc += entries * 2 * a_by
            ps_cyc += entries * 2
    npL = solver.pads[-1]
    coarse_bytes = (npL - npL // D) * isz
    ag_cyc += visits
    by_cyc += visits * coarse_bytes

    # The CG iteration's fine-level matvec (the same operator as level 0).
    l0 = levels[0]
    if l0.a_strategy == "halo":
        pp_it = pp_cyc + 2
        ag_it = ag_cyc
        by_it = by_cyc + 2 * l0.a_halo * isz
    else:
        pp_it = pp_cyc
        ag_it = ag_cyc + 1
        by_it = by_cyc + (solver.pads[0] - solver.pads[0] // D) * isz
    return AmgCommVolume(
        n_devices=D, levels=levels, coarse_gather_bytes=coarse_bytes,
        ppermutes_per_cycle=pp_cyc, all_gathers_per_cycle=ag_cyc,
        bytes_per_cycle=by_cyc, psums_per_cycle=ps_cyc,
        psums_per_iter=2 + ps_cyc,
        psum_scalars=3 + (ps_cyc // 2) * 5,
        ppermutes_per_iter=pp_it, all_gathers_per_iter=ag_it,
        bytes_per_iter_payload=by_it)


def efficiency_crossover_n(nnz_per_row: float, gnnz_per_s: float,
                           n_devices: int, target: float = 0.8,
                           halo_rows: int = 64, dtype=torch.float32,
                           link_gbps: float = NVLINK4_GBPS,
                           hop_latency_s: float = NVLINK_HOP_LATENCY_S
                           ) -> int:
    """Smallest n where the model predicts ≥ `target` efficiency at
    `n_devices` cards, for a banded operator of the given density and a
    measured single-device SpMV rate (Gnnz/s → t_1 per CG iteration ≈
    nnz / rate); -1 where no n up to 10⁹ reaches it. Bisection on n."""
    itemsize = _itemsize(dtype)

    def eff(n):
        t1 = (n * nnz_per_row) / (gnnz_per_s * 1e9)
        cv = CommVolume("halo", n_devices, halo_rows,
                        2 * halo_rows * itemsize, 2, 2, 3)
        return predict_efficiency(t1, cv, link_gbps, hop_latency_s)[0]

    lo, hi = 1_000, 1_000_000_000
    if eff(hi) < target:
        return -1
    while hi - lo > max(1000, lo // 100):
        mid = (lo + hi) // 2
        if eff(mid) >= target:
            hi = mid
        else:
            lo = mid
    return hi
