"""2-D block-partitioned distributed SpMV and Krylov solvers (counterpart of
`lsbench_tpu/parallel/dist2d.py`).

The ranks sit on a pr × pc grid (`mesh.GridMesh`, rank c = i·pc + j at
(i, j)). The global vector lives in P = pr·pc chunks of `csize` entries,
chunk c on rank c. Rank (i, j) owns row block i (pc consecutive chunks of
rows) × the columns whose chunks are ≡ j (mod pc). One matvec:

- `all_gather` over the column group (ranks (·, j), ascending i) delivers
  chunks j, pc + j, 2pc + j, … concatenated in order, rank (i, j)'s column
  set: the "gathered frame", into which the column ids were renumbered at
  setup;
- the local product of the rank's (rloc × n_gath) block gives its row
  block's partial, rloc = pc·csize;
- one `reduce_scatter` over the row group (ranks (i, ·), ascending j)
  sums the pc partials and hands piece j of row block i, global chunk
  i·pc + j, to rank (i, j): the vector layout again, with no reshuffle.

Each matvec moves O(n/pc) in and O(n/pr) out per rank, where the 1-D
all_gather moves O(n): the partition for operators not banded enough for
the halo ring.

The local product is the port's sliced-ELL kernel on the rank's block laid
out as a `SellMatrix` ("bsr", where the JAX package runs its Pallas BSR
kernels on the block), or the plain gather ELL ("ell"):

    JAX (per device, in shard_map)   port (per rank)
    spmv_2d_bsr_local       (K1)     spmv_sell      f32
    spmv_2d_bsr_df64_local  (K2)     spmv_sell_f64  f64
    vmap of spmv_2d_bsr_local        spmm_sell      f32, k columns (K3)

For k columns one gather and one reduce-scatter move the (·, k) block, as
the JAX vmap merges its k transfers. The collectives are
`all_gather_single` / `reduce_scatter_single` where torch has them (2.13)
and `all_gather_into_tensor` / `reduce_scatter_tensor` otherwise (the same
functions under their older names, deprecated in 2.13).

The solvers are the 1-D classes' iterations on this operator (`On2dGrid`
overrides how they build it): `DistributedCg2d`, `DistributedBicgstab2d`
(with the port's shadow restart) and `DistributedBlockCg2d`; the mixed-
precision ones are in `dist_cg_ir.py`, AMG-CG in `dist_amg2d.py`. Their
vectors are the 1-D partition's with nloc = csize (`RowShard`): chunk c is
rows [c·csize, (c+1)·csize), and every scalar reduction is one all_reduce
over all ranks (`fused_psum`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.sell import SellMatrix
from lsbench_tpu_torch.ops.spmv_sell import (spmm_sell, spmv_sell,
                                             spmv_sell_f64)
from lsbench_tpu_torch.parallel.dist_bicgstab import DistributedBicgstab
from lsbench_tpu_torch.parallel.dist_block_cg import DistributedBlockCg
from lsbench_tpu_torch.parallel.dist_cg import DistributedCg
from lsbench_tpu_torch.parallel.dist_spmv import DistMatvec, _round_up
from lsbench_tpu_torch.parallel.mesh import GridMesh, fetch_global

_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


@dataclass
class Spmv2dPlan:
    """Host-built plan: (pr, pc, rloc, k) ELL blocks with gathered-frame
    column ids. Rectangular operators (AMG's P and R) chunk rows by
    `csize` (the output vector's layout) and columns by `csize_in` (the
    input vector's); square operators use one chunk size for both."""
    vals: torch.Tensor   # (pr, pc, rloc, k) on the host
    cols: torch.Tensor   # (pr, pc, rloc, k) int32 into the gathered vector
    n: int
    n_pad: int           # P * csize
    csize: int           # output-vector chunk per rank
    rloc: int            # rows per row block (= pc * csize)
    pr: int
    pc: int
    csize_in: int = 0    # input-vector chunk (== csize when square)
    n_gath: int = 0      # pr * csize_in (gathered x width per rank)


def _chunks(A: CsrMatrix, pr: int, pc: int, align: int,
            csize_r: int | None, csize_c: int | None):
    """(csize_r, csize_c) of the partition: the JAX plan's defaults."""
    P_ = pr * pc
    if csize_r is None:
        csize_r = _round_up(-(-A.nrows // P_), align)
    if csize_c is None:
        csize_c = (csize_r if A.ncols == A.nrows
                   else _round_up(-(-A.ncols // P_), align))
    return csize_r, csize_c


def _grid_coo(A: CsrMatrix, pr: int, pc: int, csize_r: int, csize_c: int):
    """Each entry's grid position and gathered-frame coordinates:
    (i_dev, j_dev, local row, local column, value)."""
    rloc = csize_r * pc
    r, c, v = A.to_coo()
    q = c // csize_c                     # global chunk of the column
    # Gathered frame on grid column j: chunks (j, pc+j, 2pc+j, …) in order.
    lcol = (q // pc) * csize_c + (c % csize_c)
    return r // rloc, q % pc, r % rloc, lcol, v


def build_2d_plan(A: CsrMatrix, pr: int, pc: int, dtype, align: int = 8,
                  csize_r: int | None = None,
                  csize_c: int | None = None) -> Spmv2dPlan:
    """The 2-D plan of A, laid out as the JAX package lays it (arrays bit
    for bit its plan's)."""
    P_ = pr * pc
    csize_r, csize_c = _chunks(A, pr, pc, align, csize_r, csize_c)
    rloc = csize_r * pc
    i_dev, j_dev, lrow, lcol, v = _grid_coo(A, pr, pc, csize_r, csize_c)

    # Slot within each (rank, local row) group.
    group = (i_dev * pc + j_dev) * rloc + lrow
    order = np.argsort(group, kind="stable")
    g_sorted = group[order]
    counts = np.bincount(g_sorted, minlength=P_ * rloc)
    k = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(v.size) - starts[g_sorted]

    vals = np.zeros((pr, pc, rloc, k), dtype=np.float64)
    cols = np.zeros((pr, pc, rloc, k), dtype=np.int32)
    gi = g_sorted
    at = (gi // (pc * rloc), (gi // rloc) % pc, gi % rloc, slot)
    vals[at] = v[order]
    cols[at] = lcol[order]
    return Spmv2dPlan(vals=torch.as_tensor(vals).to(dtype),
                      cols=torch.as_tensor(cols), n=A.nrows,
                      n_pad=csize_r * P_, csize=csize_r, rloc=rloc, pr=pr,
                      pc=pc, csize_in=csize_c, n_gath=pr * csize_c)


def local_block_2d(A: CsrMatrix, pr: int, pc: int, i: int, j: int,
                   align: int = 8, csize_r: int | None = None,
                   csize_c: int | None = None) -> CsrMatrix:
    """Rank (i, j)'s (rloc × n_gath) block in the gathered frame as a CSR
    (the JAX package's per-device BSR source, `build_2d_bsr_plan`)."""
    csize_r, csize_c = _chunks(A, pr, pc, align, csize_r, csize_c)
    rloc, n_gath = csize_r * pc, pr * csize_c
    i_dev, j_dev, lrow, lcol, v = _grid_coo(A, pr, pc, csize_r, csize_c)
    m = (i_dev == i) & (j_dev == j)
    if not m.any():  # a block with no entries
        return CsrMatrix(rloc, n_gath, np.zeros(rloc + 1, np.int64),
                         np.zeros(0, np.int32), np.zeros(0))
    return CsrMatrix.from_coo(lrow[m], lcol[m], v[m], nrows=rloc,
                              ncols=n_gath)


def gather_cols(mesh: GridMesh, x_l: torch.Tensor) -> torch.Tensor:
    """The JAX package's `all_gather` over ROWS: this rank's grid column's
    chunks, (csize, …) → (pr·csize, …) in ascending grid row."""
    x_l = x_l.contiguous()
    out = x_l.new_empty((mesh.pr * x_l.shape[0], *x_l.shape[1:]))
    _all_gather(out, x_l, group=mesh.col_group)
    return out


def scatter_rows(mesh: GridMesh, part: torch.Tensor) -> torch.Tensor:
    """The JAX package's `psum_scatter` over COLS: the row block's
    partials summed over the grid row, piece j to rank (i, j),
    (pc·csize, …) → (csize, …)."""
    part = part.contiguous()
    out = part.new_empty((part.shape[0] // mesh.pc, *part.shape[1:]))
    _reduce_scatter(out, part, group=mesh.row_group)
    return out


def spmv_2d_local(mesh: GridMesh, vals_l, cols_l, x_l):
    """One 2-D matvec with the gather-ELL local product (any dtype):
    vals_l/cols_l the rank's (rloc, k) block, x_l its (csize_in,) chunk
    → its (csize,) chunk of y."""
    xg = gather_cols(mesh, x_l)
    return scatter_rows(mesh, torch.sum(vals_l * xg[cols_l], dim=1))


def spmv_2d_sell_local(mesh: GridMesh, sell: SellMatrix, x_l):
    """Gather, the SELL f32 kernel on the rank's block (the JAX package's
    `spmv_2d_bsr_local`, K1), reduce-scatter. (csize,) → (csize,) f32."""
    return scatter_rows(mesh, spmv_sell(sell, gather_cols(mesh, x_l.float())))


def spmv_2d_sell_f64_local(mesh: GridMesh, sell: SellMatrix, x_l):
    """Gather, the SELL f64 kernel (the JAX package's
    `spmv_2d_bsr_df64_local`, K2), reduce-scatter in f64."""
    return scatter_rows(mesh,
                        spmv_sell_f64(sell, gather_cols(mesh, x_l.double())))


def spmm_2d_sell_local(mesh: GridMesh, sell: SellMatrix, X_l):
    """k columns: one gather of the (csize, k) block, the SELL f32 SpMM
    (K3) on the rank's block, one reduce-scatter. → (csize, k) f32."""
    return scatter_rows(mesh, spmm_sell(sell, gather_cols(mesh, X_l.float())))


def build_2d_matvec(A: CsrMatrix, mesh: GridMesh, dtype,
                    local_spmv: str = "auto", align: int = 8,
                    csize_r: int | None = None,
                    csize_c: int | None = None) -> DistMatvec:
    """This rank's 2-D operator (the 2-D twin of
    `dist_spmv.build_dist_matvec`; strategy "2d", halo 0, nloc = csize).

    local_spmv: "bsr" (and "auto") runs the SELL kernels on the rank's
    block, where the JAX package runs its Pallas BSR kernels on the TPU;
    "ell" is the plain gather path, its CPU default."""
    if not isinstance(mesh, GridMesh):
        raise ValueError("the 2-D partition needs a (rows, cols) grid mesh "
                         "(mesh.make_mesh_2d), got a row mesh")
    if local_spmv not in ("auto", "bsr", "ell"):
        raise ValueError(f"unknown local_spmv '{local_spmv}' "
                         "(auto | bsr | ell)")
    plan = build_2d_plan(A, mesh.pr, mesh.pc, dtype, align, csize_r, csize_c)
    dev = mesh.device
    use_sell = local_spmv != "ell"
    if use_sell:
        block = local_block_2d(A, mesh.pr, mesh.pc, mesh.i, mesh.j, align,
                               plan.csize, plan.csize_in)
        sell = SellMatrix.from_csr(block, dtypes=(dtype,), device=dev)
        if dtype == torch.float64:
            def matvec(x_l):
                return spmv_2d_sell_f64_local(mesh, sell, x_l)

            def matmat(X_l):
                # One f64 SpMV per column between one gather and one
                # reduce-scatter: only the block solver's once-per-pass
                # f64 residual runs it.
                Xg = gather_cols(mesh, X_l.double())
                return scatter_rows(mesh, torch.stack(
                    [spmv_sell_f64(sell, Xg[:, c].contiguous())
                     for c in range(Xg.shape[1])], dim=1))
        else:
            def matvec(x_l):
                return spmv_2d_sell_local(mesh, sell, x_l).to(dtype)

            def matmat(X_l):
                return spmm_2d_sell_local(mesh, sell, X_l).to(dtype)
    else:
        vals_l = plan.vals[mesh.i, mesh.j].to(dev)
        cols_l = plan.cols[mesh.i, mesh.j].to(device=dev, dtype=torch.int64)

        def matvec(x_l):
            return spmv_2d_local(mesh, vals_l, cols_l, x_l)

        def matmat(X_l):
            Xg = gather_cols(mesh, X_l)
            return scatter_rows(mesh,
                                torch.einsum("ns,nsk->nk", vals_l, Xg[cols_l]))

    return DistMatvec(matvec=matvec, matmat=matmat, strategy="2d",
                      local_spmv="bsr" if use_sell else "ell", halo=0,
                      nloc=plan.csize, n_pad=plan.n_pad, n=plan.n, plan=plan)


class On2dGrid:
    """Put before a 1-D distributed solver class (`dist_spmv.
    RowPartitioned`) to run its iteration on the 2-D grid: its operator is
    `build_2d_matvec`'s and its record has the grid's shape in place of
    the halo fields."""

    def _matvec(self, A: CsrMatrix, dtype, strategy: str = "auto",
                local_spmv: str = "auto", row_align: int = 8) -> DistMatvec:
        if strategy not in ("auto", "2d"):
            raise ValueError(f"strategy '{strategy}' is the 1-D partition's;"
                             " the 2-D grid has one schedule")
        return build_2d_matvec(A, self.mesh, dtype, local_spmv=local_spmv,
                               align=row_align)

    def _layout_extra(self, halo: bool = True) -> dict:
        return {"mesh": (self.mesh.pr, self.mesh.pc),
                "local_spmv": self.local_spmv}


class DistributedCg2d(On2dGrid, DistributedCg):
    """Jacobi-preconditioned CG over a (rows × cols) grid."""

    name = "dist_cg2d"


class DistributedBicgstab2d(On2dGrid, DistributedBicgstab):
    """Jacobi-preconditioned BiCGSTAB over a grid: the Ginkgo role
    (ginkgo.cpp:55-64 recurrence and stop rule) on the 2-D partition, with
    the port's shadow restart, decided on all-reduced values."""

    name = "dist_bicgstab2d"


class DistributedBlockCg2d(On2dGrid, DistributedBlockCg):
    """Multi-RHS block CG on the grid (`--nrhs k --mesh RxC`): f32
    simultaneous-column inner PCG on the SELL SpMM, f64 per-column
    residual refinement."""

    name = "dist_block_cg2d"


def spmv_2d(A: CsrMatrix, mesh: GridMesh, x, dtype=torch.float64,
            local_spmv: str = "ell") -> np.ndarray:
    """One 2-D distributed y = A @ x (test and verification entry); every
    rank returns the whole y on the host."""
    op = build_2d_matvec(A, mesh, dtype, local_spmv=local_spmv)
    xp = np.zeros(op.n_pad)
    xp[: op.n] = np.asarray(x, dtype=np.float64)
    lo = mesh.rank * op.nloc
    x_l = torch.as_tensor(xp[lo: lo + op.nloc], dtype=dtype,
                          device=mesh.device)
    y = fetch_global(mesh, op.matvec(x_l), op.n)
    return y.cpu().numpy()
