"""Halo-exchange distributed SpMV over a block-row partition (counterpart
of `lsbench_tpu/parallel/dist_spmv.py`).

Each rank owns a contiguous block of nloc rows. For a banded matrix (after
RCM, `ordering/rcm.py`) the off-block columns its rows touch lie within a
halo of width H of its block's edges. Per SpMV:

- `_halo_exchange` moves the H boundary rows of x to the left and right
  neighbours with one `dist.batch_isend_irecv` (the JAX package's two
  `ppermute`s); rank 0 has no left neighbour and the last rank no right
  one, and their missing halos are zeros, as `ppermute` leaves them;
- the (nloc + 2H)-wide extended vector feeds a purely local SpMV whose
  column ids were renumbered to extended coordinates (off + H) at setup.

The local SpMV is either the plain gather ELL (`halo_spmv_local`, any
dtype, the JAX package's CPU path) or, where the JAX package runs its
Pallas BSR kernels inside `shard_map`, the port's sliced-ELL kernels on
the rank's (nloc × n_ext) block laid out as a `SellMatrix`:

    JAX (per device, in shard_map)   port (per rank)
    halo_spmv_bsr_local       (K1)   spmv_sell      f32   (halo_spmv_sell_local)
    halo_spmv_bsr_df64_local  (K2)   spmv_sell_f64  f64   (halo_spmv_sell_f64_local)
    halo_spmm_bsr_local       (K3)   spmm_sell      f32   (halo_spmm_sell_local)

The f64 product is native FP64 where the TPU ran double-float hi/lo
pairs, as on the single-device path. No halo kernel is needed: the
exchange moves two contiguous (H,) or (H, k) slices and `torch.cat`
builds x_ext, as `jnp.concatenate` does. Matrices whose couplings reach
past one neighbour block (H > nloc) report `needs_all_gather` and take
the all_gather strategy, with the ELL product.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.sell import SellMatrix
from lsbench_tpu_torch.ops.spmv_sell import (spmm_sell, spmv_sell,
                                             spmv_sell_f64)
from lsbench_tpu_torch.parallel.mesh import RowMesh, fetch_global
from lsbench_tpu_torch.parallel.perm import DistOrdering


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class HaloSpmvPlan:
    """Host-built plan: the ELL arrays of all ranks, with halo-local
    column ids (global ids on the all_gather path); rank r owns rows
    [r·nloc, (r+1)·nloc)."""
    vals: torch.Tensor     # (n_pad, k) on the host
    cols: torch.Tensor     # (n_pad, k) int32, ids into the extended vector
    n: int                 # true rows
    n_pad: int             # D * nloc
    nloc: int
    halo: int              # H
    n_devices: int
    needs_all_gather: bool


def _partition(A: CsrMatrix, n_devices: int, row_align: int):
    """(rows, cols, vals, rank of each entry, column offset from its
    rank's block start, nloc, H) of the block-row partition."""
    nloc = _round_up(-(-A.nrows // n_devices), row_align)
    r, c, v = A.to_coo()
    dev = r // nloc
    # Column offset of each nnz relative to its device's block start.
    off = c - dev * nloc
    # Halo width: how far columns reach outside [0, nloc).
    reach_left = int(np.maximum(0, -off).max(initial=0))
    reach_right = int(np.maximum(0, off - (nloc - 1)).max(initial=0))
    H = _round_up(max(max(reach_left, reach_right), 1), 8)
    return r, c, v, dev, off, nloc, H


def build_halo_plan(A: CsrMatrix, n_devices: int, dtype,
                    row_align: int = 8) -> HaloSpmvPlan:
    n = A.nrows
    r, c, v, dev, off, nloc, H = _partition(A, n_devices, row_align)
    n_pad = nloc * n_devices
    needs_all_gather = H > nloc

    # ELL with extended-coordinate columns: ext index = off + H ∈ [0, nloc+2H).
    counts = np.diff(A.offs)
    k = max(int(counts.max()), 1)
    vals = np.zeros((n_pad, k), dtype=np.float64)
    cols = np.full((n_pad, k), H, dtype=np.int32)  # padding → safe in-range id
    rows_idx = A.row_indices()
    slot = np.arange(A.nnz) - A.offs[rows_idx]
    vals[rows_idx, slot] = v
    if not needs_all_gather:
        cols[rows_idx, slot] = (off + H).astype(np.int32)
    else:
        cols[rows_idx, slot] = c.astype(np.int32)

    return HaloSpmvPlan(
        vals=torch.as_tensor(vals).to(dtype), cols=torch.as_tensor(cols),
        n=n, n_pad=n_pad, nloc=nloc, halo=H, n_devices=n_devices,
        needs_all_gather=needs_all_gather)


@dataclass
class RectHaloPlan:
    """Halo plan of a rectangular row-partitioned operator (the AMG
    transfer operators P and R, `dist_amg.py`): rank r owns rows
    [r·nloc_rows, (r+1)·nloc_rows) of M and the block [r·nloc_cols,
    (r+1)·nloc_cols) of the source vector. The exchange moves the H
    boundary rows of the source vector as for a square operator
    (`halo_spmv_local` applies both); `needs_all_gather` when the reach
    exceeds one neighbour block, and then the columns are global ids."""
    vals: torch.Tensor     # (nrow_pad, k) on the host
    cols: torch.Tensor     # (nrow_pad, k) int32, extended-local source ids
    halo: int
    nloc_rows: int
    nloc_cols: int
    needs_all_gather: bool


def build_rect_halo_plan(M: CsrMatrix, n_devices: int, nloc_rows: int,
                         nloc_cols: int, dtype) -> RectHaloPlan:
    """`build_halo_plan` with independent row and source block sizes (a
    fine and a coarse level's)."""
    nrow_pad = nloc_rows * n_devices
    r, c, v = M.to_coo()
    off = c - (r // nloc_rows) * nloc_cols
    reach_left = int(np.maximum(0, -off).max(initial=0))
    reach_right = int(np.maximum(0, off - (nloc_cols - 1)).max(initial=0))
    H = _round_up(max(max(reach_left, reach_right), 1), 8)
    needs_all_gather = H > nloc_cols

    counts = np.diff(M.offs)
    k = max(int(counts.max(initial=0)), 1)
    vals = np.zeros((nrow_pad, k), dtype=np.float64)
    # Padding slots: value 0 with a safe in-range source id.
    cols = np.full((nrow_pad, k), 0 if needs_all_gather else H,
                   dtype=np.int32)
    rows_idx = M.row_indices()
    slot = np.arange(M.nnz) - M.offs[rows_idx]
    vals[rows_idx, slot] = v
    cols[rows_idx, slot] = (c if needs_all_gather
                            else off + H).astype(np.int32)
    return RectHaloPlan(
        vals=torch.as_tensor(vals).to(dtype), cols=torch.as_tensor(cols),
        halo=H, nloc_rows=nloc_rows, nloc_cols=nloc_cols,
        needs_all_gather=needs_all_gather)


def local_rect_block(M: CsrMatrix, n_devices: int, rank: int,
                     nloc_rows: int, nloc_cols: int
                     ) -> tuple[CsrMatrix, int]:
    """(block, H): rank's rows of the rectangular M as an (nloc_rows ×
    nloc_cols + 2H) CSR over the source vector's halo-extended local
    coordinates, numbered as `build_rect_halo_plan` numbers them. Only
    meaningful where H ≤ nloc_cols."""
    plan = build_rect_halo_plan(M, n_devices, nloc_rows, nloc_cols,
                                torch.float64)
    lo = rank * nloc_rows
    vals = plan.vals[lo: lo + nloc_rows].numpy()
    cols = plan.cols[lo: lo + nloc_rows].numpy()
    n_ext = nloc_cols + 2 * plan.halo
    r, s = np.nonzero(vals)  # padding slots hold zeros
    if r.size == 0:  # a rank of padding rows only
        return (CsrMatrix(nloc_rows, n_ext, np.zeros(nloc_rows + 1, np.int64),
                          np.zeros(0, np.int32), np.zeros(0)), plan.halo)
    return (CsrMatrix.from_coo(r, cols[r, s], vals[r, s], nrows=nloc_rows,
                               ncols=n_ext), plan.halo)


def force_global_cols(A: CsrMatrix, plan: HaloSpmvPlan) -> HaloSpmvPlan:
    """Rebuild the plan's column ids as global indices (all_gather path)."""
    k = plan.vals.shape[1]
    cols = np.zeros((plan.n_pad, k), dtype=np.int32)
    rows_idx = A.row_indices()
    slot = np.arange(A.nnz) - A.offs[rows_idx]
    cols[rows_idx, slot] = A.cols
    return replace(plan, cols=torch.as_tensor(cols), needs_all_gather=True)


@dataclass
class HaloSellPlan:
    """One rank's operator for the sliced-ELL kernels: its (nloc × n_ext)
    block over the halo-extended local coordinates, as a `SellMatrix`
    (counterpart of the JAX package's `HaloBsrPlan`, whose stacked
    per-device 8×128 blocks ride into `shard_map`)."""
    sell: SellMatrix | None  # None where needs_all_gather
    rank: int
    n: int
    n_pad: int
    nloc: int
    halo: int
    n_devices: int
    n_ext: int               # nloc + 2*halo (extended local width)
    needs_all_gather: bool


def local_block(A: CsrMatrix, n_devices: int, rank: int,
                row_align: int = 8) -> tuple[CsrMatrix, int, int]:
    """(block, nloc, H): rank's rows of A as an (nloc × nloc + 2H) CSR,
    built as the JAX package builds each device's block (rows r − d·nloc,
    columns off + H); pad rows past n are empty. Only meaningful where
    H ≤ nloc."""
    r, c, v, dev, off, nloc, H = _partition(A, n_devices,
                                            max(row_align, 8))
    m = dev == rank
    n_ext = nloc + 2 * H
    if not m.any():  # a rank of padding rows only
        return (CsrMatrix(nloc, n_ext, np.zeros(nloc + 1, np.int64),
                          np.zeros(0, np.int32), np.zeros(0)), nloc, H)
    return (CsrMatrix.from_coo(r[m] - rank * nloc, off[m] + H, v[m],
                               nrows=nloc, ncols=n_ext), nloc, H)


def build_halo_sell_plan(A: CsrMatrix, n_devices: int, rank: int,
                         dtypes=(torch.float32,), row_align: int = 8,
                         device="cuda") -> HaloSellPlan:
    """The SELL layout of rank's block, with one value array per dtype in
    `dtypes` (f32 → K1/K3's operator, f64 → K2's), on `device`."""
    block, nloc, H = local_block(A, n_devices, rank, row_align)
    needs_all_gather = H > nloc
    sell = None if needs_all_gather else SellMatrix.from_csr(
        block, dtypes=dtypes, device=device)
    return HaloSellPlan(sell=sell, rank=rank, n=A.nrows,
                        n_pad=nloc * n_devices, nloc=nloc, halo=H,
                        n_devices=n_devices, n_ext=nloc + 2 * H,
                        needs_all_gather=needs_all_gather)


def fused_psum(mesh: RowMesh, *scalars):
    """One collective for all of an iteration's reductions.

    Stacks the scalars (0-d tensors, or (k,) tensors of per-column dots)
    and issues a SINGLE `dist.all_reduce`, as the JAX code issues one
    `psum`: the latency-bound part of a distributed Krylov iteration is its
    reductions. Every rank gets the same sums, so every branch taken on
    them is taken by all ranks together."""
    s = torch.stack(scalars)
    dist.all_reduce(s, group=mesh.group)
    return tuple(s.unbind())


def _halo_exchange(mesh: RowMesh, x_l: torch.Tensor, H: int) -> torch.Tensor:
    """Ring-exchange the H boundary rows of the local x with the left and
    right neighbours; works for (nloc,) vectors and (nloc, k) blocks alike.
    Returns the extended (nloc + 2H, ...) x: [left halo, x_l, right halo],
    a halo with no neighbour being zeros. The halos are received in place,
    into the contiguous row ranges of the extended x."""
    x_l = x_l.contiguous()
    nloc = x_l.shape[0]
    x_ext = x_l.new_empty((nloc + 2 * H, *x_l.shape[1:]))
    x_ext[H: H + nloc] = x_l
    left, right = x_ext[:H], x_ext[H + nloc:]
    ops = []
    # My first rows are my left neighbour's right halo, my last rows my
    # right neighbour's left halo.
    if mesh.rank > 0:
        ops += [dist.P2POp(dist.isend, x_l[:H], mesh.rank - 1),
                dist.P2POp(dist.irecv, left, mesh.rank - 1)]
    else:
        left.zero_()
    if mesh.rank < mesh.size - 1:
        ops += [dist.P2POp(dist.isend, x_l[nloc - H:], mesh.rank + 1),
                dist.P2POp(dist.irecv, right, mesh.rank + 1)]
    else:
        right.zero_()
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return x_ext


def halo_spmv_local(mesh: RowMesh, halo: int, vals_l, cols_l, x_l):
    """Halo exchange, then the gather-ELL local SpMV (any dtype).
    vals_l/cols_l: this rank's (nloc_rows, k) block; x_l: the source
    vector's (nloc_cols,) block, nloc_cols = nloc_rows for a square
    operator → (nloc_rows,)."""
    x_ext = _halo_exchange(mesh, x_l, halo)
    return torch.sum(vals_l * x_ext[cols_l], dim=1)


def halo_spmm_ell_local(mesh: RowMesh, halo: int, vals_l, cols_l, X_l):
    """Halo exchange + gather-ELL local SpMM. X_l: (nloc, k) → (nloc, k)."""
    X_ext = _halo_exchange(mesh, X_l, halo)
    return torch.einsum("ns,nsk->nk", vals_l, X_ext[cols_l])


def halo_spmv_sell_local(mesh: RowMesh, plan: HaloSellPlan, x_l):
    """Halo exchange + the SELL f32 kernel on the rank's block (the JAX
    package's `halo_spmv_bsr_local`, K1). x_l: (nloc,) → (nloc,) f32."""
    return spmv_sell(plan.sell, _halo_exchange(mesh, x_l.float(), plan.halo))


def halo_spmv_sell_f64_local(mesh: RowMesh, plan: HaloSellPlan, x_l):
    """Halo exchange + the SELL f64 kernel (the JAX package's
    `halo_spmv_bsr_df64_local`, K2). x_l: (nloc,) → (nloc,) f64."""
    return spmv_sell_f64(plan.sell,
                         _halo_exchange(mesh, x_l.double(), plan.halo))


def halo_spmm_sell_local(mesh: RowMesh, plan: HaloSellPlan, X_l):
    """Halo exchange of the RHS block + the SELL f32 SpMM (the JAX
    package's `halo_spmm_bsr_local`, K3): the k columns share one stream
    of the block's entries. X_l: (nloc, k) → (nloc, k) f32."""
    return spmm_sell(plan.sell, _halo_exchange(mesh, X_l.float(), plan.halo))


@dataclass
class DistMatvec:
    """This rank's operator and its matvec, shared by every distributed
    solver. `matvec(x_l)` takes the (nloc,) local x and `matmat(X_l)` the
    (nloc, k) local block; both are collective (every rank calls them
    together) and return this rank's rows in the requested dtype."""
    matvec: Callable
    matmat: Callable
    strategy: str           # "halo" | "all_gather"
    local_spmv: str         # "bsr" (the SELL kernels) | "ell"
    halo: int
    nloc: int
    n_pad: int
    n: int
    plan: HaloSpmvPlan


def build_dist_matvec(A: CsrMatrix, mesh: RowMesh, dtype,
                      strategy: str = "auto", local_spmv: str = "auto",
                      row_align: int = 8) -> DistMatvec:
    """Resolve (strategy, local_spmv) and build this rank's operator.

    local_spmv: "bsr" runs the SELL kernels (f32, or native f64 for f64)
    on the rank's block after the halo exchange, where the JAX package
    runs its Pallas BSR kernels; "ell" is the plain gather path. "auto"
    takes the JAX package's TPU branch on every device: "bsr" whenever the
    halo strategy holds (the port's rule for `resolve_layout("auto")`)."""
    n_dev = mesh.size
    plan = build_halo_plan(A, n_dev, dtype, row_align=row_align)
    if strategy == "auto":
        strategy = "all_gather" if plan.needs_all_gather else "halo"
    if strategy == "halo" and plan.needs_all_gather:
        raise ValueError(
            f"halo strategy impossible: halo {plan.halo} exceeds block "
            f"size {plan.nloc}; use all_gather (or reorder with RCM)")
    if strategy == "all_gather" and not plan.needs_all_gather:
        plan = force_global_cols(A, plan)

    if local_spmv == "auto":
        use_bsr = strategy == "halo"
    elif local_spmv == "bsr":
        if strategy != "halo":
            raise ValueError("local_spmv='bsr' requires the halo strategy "
                             "(banded matrix; try RCM)")
        use_bsr = True
    elif local_spmv == "ell":
        use_bsr = False
    else:
        raise ValueError(f"unknown local_spmv '{local_spmv}' "
                         "(auto | bsr | ell)")

    dev = mesh.device
    if use_bsr:
        sell_plan = build_halo_sell_plan(A, n_dev, mesh.rank, (dtype,),
                                         row_align=row_align, device=dev)
        if dtype == torch.float64:
            def matvec(x_l):
                return halo_spmv_sell_f64_local(mesh, sell_plan, x_l)

            def matmat(X_l):
                # One f64 SpMV per column: used only for the once-per-pass
                # f64 residual of the block solver (the f32 inner
                # iteration carries the SpMM traffic). One exchange serves
                # all columns.
                X_ext = _halo_exchange(mesh, X_l.double(), sell_plan.halo)
                return torch.stack(
                    [spmv_sell_f64(sell_plan.sell, X_ext[:, j].contiguous())
                     for j in range(X_ext.shape[1])], dim=1)
        else:
            def matvec(x_l):
                return halo_spmv_sell_local(mesh, sell_plan, x_l).to(dtype)

            def matmat(X_l):
                return halo_spmm_sell_local(mesh, sell_plan, X_l).to(dtype)
    else:
        rows = slice(mesh.rank * plan.nloc, (mesh.rank + 1) * plan.nloc)
        vals_l = plan.vals[rows].to(dev)
        cols_l = plan.cols[rows].to(device=dev, dtype=torch.int64)
        if strategy == "halo":
            H = plan.halo

            def matvec(x_l):
                return halo_spmv_local(mesh, H, vals_l, cols_l, x_l)

            def matmat(X_l):
                return halo_spmm_ell_local(mesh, H, vals_l, cols_l, X_l)
        else:
            def matvec(x_l):
                full = fetch_global(mesh, x_l, plan.n_pad)
                return torch.sum(vals_l * full[cols_l], dim=1)

            def matmat(X_l):
                full = fetch_global(mesh, X_l, plan.n_pad)
                return torch.einsum("ns,nsk->nk", vals_l, full[cols_l])

    return DistMatvec(
        matvec=matvec, matmat=matmat, strategy=strategy,
        local_spmv="bsr" if use_bsr else "ell", halo=plan.halo,
        nloc=plan.nloc, n_pad=plan.n_pad, n=plan.n, plan=plan)


class RowPartitioned:
    """The operator of a distributed solver class and the fields it
    reports: the 1-D partition's halo or all_gather product
    (`build_dist_matvec`). The 2-D grid's classes (`dist2d.On2dGrid`)
    override both methods; the iterations are the same."""

    def _matvec(self, A: CsrMatrix, dtype, strategy: str = "auto",
                local_spmv: str = "auto", row_align: int = 8) -> DistMatvec:
        return build_dist_matvec(A, self.mesh, dtype, strategy=strategy,
                                 local_spmv=local_spmv, row_align=row_align)

    def _layout_extra(self, halo: bool = True) -> dict:
        """The record's layout fields (`halo` where the JAX class reports
        it)."""
        out = {"strategy": self.strategy, "local_spmv": self.local_spmv}
        if halo:
            out["halo"] = self.plan.halo
        return out


class RowShard:
    """This rank's rows [rank·nloc, (rank+1)·nloc) of the partition's
    vectors, in the solver's ordering: `local` takes a global right-hand
    side (n,) or (n, k) in the caller's order to the rank's padded block
    (pad rows zero), `gather` takes the local blocks of x back to the
    global x in the caller's order, on every rank. The permutations are
    index tensors on the rank's device, made once."""

    def __init__(self, mesh: RowMesh, n: int, nloc: int,
                 ordering: DistOrdering):
        self.mesh, self.n, self.nloc = mesh, n, nloc
        dev = mesh.device
        self.lo = min(mesh.rank * nloc, n)
        self.hi = min((mesh.rank + 1) * nloc, n)
        rows = torch.arange(self.lo, self.hi, device=dev)
        self._rows = (rows if ordering.perm is None else
                      torch.as_tensor(ordering.perm, device=dev)[rows])
        self._inv = (None if ordering.inv is None else
                     torch.as_tensor(ordering.inv, device=dev))

    def local(self, b, dtype) -> torch.Tensor:
        b = torch.as_tensor(b, device=self.mesh.device)
        if b.shape[0] != self.n:
            raise ValueError(f"b has {b.shape[0]} entries, expected {self.n}")
        out = torch.zeros((self.nloc, *b.shape[1:]), dtype=dtype,
                          device=b.device)
        out[: self.hi - self.lo] = b[self._rows]
        return out

    def gather(self, x_l: torch.Tensor) -> torch.Tensor:
        x = fetch_global(self.mesh, x_l, self.n)
        return x if self._inv is None else x[self._inv]
