"""Sliced ELL with slices of 32 rows (SELL-32): the layout of the solver
paths' f32 and f64 SpMV and f32 SpMM on the card (kernels
`csrc/sell_spmv.cu` and `csrc/sell_spmm.cu`, wrappers `ops/spmv_sell.py`).

It takes the place of the uniform `BsrMatrix` (K1 and the SpMM K3), the
class-padded `BsrClassed` (K5) and the f64-accurate `BsrDf64` (K2) on the
solver paths; those stay, behind the ops API of `ops/spmv_bsr.py`. The JAX
package has no counterpart: its 8×128 blocks match the TPU's (8, 128) vreg
tile, and on an RCM-ordered 5-point Poisson matrix fewer than 1% of their
stored elements are nonzero.

Rows keep their order and are cut into slices of SLICE = 32 consecutive
rows, one warp each. Each slice is padded to its own widest row (w_s
entries) and stored column-major inside the slice, so a warp's j-th load
is one coalesced request:

    cols      (n_stored,) int32        column of each entry
    slice_off (n_slices + 1,) int64    entry j of row 32·s + l lies at
                                       slice_off[s] + 32·j + l;
                                       slice_off[s+1] − slice_off[s] = 32·w_s
    vals      (n_stored,) f32 or None  values of the f32 product
    vals64    (n_stored,) f64 or None  values of the f64 product

Padding entries have value 0 and repeat their row's last column (column 0
in an empty row), so they read an x entry the row reads anyway. Rows past
`nrows` in the last slice are padding too; the kernels never write them.
One structure serves both products: `with_f64` adds the f64 values to an
f32 layout and shares `cols` and `slice_off` with it.

Built with torch ops from the (RCM-ordered) `CsrMatrix` on the host and
uploaded (`device=`), or from row-sorted entries on their own device
(`from_rows`: the packed forms of a `BsrMatrix` or a `BsrCompact`,
`matrix/bsr.py`);
validated once here, so the wrappers check only x per call.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix

SLICE = 32  # rows per slice: one warp, one row per thread

_VALUE_FIELDS = {torch.float32: "vals", torch.float64: "vals64"}


@dataclass
class SellMatrix:
    cols: torch.Tensor                   # (n_stored,) int32
    slice_off: torch.Tensor              # (n_slices + 1,) int64
    vals: torch.Tensor | None            # (n_stored,) f32
    vals64: torch.Tensor | None          # (n_stored,) f64
    nrows: int
    ncols: int
    nnz: int

    @property
    def n_slices(self) -> int:
        return self.slice_off.numel() - 1

    @property
    def n_stored(self) -> int:
        return self.cols.numel()

    @property
    def device(self) -> torch.device:
        return self.cols.device

    @property
    def widths(self) -> np.ndarray:
        """Each slice's width w_s (host copy)."""
        return np.diff(self.slice_off.cpu().numpy()) // SLICE

    @property
    def bytes_streamed(self) -> int:
        """Bytes of the layout arrays held: cols, slice_off and each value
        array (an f32-only layout: what the f32 product reads)."""
        held = [t for t in (self.vals, self.vals64) if t is not None]
        return (4 * self.n_stored + 8 * self.slice_off.numel()
                + sum(t.numel() * t.element_size() for t in held))

    @staticmethod
    def from_csr(A: CsrMatrix, dtypes=(torch.float32,),
                 device="cuda") -> "SellMatrix":
        """The layout of A with one value array per dtype in `dtypes`
        (torch.float32 → `vals`, torch.float64 → `vals64`)."""
        cols, slice_off, pos = _csr_plan(A)
        vals = torch.as_tensor(A.vals)
        values = {"vals": None, "vals64": None}
        for dt in dtypes:
            values[_VALUE_FIELDS[dt]] = _values(vals, pos, cols.numel(), dt)
        S = SellMatrix(cols=cols, slice_off=slice_off, **values,
                       nrows=A.nrows, ncols=A.ncols, nnz=A.nnz)
        _validate(S)
        return S.to(device)

    @staticmethod
    def from_rows(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                  nrows: int, ncols: int) -> "SellMatrix":
        """The f32 layout of the entries (rows[i], cols[i], vals[i]), with
        `rows` ascending and each row's entries in the order its sum takes
        them; built with torch ops on the entries' device, no host copy."""
        out_cols, slice_off, pos = _plan(rows, cols, nrows)
        S = SellMatrix(cols=out_cols, slice_off=slice_off,
                       vals=_values(vals, pos, out_cols.numel(),
                                    torch.float32),
                       vals64=None, nrows=nrows, ncols=ncols,
                       nnz=rows.numel())
        _validate(S)
        return S

    def with_f64(self, A: CsrMatrix) -> "SellMatrix":
        """This layout with A's f64 values beside its own, sharing `cols`
        and `slice_off`. A must be the matrix it was built from."""
        if self.vals64 is not None:
            return self
        cols, slice_off, pos = _csr_plan(A)
        if ((A.nrows, A.ncols, A.nnz) != (self.nrows, self.ncols, self.nnz)
                or not torch.equal(slice_off, self.slice_off.cpu())
                or not torch.equal(cols, self.cols.cpu())):
            raise ValueError("with_f64: A is not the matrix this SELL layout "
                             "was built from")
        vals64 = _values(torch.as_tensor(A.vals), pos, cols.numel(),
                         torch.float64)
        out = dataclasses.replace(self, vals64=vals64.to(self.device))
        _validate(out)
        return out

    def to(self, device) -> "SellMatrix":
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(self, cols=self.cols.to(device),
                                   slice_off=self.slice_off.to(device),
                                   vals=move(self.vals),
                                   vals64=move(self.vals64))


def _csr_plan(A: CsrMatrix):
    return _plan(torch.from_numpy(A.row_indices()),
                 torch.as_tensor(A.cols, dtype=torch.int32), A.nrows)


def _plan(rows: torch.Tensor, cols: torch.Tensor, nrows: int):
    """(cols int32, slice_off int64, pos int64) of the entries (rows int64
    ascending, cols int32), on their device: the column array with its
    padding, the slice offsets, and the stored position of each entry."""
    dev = rows.device
    lens = torch.bincount(rows, minlength=nrows)
    n_slices = -(-nrows // SLICE)
    padded = torch.zeros(n_slices * SLICE, dtype=torch.int64, device=dev)
    padded[:nrows] = lens
    width = padded.view(n_slices, SLICE).amax(dim=1)
    slice_off = torch.zeros(n_slices + 1, dtype=torch.int64, device=dev)
    torch.cumsum(width * SLICE, 0, out=slice_off[1:])
    n_stored = int(slice_off[-1])
    offs = torch.zeros(nrows + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=offs[1:])

    # Every stored slot starts as its row's last column, then the entries
    # take their places.
    last = torch.zeros(n_slices * SLICE, dtype=torch.int32, device=dev)
    full = lens > 0
    last[:nrows][full] = cols[offs[1:][full] - 1]
    slot = torch.arange(n_stored, device=dev)
    slot_row = (torch.repeat_interleave(
        torch.arange(n_slices, device=dev), width * SLICE,
        output_size=n_stored) * SLICE + slot % SLICE)
    out = last[slot_row]
    j = torch.arange(rows.numel(), device=dev) - offs[rows]
    pos = slice_off[rows // SLICE] + SLICE * j + rows % SLICE
    out[pos] = cols
    return out, slice_off, pos


def _values(vals: torch.Tensor, pos: torch.Tensor, n_stored: int,
            dtype: torch.dtype) -> torch.Tensor:
    v = torch.zeros(n_stored, dtype=dtype, device=pos.device)
    v[pos] = vals.to(dtype)  # f32 from f64: each value rounded once
    return v


def _validate(S: SellMatrix) -> None:
    """What the kernels assume of the arrays; the wrappers check only x."""
    def check(t, name, dtype, shape):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"SELL {name}: expected contiguous {dtype} of "
                             f"shape {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != S.cols.device:
            raise ValueError(f"SELL {name} on {t.device}, cols on "
                             f"{S.cols.device}")

    if not 0 < S.nrows < 2**31:
        raise ValueError(f"SELL: {S.nrows} rows outside the kernels' int32 "
                         "row range")
    check(S.cols, "cols", torch.int32, (S.n_stored,))
    check(S.slice_off, "slice_off", torch.int64, (-(-S.nrows // SLICE) + 1,))
    if S.vals is None and S.vals64 is None:
        raise ValueError("SELL: no value array")
    if S.vals is not None:
        check(S.vals, "vals", torch.float32, (S.n_stored,))
    if S.vals64 is not None:
        check(S.vals64, "vals64", torch.float64, (S.n_stored,))
    # The kernels read x[cols[e]] in place for every stored entry, padding
    # included: every column must lie inside x.
    if S.n_stored and not (0 <= int(S.cols.min())
                           and int(S.cols.max()) < S.ncols):
        raise ValueError(f"SELL cols outside [0, {S.ncols}): the kernels "
                         "read x in place")
