"""Sliced-ELL SpMV: the solver paths' f32 and f64 products, hand-written
CUDA kernels (`csrc/sell_spmv.cu`) beside their plain PyTorch versions.

    spmv_sell(S, x)      f32 y = A·x over `S.vals`    (the redesigned K1, K5)
    spmv_sell_f64(S, x)  f64 y = A·x over `S.vals64`  (the redesigned K2)

They take the place of `spmv_bsr`, `spmv_bsr_classed` and `spmv_bsr_df64` /
`spmv_bsr_df64_lo` on every solver path (`solvers/cg.py::build_matvec`,
`solvers/refine.py::f64_residual_matvec`); those stay in
`ops/spmv_bsr.py`. The f64 product is an exact f64 matvec, where the TPU
kernel reached f64 accuracy with double-float arithmetic on hi/lo f32
pairs.

The layout (`matrix/sell.py`) is validated once when it is built, so a
call checks only x, allocates y and launches once, with the entry point
looked up once and the raw stream handle taken without a Stream object:
the wrapper's host time is what a kernel of a few microseconds shows. Dispatch: x on the CPU with
the layout on the CPU runs the plain version; x on the layout's CUDA
device launches the kernel; anything else raises. There is no fallback
from a CUDA tensor to the plain version. Each launch adds one to
`LAUNCHES["sell_f32"]` or `LAUNCHES["sell_f64"]`.
"""

from __future__ import annotations

import torch

from lsbench_tpu_torch.matrix.sell import SLICE, SellMatrix
from lsbench_tpu_torch.ops import _cuda  # builds nothing until first launch

LAUNCHES = {"sell_f32": 0, "sell_f64": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _plain(S: SellMatrix, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Gather, multiply and sum over each row's entries: entry k of slice s
    belongs to row 32·s + k % 32 (slice offsets are multiples of 32)."""
    dev = x.device
    prod = vals * x[S.cols.long()]
    slice_of = torch.repeat_interleave(
        torch.arange(S.n_slices, device=dev), torch.diff(S.slice_off),
        output_size=S.n_stored)
    rows = slice_of * SLICE + torch.arange(S.n_stored, device=dev) % SLICE
    y = torch.zeros(S.n_slices * SLICE, dtype=vals.dtype, device=dev)
    return y.index_add_(0, rows, prod)[: S.nrows]


def spmv_sell_plain(S: SellMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch f32 y = A·x over the SELL layout."""
    return _plain(S, S.vals, x)


def spmv_sell_f64_plain(S: SellMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch f64 y = A·x over the SELL layout."""
    return _plain(S, S.vals64, x)


def _spmv(S: SellMatrix, vals, x: torch.Tensor, dtype: torch.dtype,
          name: str, counter: str) -> torch.Tensor:
    if vals is None:
        raise ValueError(f"{name}: the SELL layout holds no {dtype} values")
    if x.dtype != dtype:
        raise TypeError(f"{name}: x must be {dtype}, got {x.dtype}")
    if x.shape != (S.ncols,) or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous of shape "
                         f"({S.ncols},), got {tuple(x.shape)}")
    dev = x.device
    if dev != vals.device:
        raise ValueError(f"{name}: x on {dev}, the layout on {vals.device}")
    if dev.type == "cpu":
        return _plain(S, vals, x)
    if dev.type != "cuda":
        raise ValueError(f"{name}: operands on {dev}: need the CPU (plain "
                         "version) or a CUDA device (kernel)")
    fn = _ENTRIES.get(name) or _entry(name)
    y = torch.empty(S.nrows, dtype=dtype, device=dev)
    idx = dev.index
    # PyTorch's current stream of x's device as a raw handle (the accessor
    # PyTorch's own generated launchers use: it builds no Stream object).
    args = (vals.data_ptr(), S.cols.data_ptr(), S.slice_off.data_ptr(),
            x.data_ptr(), y.data_ptr(), S.nrows,
            torch._C._cuda_getCurrentRawStream(idx))
    if idx == torch._C._cuda_getDevice():
        rc = fn(*args)
    else:
        with torch.cuda.device(idx):
            rc = fn(*args)
    _cuda.check(rc, name)
    LAUNCHES[counter] += 1
    return y


_ENTRIES: dict = {}


def _entry(name: str):
    """The ctypes entry point `lsb_<name>`, built and loaded on first use."""
    _ENTRIES[name] = getattr(_cuda.library("sell_spmv"), "lsb_" + name)
    return _ENTRIES[name]


def spmv_sell(S: SellMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x in f32: x (ncols,) f32 → y (nrows,) f32."""
    return _spmv(S, S.vals, x, torch.float32, "spmv_sell_f32", "sell_f32")


def spmv_sell_f64(S: SellMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x in f64: x (ncols,) f64 → y (nrows,) f64."""
    return _spmv(S, S.vals64, x, torch.float64, "spmv_sell_f64", "sell_f64")
