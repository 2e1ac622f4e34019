"""Sliced-ELL SpMV and SpMM: the solver paths' f32 and f64 products,
hand-written CUDA kernels (`csrc/sell_spmv.cu`, `csrc/sell_spmm.cu`) beside
their plain PyTorch versions.

    spmv_sell(S, x)      f32 y = A·x over `S.vals`    (the redesigned K1, K5)
    spmv_sell_f64(S, x)  f64 y = A·x over `S.vals64`  (the redesigned K2)
    spmm_sell(S, X)      f32 Y = A·X, X (ncols, k)    (the redesigned K3)

They take the place of `spmv_bsr`, `spmv_bsr_classed`, `spmv_bsr_df64` /
`spmv_bsr_df64_lo` and `spmm_bsr` on every solver path
(`solvers/cg.py::build_matvec`, `solvers/refine.py::f64_residual_matvec`,
`solvers/block_cg.py::MultiRhsIrSolver`); those stay in `ops/spmv_bsr.py`.
The f64 product is an exact f64 matvec, where the TPU kernel reached f64
accuracy with double-float arithmetic on hi/lo f32 pairs. The SpMM reads X
in place, row-major as the solvers hold it, and sums each column in entry
order as the f32 SpMV does, so `spmm_sell(S, X)[:, j]` is
`spmv_sell(S, X[:, j])` bit for bit on the card.

The layout (`matrix/sell.py`) is validated once when it is built, so a
call checks only x, allocates y and launches once, with the entry point
looked up once and the raw stream handle taken without a Stream object
(`_cuda.launch`): the wrapper's host time is what a kernel of a few
microseconds shows.
Dispatch: x on the CPU with the layout on the CPU runs the plain version;
x on the layout's CUDA device launches the kernel; anything else raises.
There is no fallback from a CUDA tensor to the plain version. Each launch
adds one to `LAUNCHES["sell_f32"]`, `LAUNCHES["sell_f64"]` or
`LAUNCHES["sell_mm_f32"]`; the BSR K6, K7 and K8 (`ops/spmv_bsr.py`) run
the f32 kernel on their packed layouts through `launch` and count there.
With `--debug-nans` (`utils/debug.py`) each wrapper raises
`FloatingPointError` on a NaN in its output, from the kernel or the plain
version.
"""

from __future__ import annotations

import torch

from lsbench_tpu_torch.matrix.sell import SLICE, SellMatrix
from lsbench_tpu_torch.ops import _cuda  # builds nothing until first launch
from lsbench_tpu_torch.utils.debug import checked

LAUNCHES = {"sell_f32": 0, "sell_f64": 0, "sell_mm_f32": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _plain(S: SellMatrix, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Gather, multiply and sum over each row's entries, for x of shape
    (ncols,) or (ncols, k): entry e of slice s belongs to row 32·s + e % 32
    (slice offsets are multiples of 32)."""
    dev = x.device
    vals = vals if x.dim() == 1 else vals[:, None]
    prod = vals * x[S.cols.long()]
    slice_of = torch.repeat_interleave(
        torch.arange(S.n_slices, device=dev), torch.diff(S.slice_off),
        output_size=S.n_stored)
    rows = slice_of * SLICE + torch.arange(S.n_stored, device=dev) % SLICE
    y = torch.zeros((S.n_slices * SLICE, *x.shape[1:]), dtype=vals.dtype,
                    device=dev)
    return y.index_add_(0, rows, prod)[: S.nrows]


def spmv_sell_plain(S: SellMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch f32 y = A·x over the SELL layout."""
    return _plain(S, S.vals, x)


def spmv_sell_f64_plain(S: SellMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch f64 y = A·x over the SELL layout."""
    return _plain(S, S.vals64, x)


def spmm_sell_plain(S: SellMatrix, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch f32 Y = A·X over the SELL layout, X (ncols, k)."""
    return _plain(S, S.vals, X)


def launch(S: SellMatrix, vals, x: torch.Tensor, dtype: torch.dtype,
           ndim: int, name: str, counter: str,
           counts: dict = LAUNCHES) -> torch.Tensor:
    """Check x, (ncols,) for the SpMV or (ncols, k) with k >= 1 for the
    SpMM, then run the plain version (CPU) or launch the kernel `name` (x on
    the layout's CUDA device) and add one to `counts[counter]`; y has x's
    shape with nrows rows."""
    if vals is None:
        raise ValueError(f"{name}: the SELL layout holds no {dtype} values")
    if x.dtype != dtype:
        raise TypeError(f"{name}: x must be {dtype}, got {x.dtype}")
    if (x.dim() != ndim or x.shape[0] != S.ncols or x.numel() == 0
            or not x.is_contiguous()):
        want = f"({S.ncols},)" if ndim == 1 else f"({S.ncols}, k >= 1)"
        raise ValueError(f"{name}: x must be contiguous of shape {want}, "
                         f"got {tuple(x.shape)}")
    dev = x.device
    if dev != vals.device:
        raise ValueError(f"{name}: x on {dev}, the layout on {vals.device}")
    if dev.type == "cpu":
        return checked(_plain(S, vals, x), name)
    if dev.type != "cuda":
        raise ValueError(f"{name}: operands on {dev}: need the CPU (plain "
                         "version) or a CUDA device (kernel)")
    k = tuple(x.shape[1:])  # () for the SpMV, (k,) for the SpMM
    y = torch.empty((S.nrows, *k), dtype=dtype, device=dev)
    _cuda.launch(_cuda.entry(_STEM[name], name), name, dev,
                 vals.data_ptr(), S.cols.data_ptr(), S.slice_off.data_ptr(),
                 x.data_ptr(), y.data_ptr(), S.nrows, *k)
    counts[counter] += 1
    return checked(y, name)


_STEM = {"spmv_sell_f32": "sell_spmv", "spmv_sell_f64": "sell_spmv",
         "spmm_sell_f32": "sell_spmm"}  # each kernel's source


def spmv_sell(S: SellMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x in f32: x (ncols,) f32 → y (nrows,) f32."""
    return launch(S, S.vals, x, torch.float32, 1, "spmv_sell_f32",
                  "sell_f32")


def spmv_sell_f64(S: SellMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A·x in f64: x (ncols,) f64 → y (nrows,) f64."""
    return launch(S, S.vals64, x, torch.float64, 1, "spmv_sell_f64",
                  "sell_f64")


def spmm_sell(S: SellMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A·X in f32 for k right-hand sides: X (ncols, k) f32, row-major
    and contiguous, k >= 1 → Y (nrows, k) f32."""
    return launch(S, S.vals, X, torch.float32, 2, "spmm_sell_f32",
                  "sell_mm_f32")
