"""BSR SpMV on the cg_ir main path: three hand-written CUDA kernels, each
beside its plain PyTorch version.

Counterpart of `lsbench_tpu/ops/spmv_pallas.py`, with its public signatures:

    spmv_bsr(A, x)                     K1  f32, uniform BsrMatrix
    spmv_bsr_classed(A, x)             K5  f32, class-padded BsrClassed
    spmv_bsr_df64(A, x)                K2  f64-accurate, BsrDf64 (hi, lo)
    spmv_bsr_df64_lo(A, blocks_lo, x)  K2  hi from the f32 BsrMatrix

Dispatch: tensors on the CPU go to the `*_plain` version (gather + einsum,
the JAX package's `matvec_reference`); tensors on one CUDA device launch
the kernel (`csrc/bsr_spmv.cu`) or raise. There is no fallback from a
CUDA tensor to the plain version. Each kernel launch adds one to its count
in `LAUNCHES`, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import torch

from lsbench_tpu_torch.matrix.bsr import (BC, BR, GPS, BsrClassed, BsrDf64,
                                          BsrMatrix)
from lsbench_tpu_torch.ops import _cuda  # builds nothing until first launch

LAUNCHES = {"bsr_f32": 0, "bsr_classed_f32": 0, "bsr_f64acc": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for all-CPU tensors, False for tensors on one CUDA device;
    raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) == 1:
        (dev,) = devices
        if dev.type in ("cpu", "cuda"):
            return dev.type == "cpu"
    raise ValueError(f"BSR SpMV operands on {sorted(map(str, devices))}: "
                     "need all on the CPU (plain version) or all on one "
                     "CUDA device (kernel)")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _x_table(x: torch.Tensor, ncols: int, n_cb: int,
             dtype: torch.dtype) -> torch.Tensor:
    """x zero-padded to (n_cb, 128) in `dtype`."""
    if x.shape != (ncols,):
        raise ValueError(f"x: expected shape ({ncols},), got {tuple(x.shape)}")
    xt = torch.zeros(n_cb * BC, dtype=dtype, device=x.device)
    xt[:ncols] = x
    return xt.view(n_cb, BC)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# --------------------------------------------------------------- K1: f32

def spmv_bsr_plain(A: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A @ x over uniform BSR (f32)."""
    xb = _x_table(x, A.ncols, A.n_col_blocks, torch.float32)
    gathered = xb[A.block_cols.long()]                       # (G, S, 128)
    blk = A.blocks.view(A.n_groups, A.slots, BR, BC)
    y = torch.einsum("gsrc,gsc->gr", blk, gathered)
    return y.reshape(-1)[: A.nrows]


def spmv_bsr(A: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (f32). x: (ncols,) → y: (nrows,)."""
    _check(A.blocks, "blocks", torch.float32,
           (A.n_groups, A.slots * BR, BC))
    _check(A.block_cols, "block_cols", torch.int32, (A.n_groups, A.slots))
    if _on_cpu(A.blocks, A.block_cols, x):
        return spmv_bsr_plain(A, x)
    lib = _cuda.library()
    xt = _x_table(x, A.ncols, A.n_col_blocks, torch.float32)
    y = torch.empty((A.n_groups, BR), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.lsb_spmv_bsr_f32(
            A.blocks.data_ptr(), A.block_cols.data_ptr(), xt.data_ptr(),
            y.data_ptr(), A.n_groups, A.slots, _stream(x.device))
    _cuda.check(rc, "spmv_bsr_f32")
    LAUNCHES["bsr_f32"] += 1
    return y.view(-1)[: A.nrows]


# ------------------------------------------------------ K5: classed f32

def spmv_bsr_classed_plain(A: BsrClassed, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A @ x over class-padded BSR (f32)."""
    xb = _x_table(x, A.ncols, A.n_col_blocks, torch.float32)
    y = torch.zeros((A.n_groups, BR), dtype=torch.float32, device=x.device)
    local = torch.arange(GPS, device=x.device)
    for blocks, bcols, oidx in zip(A.blocks, A.bcols, A.oidx):
        ng = blocks.shape[0]
        S = blocks.shape[1] // BR
        gathered = xb[bcols.view(ng, S).long()]              # (ng, S, 128)
        part = torch.einsum("gsrc,gsc->gr",
                            blocks.view(ng, S, BR, BC), gathered)
        rows = (oidx.long()[:, None] * GPS + local[None, :]).reshape(-1)
        y[rows] = part
    return y.reshape(-1)[: A.nrows]


def spmv_bsr_classed(A: BsrClassed, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over the class-padded layout (f32): one launch per class."""
    for blocks, bcols, oidx in zip(A.blocks, A.bcols, A.oidx):
        ng = blocks.shape[0]
        if ng % GPS or blocks.shape[1] % BR:
            raise ValueError(f"classed blocks of shape {tuple(blocks.shape)}"
                             f" do not tile by {GPS} groups of {BR} rows")
        S = blocks.shape[1] // BR
        _check(blocks, "blocks", torch.float32, (ng, S * BR, BC))
        _check(bcols, "bcols", torch.int32, (ng * S,))
        _check(oidx, "oidx", torch.int32, (ng // GPS,))
    tensors = [*A.blocks, *A.bcols, *A.oidx, x]
    if _on_cpu(*tensors):
        return spmv_bsr_classed_plain(A, x)
    lib = _cuda.library()
    xt = _x_table(x, A.ncols, A.n_col_blocks, torch.float32)
    y = torch.zeros((A.n_groups, BR), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = _stream(x.device)
        for blocks, bcols, oidx in zip(A.blocks, A.bcols, A.oidx):
            rc = lib.lsb_spmv_bsr_classed_f32(
                blocks.data_ptr(), bcols.data_ptr(), oidx.data_ptr(),
                xt.data_ptr(), y.data_ptr(), blocks.shape[0],
                blocks.shape[1] // BR, stream)
            _cuda.check(rc, "spmv_bsr_classed_f32")
            LAUNCHES["bsr_classed_f32"] += 1
    return y.view(-1)[: A.nrows]


# ---------------------------------------------------- K2: f64-accurate

def _f64acc_plain(hi, lo, block_cols, ncols, nrows, n_cb, x):
    xb = _x_table(x, ncols, n_cb, torch.float64)
    G, S = block_cols.shape
    a = (hi.double() + lo.double()).view(G, S, BR, BC)
    y = torch.einsum("gsrc,gsc->gr", a, xb[block_cols.long()])
    return y.reshape(-1)[:nrows]


def _f64acc(hi, lo, block_cols, ncols, nrows, n_cb, x):
    G, S = block_cols.shape
    _check(hi, "blocks_hi", torch.float32, (G, S * BR, BC))
    _check(lo, "blocks_lo", torch.float32, (G, S * BR, BC))
    _check(block_cols, "block_cols", torch.int32)
    if _on_cpu(hi, lo, block_cols, x):
        return _f64acc_plain(hi, lo, block_cols, ncols, nrows, n_cb, x)
    lib = _cuda.library()
    xt = _x_table(x, ncols, n_cb, torch.float64)
    y = torch.empty((G, BR), dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.lsb_spmv_bsr_f64acc(
            hi.data_ptr(), lo.data_ptr(), block_cols.data_ptr(),
            xt.data_ptr(), y.data_ptr(), G, S, _stream(x.device))
    _cuda.check(rc, "spmv_bsr_f64acc")
    LAUNCHES["bsr_f64acc"] += 1
    return y.view(-1)[:nrows]


def spmv_bsr_df64_plain(A: BsrDf64, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch f64 y = (hi + lo) @ x."""
    return _f64acc_plain(A.blocks_hi, A.blocks_lo, A.block_cols, A.ncols,
                         A.nrows, A.n_col_blocks, x)


def spmv_bsr_df64(A: BsrDf64, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x to f64 accuracy: x (f64) → y (f64)."""
    return _f64acc(A.blocks_hi, A.blocks_lo, A.block_cols, A.ncols, A.nrows,
                   A.n_col_blocks, x)


def spmv_bsr_df64_lo_plain(A: BsrMatrix, blocks_lo: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch f64 y = (A.blocks + blocks_lo) @ x."""
    return _f64acc_plain(A.blocks, blocks_lo, A.block_cols, A.ncols,
                         A.nrows, A.n_col_blocks, x)


def spmv_bsr_df64_lo(A: BsrMatrix, blocks_lo: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """f64-accurate SpMV with the hi blocks taken from the f32 BsrMatrix
    (bit-identical to BsrDf64.blocks_hi of the same CSR), so a
    mixed-precision solver holds one hi array for both of its SpMVs."""
    return _f64acc(A.blocks, blocks_lo, A.block_cols, A.ncols, A.nrows,
                   A.n_col_blocks, x)
