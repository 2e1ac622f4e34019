"""BSR SpMV: the hand-written CUDA kernels, each beside its plain PyTorch
version.

Counterpart of `lsbench_tpu/ops/spmv_pallas.py`, with its public signatures:

    spmv_bsr(A, x)                     K1  f32, uniform BsrMatrix
    spmv_bsr(A, x, variant="selector") K7  x gathered through A.sel
    spmv_bsr(A, x, variant="onehot")   K8  x gathered through a one-hot
                                           of A.block_cols
    spmv_bsr_classed(A, x)             K5  f32, class-padded BsrClassed
    spmv_bsr_df64(A, x)                K2  f64-accurate, BsrDf64 (hi, lo)
    spmv_bsr_df64_lo(A, blocks_lo, x)  K2  hi from the f32 BsrMatrix
    spmm_bsr(A, X)                     K3  f32, k right-hand sides
    spmv_bsr_compact(A, x)             K6  f32, exact-block BsrCompact

Dispatch: tensors on the CPU go to the `*_plain` version (gather + einsum,
the JAX package's `matvec_reference`); tensors on one CUDA device launch
the kernel (`csrc/bsr_spmv.cu`) or raise. K6, K7 and K8 on the card run
the SELL f32 kernel (`csrc/sell_spmv.cu`) over the layout's packed form
(`BsrCompact.packed`; `BsrMatrix.packed` for K7's and K8's gather rules):
over 99% of the dense 8×128 blocks are zeros on the matrices the port
runs, and the TPU kernels' one-hot products only avoid scalar-indexed
loads, which are a plain gather on Hopper, so the layout is resolved once
into its nonzeros and each call streams those alone. There is no
fallback from a CUDA tensor to the plain version. Each kernel launch adds
one to its count in `LAUNCHES`, so a run can show that it went through the
kernels. K6–K8 sit on no solver path, as in the JAX package: this API is
their entry.
"""

from __future__ import annotations

import torch

from lsbench_tpu_torch.matrix.bsr import (BC, BR, GPS, BsrClassed,
                                          BsrCompact, BsrDf64, BsrMatrix)
from lsbench_tpu_torch.ops import _cuda  # builds nothing until first launch
from lsbench_tpu_torch.ops import spmv_sell
from lsbench_tpu_torch.utils.precision import full_f32

LAUNCHES = {"bsr_f32": 0, "bsr_classed_f32": 0, "bsr_f64acc": 0,
            "bsr_mm_f32": 0, "bsr_compact_f32": 0, "bsr_selector_f32": 0,
            "bsr_onehot_f32": 0}
VARIANTS = ("auto", "prefetch", "selector", "onehot")


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


def spmv_bsr(A: BsrMatrix, x: torch.Tensor,
             variant: str = "auto") -> torch.Tensor:
    """y = A @ x (f32). x: (ncols,) → y: (nrows,). `variant` picks how the
    x rows are gathered: "auto"/"prefetch" by block column index (K1),
    "selector" through the one-hot selector `A.sel` (K7; built on first
    use), "onehot" through the one-hot of `A.block_cols` (K8); on the card
    both run over the layout's packed form (`BsrMatrix.packed`)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown spmv_bsr variant '{variant}' (one of "
                         f"{', '.join(VARIANTS)})")
    if variant in _GATHERS:
        return _spmv_bsr_gather(A, x, variant)
    _check(A.blocks, "blocks", torch.float32,
           (A.n_groups, A.slots * BR, BC))
    _check(A.block_cols, "block_cols", torch.int32, (A.n_groups, A.slots))
    if _on_cpu(A.blocks, A.block_cols, x):
        return spmv_bsr_plain(A, x)
    lib = _cuda.library("bsr_spmv")
    xt = _x_table(x, A.ncols, A.n_col_blocks, torch.float32)
    y = torch.empty((A.n_groups, BR), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.lsb_spmv_bsr_f32(
            A.blocks.data_ptr(), A.block_cols.data_ptr(), xt.data_ptr(),
            y.data_ptr(), A.n_groups, A.slots, _stream(x.device))
    _cuda.check(rc, "spmv_bsr_f32")
    LAUNCHES["bsr_f32"] += 1
    return y.view(-1)[: A.nrows]


# ------------------------------------------- K7, K8: gathers by one-hot

def _slot_rows(A: BsrMatrix, g: torch.Tensor) -> torch.Tensor:
    """y from the gathered x rows g (G*S, 128): the slot einsum."""
    blk = A.blocks.view(A.n_groups, A.slots, BR, BC)
    y = torch.einsum("gsrc,gsc->gr", blk, g.view(A.n_groups, A.slots, BC))
    return y.reshape(-1)[: A.nrows]


def spmv_bsr_selector_plain(A: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K7: g = sel @ x_table in full f32, then the slots."""
    xt = _x_table(x, A.ncols, A.n_col_blocks, torch.float32)
    with full_f32():
        g = torch.matmul(A.ensure_sel().sel, xt)
    return _slot_rows(A, g)


def spmv_bsr_onehot_plain(A: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K8: the one-hot (G*S, C) of block_cols against the
    column iota, its product with the x table in full f32, then the slots
    (a column id outside [0, C) gathers 0)."""
    C = A.n_col_blocks
    xt = _x_table(x, A.ncols, C, torch.float32)
    iota = torch.arange(C, dtype=torch.int32, device=x.device)
    onehot = (A.block_cols.reshape(-1, 1) == iota).to(torch.float32)
    with full_f32():
        g = torch.matmul(onehot, xt)
    return _slot_rows(A, g)


# Gather rule → (plain version, launch counter).
_GATHERS = {"selector": (spmv_bsr_selector_plain, "bsr_selector_f32"),
            "onehot": (spmv_bsr_onehot_plain, "bsr_onehot_f32")}


def _spmv_bsr_gather(A: BsrMatrix, x: torch.Tensor, rule: str) -> torch.Tensor:
    """K7 and K8. On the CPU the plain version, the JAX semantics. On a
    CUDA device the SELL f32 kernel over the layout's packed form for
    `rule` (`BsrMatrix.packed`: built on the first call, cached), x read in
    place and checked alone, as `spmv_sell` does."""
    plain, counter = _GATHERS[rule]
    if x.is_cuda:
        if A.blocks.device != x.device:
            raise ValueError(f"BSR SpMV operands on {A.blocks.device} and "
                             f"{x.device}: need one CUDA device")
        P = A.packed(rule)
        return spmv_sell.launch(P, P.vals, x, torch.float32, 1,
                                "spmv_sell_f32", counter, LAUNCHES)
    G, S = A.n_groups, A.slots
    _check(A.blocks, "blocks", torch.float32, (G, S * BR, BC))
    if rule == "selector":
        gather = A.ensure_sel().sel
        _check(gather, "sel", torch.float32, (G * S, A.n_col_blocks))
    else:
        gather = A.block_cols
        _check(gather, "block_cols", torch.int32, (G, S))
    _on_cpu(A.blocks, gather, x)  # x is off CUDA: raises unless all on CPU
    return plain(A, x)


# ----------------------------------------------- K6: exact-block f32

def spmv_bsr_compact_plain(A: BsrCompact, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A @ x over the exact-block layout (the JAX
    package's `matvec_reference`: per-block row sums index-added into
    y[gid])."""
    xt = _x_table(x, A.ncols, A.n_col_blocks, torch.float32)
    part = torch.einsum("trc,tc->tr", A.blocks, xt[A.bcols.long()])
    y = torch.zeros((A.n_groups, BR), dtype=torch.float32, device=x.device)
    y.index_add_(0, A.gids.long(), part)
    return y.reshape(-1)[: A.nrows]


def spmv_bsr_compact(A: BsrCompact, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over the exact-block BsrCompact layout (f32). On the CPU
    the plain version, the JAX semantics. On a CUDA device the SELL f32
    kernel over the layout's packed form (`BsrCompact.packed`: built on
    the first call, cached), x read in place and checked alone, as
    `spmv_sell` does."""
    if x.is_cuda:
        if A.blocks.device != x.device:
            raise ValueError(f"BSR SpMV operands on {A.blocks.device} and "
                             f"{x.device}: need one CUDA device")
        P = A.packed()
        return spmv_sell.launch(P, P.vals, x, torch.float32, 1,
                                "spmv_sell_f32", "bsr_compact_f32", LAUNCHES)
    T = A.n_blocks
    _check(A.blocks, "blocks", torch.float32, (T, BR, BC))
    _check(A.gids, "gids", torch.int32, (T,))
    _check(A.bcols, "bcols", torch.int32, (T,))
    _on_cpu(A.blocks, A.gids, A.bcols, x)  # raises unless all on the CPU
    return spmv_bsr_compact_plain(A, x)


# ------------------------------------------------ K3: f32, k columns

def _x_table_mm(X: torch.Tensor, ncols: int, n_cb: int) -> torch.Tensor:
    """X (ncols, k) as the f32 table (n_cb, k, 128) of the JAX package's
    `spmm_bsr`: column j of column block cb at [cb, j, :], zero past ncols.
    One transposing copy for the whole column blocks, one for the tail."""
    if X.dim() != 2 or X.shape[0] != ncols or X.shape[1] < 1:
        raise ValueError(f"X: expected shape ({ncols}, k) with k >= 1, got "
                         f"{tuple(X.shape)}")
    k = X.shape[1]
    xt = torch.empty((n_cb, k, BC), dtype=torch.float32, device=X.device)
    full = ncols // BC
    xt[:full].copy_(X[: full * BC].reshape(full, BC, k).transpose(1, 2))
    if full < n_cb:
        xt[full:].zero_()
        xt[full, :, : ncols - full * BC] = X[full * BC:].T
    return xt


def spmm_bsr_plain(A: BsrMatrix, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Y = A @ X over uniform BSR (f32)."""
    xt = _x_table_mm(X, A.ncols, A.n_col_blocks)
    gathered = xt[A.block_cols.long()]                       # (G, S, k, 128)
    blk = A.blocks.view(A.n_groups, A.slots, BR, BC)
    Y = torch.einsum("gsrc,gskc->grk", blk, gathered)
    return Y.reshape(-1, X.shape[1])[: A.nrows]


def spmm_bsr(A: BsrMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X (f32) for k right-hand sides: X (ncols, k) → Y (nrows, k).
    Every column rides the same block stream."""
    _check(A.blocks, "blocks", torch.float32,
           (A.n_groups, A.slots * BR, BC))
    _check(A.block_cols, "block_cols", torch.int32, (A.n_groups, A.slots))
    if _on_cpu(A.blocks, A.block_cols, X):
        return spmm_bsr_plain(A, X)
    lib = _cuda.library("bsr_spmv")
    xt = _x_table_mm(X, A.ncols, A.n_col_blocks)
    k = X.shape[1]
    Y = torch.empty((A.n_groups, BR, k), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        rc = lib.lsb_spmm_bsr_f32(
            A.blocks.data_ptr(), A.block_cols.data_ptr(), xt.data_ptr(),
            Y.data_ptr(), A.n_groups, A.slots, k, _stream(X.device))
    _cuda.check(rc, "spmm_bsr_f32")
    LAUNCHES["bsr_mm_f32"] += 1
    return Y.view(-1, k)[: A.nrows]


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
    lib = _cuda.library("bsr_spmv")
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
    lib = _cuda.library("bsr_spmv")
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
