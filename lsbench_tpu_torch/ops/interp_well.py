"""Window-ELL SpMV for AMG transfer operators (kernel K4), beside its plain
PyTorch version.

Counterpart of `lsbench_tpu/ops/interp_pallas.py`, with the same layout bit
for bit. The interpolation P and restriction R of a classical hierarchy
hold ~2-8 nonzeros per row and, after the coarse alignment
(`solvers/amg.py::align_coarse_levels`), are banded: the columns of each
128-row tile fit one 128-aligned window of J·128 source entries. The ELL
arrays are stored transposed, slot-major, so neighbouring rows are
neighbouring words:

    vals  (k8, n_pad) f32    slot s of row r (0 in padding)
    lcols (k8, n_pad) int32  column − 128·w0[r // 128], in [0, J·128)
    w0    (n_pad/128,) int32 window start of each 128-row tile, in blocks

    y[r] = Σ_{s < k_real} vals[s, r] · x[128·w0[r // 128] + lcols[s, r]]

x is read in place. The TPU kernel read whole windows and so needed x
zero-padded by J blocks; a slot here reads only its own entry, and
validation (at `from_csr`, `from_jax_arrays` and `.to`) proves once that
every index read for a row < nrows and a slot < k_real lies in [0, ncols):
a real slot reads its own column, a padding slot (lcols 0) 128·w0, at most
its tile's smallest column (0 in an empty tile). A layout that breaks this
is refused. The validation also pins what the kernel takes (int32 rows),
so a call checks only x, allocates y (nrows,), and launches once with the entry point looked up once and the raw stream
handle taken without a Stream object (`_cuda.launch`).

Dispatch: x on the CPU with the layout on the CPU goes to
`spmv_well_plain`; x on the layout's CUDA device launches the kernel
(`csrc/well_spmv.cu`); anything else raises. Each launch adds one to
`LAUNCHES["well_f32"]`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from lsbench_tpu_torch.ops import _cuda  # builds nothing until first launch
from lsbench_tpu_torch.ops.spmv_bsr import _check

TR = 128      # fine rows per window tile
TPS = 8       # tiles per TPU grid step: n_pad is a multiple of TR·TPS, as
#               in the JAX package, so both hold the same arrays
KPAD = 8      # slot pad multiple

LAUNCHES = {"well_f32": 0}


def reset_launches() -> None:
    LAUNCHES["well_f32"] = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class WindowEll:
    vals: torch.Tensor   # (k8, n_pad) f32, slot-major
    lcols: torch.Tensor  # (k8, n_pad) int32
    w0: torch.Tensor     # (n_pad / TR,) int32
    nrows: int
    ncols: int
    nnz: int
    j_blocks: int        # J: window width in 128-blocks
    k_real: int = 0      # true max nnz/row (≤ k8); slots past it are zero

    def __post_init__(self):
        _validate(self)  # at every construction: from_*, .to, replace

    @property
    def k8(self) -> int:
        return self.vals.shape[0]

    @property
    def n_pad(self) -> int:
        return self.vals.shape[1]

    @property
    def k_eff(self) -> int:
        """Slots summed per row: k_real, or k8 where k_real is unknown (0)."""
        return self.k_real or self.k8

    @property
    def bytes_streamed(self) -> int:
        return (self.vals.numel() + self.lcols.numel()) * 4

    @staticmethod
    def from_csr(M, dtype=torch.float32, max_k: int = 16, max_j: int = 8,
                 max_table_blocks: int = 4096,
                 device="cuda") -> "WindowEll | None":
        """Build the layout, or None where the JAX package's `from_csr`
        refuses it: not f32, more than max_k nonzeros per row, a window
        wider than max_j blocks (not banded), or a source table of
        ceil(ncols/128) + J blocks over max_table_blocks (the TPU's VMEM
        budget, kept so that both packages choose the same layouts)."""
        if dtype != torch.float32:
            return None
        n, nc = M.nrows, M.ncols
        lens = np.diff(M.offs)
        k = max(1, int(lens.max(initial=1)))
        k8 = _round_up(k, KPAD)
        if k8 > max_k:
            return None
        n_pad = _round_up(n, TR * TPS)
        T = n_pad // TR
        rows = M.row_indices()
        tile = rows // TR

        mn = np.full(T, np.iinfo(np.int64).max)
        mx = np.zeros(T, dtype=np.int64)
        np.minimum.at(mn, tile, M.cols)
        np.maximum.at(mx, tile, M.cols + 1)
        empty = mn > mx
        mn[empty], mx[empty] = 0, 1
        w0 = mn // TR
        span = mx - w0 * TR
        J = int(_round_up(int(span.max()), TR) // TR)
        if J > max_j:
            return None
        if _round_up(nc, TR) // TR + J > max_table_blocks:
            return None

        vals = np.zeros((n_pad, k8), dtype=np.float32)
        lcols = np.zeros((n_pad, k8), dtype=np.int32)
        slot = np.arange(M.nnz) - M.offs[rows]
        vals[rows, slot] = M.vals
        lcols[rows, slot] = M.cols - w0[tile] * TR
        return WindowEll(
            vals=torch.from_numpy(vals.T.copy()),
            lcols=torch.from_numpy(lcols.T.copy()),
            w0=torch.from_numpy(w0.astype(np.int32)),
            nrows=n, ncols=nc, nnz=M.nnz, j_blocks=J, k_real=k).to(device)

    @staticmethod
    def from_jax_arrays(*, vals, lcols, w0, nrows: int, ncols: int, nnz: int,
                        j_blocks: int, k_real: int = 0,
                        device="cuda") -> "WindowEll":
        """Carry a layout built by the JAX package over to the port: its
        arrays as numpy arrays (`np.asarray` of each field), the same bits
        in the port's tensors. Refuses arrays the kernel cannot take."""
        def t(a, dtype):
            a = np.asarray(a)
            if a.dtype != dtype:
                raise ValueError(f"expected {np.dtype(dtype)} array, got {a.dtype}")
            return torch.from_numpy(np.require(a, requirements=["C", "W"]))

        return WindowEll(vals=t(vals, np.float32), lcols=t(lcols, np.int32),
                         w0=t(w0, np.int32), nrows=nrows, ncols=ncols,
                         nnz=nnz, j_blocks=j_blocks,
                         k_real=k_real).to(device)

    def to(self, device) -> "WindowEll":
        return dataclasses.replace(self, vals=self.vals.to(device),
                                   lcols=self.lcols.to(device),
                                   w0=self.w0.to(device))


def _read_index(op: WindowEll) -> torch.Tensor:
    """(k_eff, nrows) int64: the x index each slot of each row reads."""
    base = (op.w0.long() * TR).repeat_interleave(TR)[: op.nrows]
    return base[None, :] + op.lcols[: op.k_eff, : op.nrows].long()


def _validate(op: WindowEll) -> None:
    """What the kernel assumes of the arrays; the wrapper checks only x."""
    k8, n_pad = op.vals.shape
    _check(op.vals, "vals", torch.float32)
    _check(op.lcols, "lcols", torch.int32, (k8, n_pad))
    _check(op.w0, "w0", torch.int32, (n_pad // TR,))
    if len({op.vals.device, op.lcols.device, op.w0.device}) != 1:
        raise ValueError("window-ELL arrays on more than one device")
    if (n_pad % TR or not 0 < op.nrows <= n_pad or op.ncols < 1
            or not 0 <= op.k_real <= k8):
        raise ValueError(f"window-ELL arrays of shape {(k8, n_pad)} do not "
                         f"hold {op.nrows} rows of {op.k_real} slots over "
                         f"{op.ncols} columns")
    if n_pad >= 2**31:
        raise ValueError(f"{n_pad} padded rows exceed the kernel's int32 rows")
    idx = _read_index(op)
    lo, hi = int(idx.min()), int(idx.max())
    if lo < 0 or hi >= op.ncols:
        raise ValueError(f"window-ELL reads x[{lo}..{hi}] outside [0, "
                         f"{op.ncols}): the kernel reads x in place")


def spmv_well_plain(op: WindowEll, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = M v over the window-ELL layout (f32), x in place."""
    k = op.k_eff
    return (op.vals[:k, : op.nrows] * v[_read_index(op)]).sum(dim=0)


def spmv_well(op: WindowEll, v: torch.Tensor) -> torch.Tensor:
    """y = M v through the window-ELL layout; v (ncols,) f32 → y (nrows,)
    f32."""
    name = "spmv_well_f32"
    if v.dtype != torch.float32:
        raise TypeError(f"{name}: x must be torch.float32, got {v.dtype}")
    if v.shape != (op.ncols,) or not v.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous of shape "
                         f"({op.ncols},), got {tuple(v.shape)}")
    dev = v.device
    if dev != op.vals.device or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: x on {dev}, the layout on "
                         f"{op.vals.device}: need both on the CPU (plain "
                         "version) or on one CUDA device (kernel)")
    if dev.type == "cpu":
        return spmv_well_plain(op, v)
    y = torch.empty(op.nrows, dtype=torch.float32, device=dev)
    _cuda.launch(_cuda.entry("well_spmv", name), name, dev,
                 op.vals.data_ptr(), op.lcols.data_ptr(), op.w0.data_ptr(),
                 v.data_ptr(), y.data_ptr(), op.nrows, op.n_pad, op.k_eff)
    LAUNCHES["well_f32"] += 1
    return y
