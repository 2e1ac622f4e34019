"""One sparse triangular sweep in one launch: the apply of the IC(0)
preconditioner and of sparse_cholesky's `level` schedule, a hand-written
CUDA kernel (`csrc/tri_sweep.cu`) beside its plain PyTorch version.

    tri_sweep(S, b)   x_i = (b_i − Σ_j L_ij·x_j)·dinv_i for every row i,
                      taken in the sweep's level order; b (n,) or (n, k)

The JAX package runs this as `solvers/sparse_cholesky.py::_sweep`, a
`lax.scan` over the dependency levels (no Pallas kernel). The plain version
here is that function in torch ops: per level one gather, product,
`index_add_`, subtraction and product with `dinv`, scattered into x, over
the JAX package's padded level segments (`_pack_levels`). That is ~5
launches per level, and RCM poisson_2d(512)'s IC(0) factor has 1023 levels
per sweep; the kernel runs the whole dependency chain in one launch.

`TriSweep` holds one sweep in the kernel's layout (rows in level order,
their strictly-lower entries as CSR, `dinv` by position) and the flags
and counter the kernel keeps between launches; `levels` holds the plain
version's per-level views where they were uploaded (always on the CPU).
The layout is validated once when it is built: every entry must point to
a row at an earlier position, which is what keeps the kernel from waiting
forever.

Dispatch: b on the CPU runs the plain version; b on the layout's CUDA
device launches the kernel; anything else raises. A multi-RHS b (n, k) is
swept one column at a time, as the JAX package's `vmap` does. Each launch
adds one to `LAUNCHES["tri_sweep_f32"]` or `LAUNCHES["tri_sweep_f64"]`. A
row that waits past the kernel's cap sets the sweep's error word and
publishes NaN; `check` reads the word (one device sync) and raises, and
the solvers call it once per solve.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lsbench_tpu_torch.ops import _cuda  # builds nothing until first launch

LAUNCHES = {"tri_sweep_f32": 0, "tri_sweep_f64": 0}
_NAMES = {torch.float32: "tri_sweep_f32", torch.float64: "tri_sweep_f64"}
# The kernel compares each flag with the launch's epoch; epochs run through
# [1, 2^31 - 1] (flags start at 0), so a flag is never taken for a later
# launch's within 2^31 - 1 launches of one layout.
_EPOCH_WRAP = 2**31 - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass(eq=False)
class TriSweep:
    n: int
    nlev: int
    perm: torch.Tensor       # (n,) int32: row at each position, level order
    offs: torch.Tensor       # (n + 1,) int64: entries of each position
    cols: torch.Tensor       # (nnz,) int32: the row each entry depends on
    vals: torch.Tensor       # (nnz,) f32 or f64
    dinv: torch.Tensor       # (n,) 1 / diagonal, by position
    ready: torch.Tensor      # (n,) int32 flags: the epoch x_i was published in
    ctl: torch.Tensor        # (2,) int32: claim counter, error word
    levels: list | None      # plain version: (rows, slot, cols, vals, dinv, R)
    epoch: int = 0

    @classmethod
    def build(cls, perm, offs, cols, vals, dinv, nlev: int, dtype, device,
              levels=None) -> "TriSweep":
        """Validate the host arrays once and upload them in `dtype`."""
        n = perm.size
        lens = np.diff(offs)
        if (offs.size != n + 1 or offs[0] != 0 or np.any(lens < 0)
                or offs[-1] != cols.size or vals.size != cols.size
                or dinv.size != n
                or not np.array_equal(np.sort(perm), np.arange(n))):
            raise ValueError("TriSweep: inconsistent layout arrays")
        pos = np.empty(n, dtype=np.int64)
        pos[perm] = np.arange(n)
        if cols.size and (cols.min() < 0 or cols.max() >= n or np.any(
                pos[cols] >= np.repeat(np.arange(n), lens))):
            raise ValueError("TriSweep: an entry depends on a row at the "
                             "same or a later position")
        dev = torch.device(device)

        def up(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=dev)

        return cls(n=n, nlev=int(nlev), perm=up(perm, torch.int32),
                   offs=up(offs, torch.int64), cols=up(cols, torch.int32),
                   vals=up(vals, dtype), dinv=up(dinv, dtype),
                   ready=torch.zeros(n, dtype=torch.int32, device=dev),
                   ctl=torch.zeros(2, dtype=torch.int32, device=dev),
                   levels=levels)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nnz(self) -> int:
        return int(self.cols.numel())


def tri_sweep_plain(S: TriSweep, b: torch.Tensor) -> torch.Tensor:
    """The JAX package's `_sweep` in torch ops, level by level over the
    padded segments: x has a dummy slot n where padding rows write 0."""
    if S.levels is None:
        raise ValueError("tri_sweep: this layout was built without the plain "
                         "version's level arrays")
    x = torch.zeros(S.n + 1, dtype=b.dtype, device=b.device)
    bp = torch.cat([b, b.new_zeros(1)])
    for rows, slot, cols, vals, dinv, R in S.levels:
        s = x.new_zeros(R + 1).index_add_(0, slot, vals * x[cols])[:R]
        x[rows] = (bp[rows] - s) * dinv
    return x[:S.n]


def tri_sweep(S: TriSweep, b: torch.Tensor) -> torch.Tensor:
    """One sweep of S on b, (n,) or (n, k), in S's dtype: the plain version
    for a CPU b, the kernel (one launch per column) for b on S's CUDA
    device."""
    if b.dim() == 2:
        return torch.stack([tri_sweep(S, b[:, j].contiguous())
                            for j in range(b.shape[1])], dim=1)
    name = _NAMES.get(S.dtype)
    if name is None:
        raise TypeError(f"tri_sweep: no kernel for {S.dtype}")
    if b.dtype != S.dtype:
        raise TypeError(f"{name}: b must be {S.dtype}, got {b.dtype}")
    if b.shape != (S.n,) or not b.is_contiguous():
        raise ValueError(f"{name}: b must be contiguous of shape ({S.n},) or "
                         f"({S.n}, k), got {tuple(b.shape)}")
    dev = b.device
    if dev != S.device:
        raise ValueError(f"{name}: b on {dev}, the layout on {S.device}")
    if dev.type == "cpu":
        return tri_sweep_plain(S, b)
    if dev.type != "cuda":
        raise ValueError(f"{name}: operands on {dev}: need the CPU (plain "
                         "version) or a CUDA device (kernel)")
    x = torch.empty_like(b)
    S.epoch = S.epoch % _EPOCH_WRAP + 1
    _cuda.launch(_cuda.entry("tri_sweep", name), name, dev,
                 S.perm.data_ptr(), S.offs.data_ptr(), S.cols.data_ptr(),
                 S.vals.data_ptr(), S.dinv.data_ptr(), b.data_ptr(),
                 x.data_ptr(), S.ready.data_ptr(), S.ctl.data_ptr(), S.n,
                 S.epoch)
    LAUNCHES[name] += 1
    return x


def check(*sweeps: TriSweep) -> None:
    """Raise if a kernel launch on any of `sweeps` set its error word (a
    row waited past the kernel's cap). One device sync; nothing on the
    CPU."""
    words = [S.ctl[1] for S in sweeps if S.device.type == "cuda"]
    if words and int(torch.stack(words).max()) != 0:
        raise RuntimeError("tri_sweep: a row waited past the kernel's cap "
                           "for a row it depends on; its result is NaN")
