"""The row "mesh" as a `torch.distributed` process group (counterpart of
`lsbench_tpu/parallel/mesh.py`).

The JAX package lays its distributed solvers on a 1-D `jax.sharding.Mesh`
over the "rows" axis: one program, row-sharded arrays, XLA collectives.
Here each rank is a process that owns one contiguous block of rows and one
device, and the collectives are `torch.distributed` calls on the group of
all ranks: NCCL when the ranks run on CUDA cards (one card per rank,
`cuda:{rank}`), gloo when they run on the CPU, where the tests run them.
The ranks meet through a `dist.FileStore` in a file they share (no network
is assumed), and every collective of the group times out after
`GROUP_TIMEOUT_S`, so that a rank that hangs makes the others fail instead
of waiting for ever.

A `RowMesh` is a context manager: leaving it destroys the group, so that
one process can run several distributed solves one after another.

The 2-D partition (`dist2d.py`, `dist_amg2d.py`) lays the same ranks on a
pr × pc grid, row-major as `jax.make_mesh((pr, pc))` orders its devices:
rank c = i·pc + j sits at (i, j) and owns chunk c of every vector. A
`GridMesh` is the row mesh plus two subgroups of it: the column group, the
ranks (·, j) in ascending i, over which the JAX package's `all_gather`
over ROWS runs, and the row group, the ranks (i, ·) in ascending j, over
which its `psum_scatter` over COLS runs.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

ROWS = "rows"
GROUP_TIMEOUT_S = 60


@dataclass
class RowMesh:
    """This rank's place in the row partition: its rank, the number of
    ranks, its device and the process group of all ranks."""
    rank: int
    size: int
    device: torch.device
    group: object
    _tmp: str | None = None  # the rendezvous directory this mesh made

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None

    def __enter__(self) -> "RowMesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclass
class GridMesh(RowMesh):
    """This rank's place on the pr × pc grid: the row mesh's fields (the
    group of all ranks included), its grid position (i, j) and the groups
    of its grid column and grid row."""
    pr: int = 1
    pc: int = 1
    i: int = 0
    j: int = 0
    col_group: object = None  # ranks (·, j), ascending i
    row_group: object = None  # ranks (i, ·), ascending j


def as_grid(mesh: RowMesh, pr: int, pc: int) -> GridMesh:
    """The row mesh `mesh` of pr·pc ranks laid on a pr × pc grid. Every
    rank calls this together: it creates every grid row's group and then
    every grid column's, in one fixed order on all ranks (`dist.new_group`
    is collective over the whole group), and keeps its own two. Each
    group's ranks ascend, so group rank g of a row group is grid column
    g and of a column group grid row g: `reduce_scatter` hands piece g to
    group rank g and `all_gather` concatenates by group rank."""
    if pr < 1 or pc < 1 or pr * pc != mesh.size:
        raise ValueError(f"a {pr}x{pc} grid needs {pr * pc} ranks, the "
                         f"mesh has {mesh.size}")
    timeout = timedelta(seconds=GROUP_TIMEOUT_S)
    rows = [dist.new_group([a * pc + b for b in range(pc)], timeout=timeout)
            for a in range(pr)]
    cols = [dist.new_group([a * pc + b for a in range(pr)], timeout=timeout)
            for b in range(pc)]
    i, j = divmod(mesh.rank, pc)
    return GridMesh(rank=mesh.rank, size=mesh.size, device=mesh.device,
                    group=mesh.group, _tmp=mesh._tmp, pr=pr, pc=pc, i=i,
                    j=j, col_group=cols[j], row_group=rows[i])


def check_devices(n_devices: int, platform: str) -> None:
    """Raise the JAX package's message when a CUDA run asks for more ranks
    than there are cards (each rank takes one card). On the CPU any number
    of gloo ranks can run."""
    if n_devices < 1:
        raise ValueError(f"--devices must be at least 1, got {n_devices}")
    if platform == "cuda":
        have = torch.cuda.device_count()
        if have < n_devices:
            raise ValueError(f"requested {n_devices} devices, have {have}")


def make_row_mesh(n_devices: int = 1, rank: int = 0,
                  init_file: str | None = None,
                  platform: str = "cuda") -> RowMesh:
    """Join the group of `n_devices` ranks as `rank`, meeting the others
    through the FileStore `init_file` (a path none of them has created; a
    group of one makes its own when none is given). Every rank calls this
    with the same `n_devices`, `init_file` and `platform`."""
    check_devices(n_devices, platform)
    if not 0 <= rank < n_devices:
        raise ValueError(f"rank {rank} out of range [0, {n_devices})")
    if platform == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif platform == "cpu":
        device = torch.device("cpu")
        backend = "gloo"
    else:
        raise ValueError(f"unknown platform '{platform}' (cuda | cpu)")
    tmp = None
    if init_file is None:
        if n_devices != 1:
            raise ValueError("a group of several ranks needs the "
                             "rendezvous file they share (init_file)")
        tmp = tempfile.mkdtemp(prefix="lsbench_mesh_")
        init_file = os.path.join(tmp, "store")
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(init_file, n_devices), rank=rank,
            world_size=n_devices,
            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    except BaseException:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    return RowMesh(rank=rank, size=n_devices, device=device,
                   group=dist.group.WORLD, _tmp=tmp)


def make_mesh_2d(pr: int, pc: int, rank: int = 0,
                 init_file: str | None = None,
                 platform: str = "cuda") -> GridMesh:
    """Join the group of pr·pc ranks as `rank` (`make_row_mesh`) and lay
    it on the pr × pc grid (`as_grid`)."""
    mesh = make_row_mesh(pr * pc, rank, init_file, platform)
    try:
        return as_grid(mesh, pr, pc)
    except BaseException:
        mesh.close()
        raise


def fetch_global(mesh: RowMesh, x_l: torch.Tensor, n: int) -> torch.Tensor:
    """The first n rows of the row-partitioned x, whose local block on
    this rank is x_l (nloc rows, the same on every rank): gathered from
    every rank, so that each rank returns the same full array, on its own
    device."""
    parts = [torch.empty_like(x_l) for _ in range(mesh.size)]
    dist.all_gather(parts, x_l.contiguous(), group=mesh.group)
    return torch.cat(parts)[:n]
