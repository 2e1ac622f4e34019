"""The row "mesh" as a `torch.distributed` process group (counterpart of
`lsbench_tpu/parallel/mesh.py`).

The JAX package lays its distributed solvers on a 1-D `jax.sharding.Mesh`
over the "rows" axis: one program, row-sharded arrays, XLA collectives.
Here each rank is a process that owns one contiguous block of rows and one
device, and the collectives are `torch.distributed` calls on the group of
all ranks: NCCL when the ranks run on CUDA cards (one card per rank,
`cuda:{local index}`), gloo when they run on the CPU, where the tests run
them. The ranks of one host meet through a `dist.FileStore` in a file they
share (no network is assumed). Ranks that span processes started apart,
on one host or several, meet through a `dist.TCPStore` at the
coordinator's HOST:PORT (`init_distributed`, the CLI's `--coordinator`):
the first rank of process 0 is the store's master, the others its
clients. A rank's global number orders the vectors; its local index, its
place among the ranks of its own process, picks its card. Every collective
of the group, and the meeting itself, times out after `GROUP_TIMEOUT_S`,
so that a rank that hangs makes the others fail instead of waiting for
ever.

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


@dataclass(frozen=True)
class ProcessInfo:
    """What `init_distributed` resolved for this process."""
    coordinator: str     # HOST:PORT of the store's master (process 0)
    num_processes: int
    process_id: int


_PROCESS: ProcessInfo | None = None


def init_distributed(coordinator: str, num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """The multi-process seam (counterpart of the JAX package's
    `init_distributed`, which calls `jax.distributed.initialize`).

    `coordinator` is "host:port" of process 0. `num_processes` and
    `process_id` are passed together, or neither: then they are read from
    the launcher's environment, `WORLD_SIZE` and `RANK` as `torchrun` sets
    them (where the JAX package autodetects a TPU pod). Validation and
    messages are the JAX package's. Nothing connects here: the ranks meet
    when a mesh is made (`make_row_mesh(..., coordinator=...)`), each
    with its global rank. Stores the result (`distributed_process`) and
    returns this process's id; a later call replaces it."""
    global _PROCESS
    if not coordinator or ":" not in coordinator:
        raise ValueError(
            f"coordinator must be 'host:port', got '{coordinator}'")
    if (num_processes is None) != (process_id is None):
        raise ValueError("pass both num_processes and process_id, or "
                         "neither (launcher autodetection: WORLD_SIZE and "
                         "RANK)")
    if num_processes is None:
        try:
            num_processes = int(os.environ["WORLD_SIZE"])
            process_id = int(os.environ["RANK"])
        except (KeyError, ValueError):
            raise ValueError("pass both num_processes and process_id, or "
                             "neither (launcher autodetection: WORLD_SIZE "
                             "and RANK are not set)") from None
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} out of range [0, {num_processes})")
    _PROCESS = ProcessInfo(coordinator, num_processes, process_id)
    return process_id


def distributed_process() -> ProcessInfo | None:
    """What the last `init_distributed` of this process resolved, or None."""
    return _PROCESS


@dataclass
class RowMesh:
    """This rank's place in the row partition: its global rank, the number
    of ranks, its device and the process group of all ranks. `local_rank`
    is its index among the ranks of its own process (its card)."""
    rank: int
    size: int
    device: torch.device
    group: object
    _tmp: str | None = None  # the rendezvous directory this mesh made
    local_rank: int = 0

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
                    group=mesh.group, _tmp=mesh._tmp,
                    local_rank=mesh.local_rank, pr=pr, pc=pc, i=i,
                    j=j, col_group=cols[j], row_group=rows[i])


def check_devices(n_devices: int, platform: str) -> None:
    """Raise the JAX package's message when a CUDA run asks for more ranks
    on this host than it has cards (each rank takes one card; a process of
    a `--coordinator` group counts only its own ranks). On the CPU any
    number of gloo ranks can run."""
    if n_devices < 1:
        raise ValueError(f"--devices must be at least 1, got {n_devices}")
    if platform == "cuda":
        have = torch.cuda.device_count()
        if have < n_devices:
            raise ValueError(f"requested {n_devices} devices, have {have}")


def _store(n_devices: int, rank: int, init_file: str | None,
           coordinator: str | None):
    """The key-value store the ranks meet through: a TCPStore at the
    coordinator (rank 0 its master), or the FileStore `init_file`."""
    timeout = timedelta(seconds=GROUP_TIMEOUT_S)
    if coordinator is not None:
        host, _, port = coordinator.rpartition(":")
        return dist.TCPStore(host, int(port), world_size=n_devices,
                             is_master=rank == 0, timeout=timeout)
    return dist.FileStore(init_file, n_devices)


def make_row_mesh(n_devices: int = 1, rank: int = 0,
                  init_file: str | None = None,
                  platform: str = "cuda", coordinator: str | None = None,
                  local_rank: int | None = None) -> RowMesh:
    """Join the group of `n_devices` ranks as global rank `rank`. The ranks
    meet through the FileStore `init_file` (a path none of them has
    created; a group of one makes its own when none is given), or, where
    they span processes started apart, through a TCPStore at
    `coordinator` ("host:port"; global rank 0 serves it). `local_rank`,
    the rank's index among the ranks of its own process, picks its card
    (`cuda:{local_rank}`); it defaults to `rank`, all ranks on one host.
    Every rank calls this with the same `n_devices`, rendezvous and
    `platform`."""
    local = rank if local_rank is None else local_rank
    # This process's ranks need cards 0..local; with one host, all ranks.
    check_devices(n_devices if coordinator is None else local + 1, platform)
    if not 0 <= rank < n_devices:
        raise ValueError(f"rank {rank} out of range [0, {n_devices})")
    if platform == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif platform == "cpu":
        device = torch.device("cpu")
        backend = "gloo"
    else:
        raise ValueError(f"unknown platform '{platform}' (cuda | cpu)")
    tmp = None
    if init_file is None and coordinator is None:
        if n_devices != 1:
            raise ValueError("a group of several ranks needs the "
                             "rendezvous they share (init_file or "
                             "coordinator)")
        tmp = tempfile.mkdtemp(prefix="lsbench_mesh_")
        init_file = os.path.join(tmp, "store")
    try:
        dist.init_process_group(
            backend, store=_store(n_devices, rank, init_file, coordinator),
            rank=rank, world_size=n_devices,
            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    except BaseException:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    return RowMesh(rank=rank, size=n_devices, device=device,
                   group=dist.group.WORLD, _tmp=tmp, local_rank=local)


def make_mesh_2d(pr: int, pc: int, rank: int = 0,
                 init_file: str | None = None,
                 platform: str = "cuda", coordinator: str | None = None,
                 local_rank: int | None = None) -> GridMesh:
    """Join the group of pr·pc ranks as `rank` (`make_row_mesh`) and lay
    it on the pr × pc grid (`as_grid`): global ranks stay row-major on
    the grid whichever process runs them."""
    mesh = make_row_mesh(pr * pc, rank, init_file, platform, coordinator,
                         local_rank)
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
