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


def fetch_global(mesh: RowMesh, x_l: torch.Tensor, n: int) -> torch.Tensor:
    """The first n rows of the row-partitioned x, whose local block on
    this rank is x_l (nloc rows, the same on every rank): gathered from
    every rank, so that each rank returns the same full array, on its own
    device."""
    parts = [torch.empty_like(x_l) for _ in range(mesh.size)]
    dist.all_gather(parts, x_l.contiguous(), group=mesh.group)
    return torch.cat(parts)[:n]
