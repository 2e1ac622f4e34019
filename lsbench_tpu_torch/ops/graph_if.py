"""CUDA-graph conditional (if) nodes around work that PyTorch captures,
each guarded by a counted loop's test on the device (`csrc/graph_if.cu`),
for the CG loop's block of guarded iterations (`solvers/cg.py::CgGraphs`).

Inside a capture on the current stream, `if_node(it, limit, value, bound,
body, pool)` adds a guard kernel and a node that, at replay, runs the work
of its `with` block only where `go(it, limit, value, bound)` then holds,
adding one to `it` first. That work is captured on `body`, a stream that
captures nothing else: the solver's own stream, so that its kernels use
that stream's cuBLAS workspace, and its temporaries come from `pool`, one
`torch.cuda.MemPool` for every body of the graph. The bodies run one
after another, so each reuses the blocks the one before it freed. The
pool has to live as long as the graph.

Each guard enqueued adds one to `LAUNCHES["if_guard_f32"]` or
`LAUNCHES["if_guard_f64"]` (by the dtype of value and bound). It is
enqueued at capture, and a replay runs every guard of the graph, whether
its body runs or not: `solvers/cg.py::CgGraphs` takes the capture's count
back and adds the graph's guards at each replay (`ops/launches.py`).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from lsbench_tpu_torch.ops import _cuda

_ENTRY = {torch.float32: "graph_if_f32", torch.float64: "graph_if_f64"}
_COUNTER = {torch.float32: "if_guard_f32", torch.float64: "if_guard_f64"}

LAUNCHES = {"if_guard_f32": 0, "if_guard_f64": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def go(it: torch.Tensor, limit: torch.Tensor, value: torch.Tensor,
       bound: torch.Tensor) -> torch.Tensor:
    """The guard's test in PyTorch, as a 0-d bool: it < limit and
    value > bound (0-d int64 it and limit, 0-d value and bound)."""
    return (it < limit) & (value > bound)


def load(device: torch.device) -> None:
    """Build and load the library and its kernels, outside any capture.
    Raises where the toolkit cannot build it."""
    _cuda.launch(_cuda.entry("graph_if", "graph_if_load"), "graph_if_load",
                 device)


@contextmanager
def if_node(it: torch.Tensor, limit: torch.Tensor, value: torch.Tensor,
            bound: torch.Tensor, body: torch.cuda.Stream, pool):
    """The work of the `with` block as the body of an if-node guarded by
    `go(it, limit, value, bound)`, in the graph the current stream
    captures. Raises where CUDA refuses the node (a runtime before
    12.4)."""
    name = _ENTRY[value.dtype]
    _cuda.launch(_cuda.entry("graph_if", name), name, value.device,
                 it.data_ptr(), limit.data_ptr(), value.data_ptr(),
                 bound.data_ptr(), body.cuda_stream)
    LAUNCHES[_COUNTER[value.dtype]] += 1
    try:
        with torch.cuda.stream(body), torch.cuda.use_mem_pool(pool,
                                                              value.device):
            yield
    finally:
        _cuda.check(_cuda.entry("graph_if", "graph_if_end")(body.cuda_stream),
                    "graph_if_end")
