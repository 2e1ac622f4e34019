"""The program's counters and spans, all together, behind `reset()` and
`read()`. A run reads them around the work it wants to attribute:
`reset()` just before, `read()` just after. The counters are per process:
a rank spawned for a distributed run counts its own.

Kernel launches: each wrapper adds one to its count in its module's
`LAUNCHES` where it launches its kernel on the card, and nowhere else (a
CPU tensor runs the plain version, uncounted). Keys: `sell_f32`,
`sell_f64`, ... (each module's `LAUNCHES`), and `if_guard_f32` and
`if_guard_f64`, the guards of the CG block graph's if-nodes
(`ops/graph_if.py`).

Spans and host syncs record only while a `torch.profiler` session
records in the process (`--profile-dir`, the benchmark's `--trace 1`).
Otherwise `span(name)` is one flag check and a shared no-op context, and
`host_read(t)` only converts, so `read()` gains no key. While a session
records, a span is also a `record_function` in the trace (a
`user_annotation` on the profiler's clock), and they add to:

  span_n:<name>   spans of that name entered
  span_ns:<name>  their host durations, `time.perf_counter_ns()`, summed
  host_syncs      device→host reads of the Krylov stop tests
  sync_wait_ns    the host's time in those reads, the device's wait
                  included

The spans: `lsbench.ir.pass` (one refinement pass of `cg_ir` and its
kin, `solvers/refine.py`), `lsbench.cg.iter` (one iteration body of
`solvers/cg.py::cg_loop`, the stop test outside it; where the loop runs
as CUDA graphs, only where it cannot run in blocks), `lsbench.cg.block`
(one block of the graphed loop's guarded iterations and its read),
`lsbench.amg.vcycle` (one AMG preconditioner apply), inside it
`lsbench.amg.level<l>` (level l of the cycle, nested as the recursion
nests) and `lsbench.amg.coarse` (the dense coarse solve).

CUDA graphs (`solvers/cg.py::CgGraphs`): a wrapper counts its launch while
a graph is captured, but the kernel runs only when the graph is replayed.
So `take_back` sets the counts back after a capture and keeps what it
added, and `replayed` adds that again for every replay: for a block
graph, its bodies' kernels once for each guarded iteration that ran and
its guards once a slot, run or skipped. The counts stay the launches
that ran. Inside a replayed graph the spans and host reads ran at capture
only. While a session records, the graphs also add to:

  graph_captures          graphs captured
  graph_replays:<name>    replays of graph <name> (`lsbench.cg.start`,
                          `lsbench.cg.block`, `lsbench.cg.iter`)
  graph_slots:lsbench.cg.block
                          the guarded iterations replayed, run or
                          skipped (the block's slots a replay)
  graph_fallbacks         captures that raised (after the start's or an
                          iteration's, that loop runs eager; after the
                          block's, a graph an iteration)
"""

from __future__ import annotations

import time
from contextlib import nullcontext

from torch.autograd import profiler as _profiler

from lsbench_tpu_torch.ops import (graph_if, interp_well, spmv_bsr, spmv_sell,
                                   tri_sweep)

_MODULES = (spmv_bsr, interp_well, spmv_sell, tri_sweep, graph_if)
_NO_SPAN = nullcontext()
_TRACED: dict[str, int] = {}     # the span and sync keys recorded so far


def reset() -> None:
    """Set every kernel's launch count to 0 and forget the spans and
    syncs."""
    for m in _MODULES:
        m.reset_launches()
    _TRACED.clear()


def read() -> dict:
    """Every kernel's launch count, by counter name, and the span and sync
    keys recorded since the last `reset()`."""
    out = {}
    for m in _MODULES:
        out.update(m.LAUNCHES)
    out.update(_TRACED)
    return out


def _add(key: str, v: int) -> None:
    _TRACED[key] = _TRACED.get(key, 0) + v


class _Span:
    """A `record_function` that also counts itself and its host time."""

    __slots__ = ("_rf", "_keys", "_t0")

    def __init__(self, name: str):
        self._rf = _profiler.record_function(name)
        self._keys = (f"span_n:{name}", f"span_ns:{name}")

    def __enter__(self):
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        self._rf.__exit__(*exc)
        _add(self._keys[0], 1)
        _add(self._keys[1], dt)


def span(name: str):
    """A context manager around one unit of a layer's work: a shared
    no-op while no profiler session records, else a counted, timed
    `record_function(name)`. Pass a name made once, not per call."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def count(key: str, n: int = 1) -> None:
    """Add n to `key` while a profiler session records."""
    if _profiler._is_profiler_enabled:
        _add(key, n)


def take_back(before: dict) -> tuple:
    """Set each kernel's launch count back to its value in `before` (a
    `read()`) and return what was added since, as (counts, key, launches)
    triples: the launches of a CUDA graph's capture, which run only when
    the graph is replayed."""
    delta = []
    for m in _MODULES:
        for key, v in m.LAUNCHES.items():
            was = before.get(key, 0)
            if v != was:
                delta.append((m.LAUNCHES, key, v - was))
                m.LAUNCHES[key] = was
    return tuple(delta)


def replayed(key: str, delta: tuple, runs: int = 1, slots: int = 1
             ) -> None:
    """Count one replay of a graph whose capture launched `delta`
    (`take_back`), one slot's launches: each kernel's count gains its
    launches `runs` times (a block's iterations that ran), an if-node
    guard's (`ops/graph_if.py`) `slots` times (the block's slots), and
    while a profiler session records, `key` (`graph_replays:<name>`)
    gains one."""
    for counts, name, n in delta:
        counts[name] += n * (slots if counts is graph_if.LAUNCHES else runs)
    if _profiler._is_profiler_enabled:
        _add(key, 1)


def host_read(t):
    """The Python value of a 0-d device tensor (a stop test's `bool` or a
    norm's `float`): the host waits for the device here. While a profiler
    session records, counts the read and the time it took."""
    if not _profiler._is_profiler_enabled:
        return t.item()
    t0 = time.perf_counter_ns()
    v = t.item()
    _add("sync_wait_ns", time.perf_counter_ns() - t0)
    _add("host_syncs", 1)
    return v
