"""The kernel wrappers' launch counters, all together: each wrapper adds one
to its count in its module's `LAUNCHES` where it launches its kernel on the
card, and nowhere else (a CPU tensor runs the plain version, uncounted).
A run reads them around the work it wants to attribute: `reset()` just
before, `read()` just after. The counters are per process: a rank spawned
for a distributed run counts its own launches."""

from __future__ import annotations

from lsbench_tpu_torch.ops import interp_well, spmv_bsr, spmv_sell, tri_sweep

_MODULES = (spmv_bsr, interp_well, spmv_sell, tri_sweep)


def reset() -> None:
    """Set every kernel's launch count to 0."""
    for m in _MODULES:
        m.reset_launches()


def read() -> dict:
    """Every kernel's launch count, by counter name."""
    out = {}
    for m in _MODULES:
        out.update(m.LAUNCHES)
    return out
