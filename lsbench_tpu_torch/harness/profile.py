"""Observability: `torch.profiler` tracing and the per-SpMV roofline report
(counterpart of `lsbench_tpu/harness/profile.py`).

Every SpMV layout knows the bytes it streams, so `--roofline` reports the
achieved bandwidth of the solver's SpMV against the card's peak, beside the
share of the function's own bytes (A in CSR form, x read and y written
once: what `chip_smoke.py` bounds every kernel by), which reads the same
whatever layout runs.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# Peak HBM bandwidth (GB/s) of NVIDIA parts, by a substring of
# `torch.cuda.get_device_name()` (NVIDIA's data sheets).
HBM_GBPS = {"H100 80GB HBM3": 3350.0,  # SXM
            "H100 PCIe": 2039.0,
            "H100 NVL": 3938.0}
# Written before each timed application on the card: larger than the
# H100's 50 MB L2, so that the SpMV reads its operands from HBM.
L2_FLUSH_BYTES = 256 << 20


def device_hbm_gbps(device=None, kind: str | None = None) -> float | None:
    """Peak HBM GB/s of the card named `kind`, by default that of `device`
    (a CUDA device; the current one if None). None for an unknown card and
    for the CPU: no figure of another part stands in."""
    if kind is None:
        device = torch.device("cuda" if device is None else device)
        if device.type != "cuda" or not torch.cuda.is_available():
            return None
        kind = torch.cuda.get_device_name(device)
    for key, bw in HBM_GBPS.items():
        if key in kind:
            return bw
    return None


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """`torch.profiler` trace of the body: CPU and CUDA activity on a card,
    CPU alone for `device` "cpu". Writes a chrome trace (the format
    `harness/profile_solve.py` reads) into `logdir`; yields its path."""
    device = torch.device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}-"
                                f"{time.strftime('%Y%m%d-%H%M%S')}.json")
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield path
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(path)


def time_op(fn, x: torch.Tensor, reps: int = 50) -> float:
    """Seconds per application of `fn` to x, without the dispatch latency.

    On the card: the device time of one application, L2-cold. Each rep
    times two CUDA event pairs on the stream: one around a write of a
    buffer larger than the L2 (the flush), one around the flush and then
    one application; the application's time is the difference, and the
    result the median over `reps`. The flush keeps the card busy while
    the host queues the call behind it, and the difference takes out what
    the event pair itself adds: around the call alone it read 0.0121 ms
    where the profiler gave the cold kernel 0.0079 ms (RCM poisson_2d(512),
    SELL f32, on an H100). Timed warm, a chain of applications would read
    an operator that fits in the 50 MB L2 (10.55 MB at n=262k) from there
    and report more than the HBM peak. On the CPU: the host clock around
    one call, the median over `reps`."""
    fn(x)
    if x.device.type == "cuda":
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                            device=x.device)
        torch.cuda.synchronize(x.device)
        events = []
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            flush.zero_()
            ev[1].record()
            ev[2].record()
            flush.zero_()
            fn(x)
            ev[3].record()
            events.append(ev)
        torch.cuda.synchronize(x.device)
        times = sorted((e[2].elapsed_time(e[3]) - e[0].elapsed_time(e[1]))
                       * 1e-3 for e in events)
    else:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(x)
            times.append(time.perf_counter() - t0)
        times.sort()
    return max(times[reps // 2], 1e-12)


def spmv_roofline(op, x: torch.Tensor, nnz: int, stream_bytes: int,
                  reps: int = 50) -> dict:
    """Measure one SpMV operator against the HBM roofline.

    Returns the JAX package's fields (seconds, Gnnz/s, achieved GB/s of the
    layout's `stream_bytes`, the peak and its share; peak and share None
    where the card is unknown or x is on the CPU) and `function_bytes`, the
    bytes of y = A·x with A in CSR form (values and int32 column indices of
    the nonzeros, int32 row offsets) and x read and y written once, with
    `function_utilization`, their share of the peak."""
    sec = time_op(op, x, reps)
    nrows = op(x).shape[0]
    vb = x.element_size()
    function_bytes = (nnz * (vb + 4) + (nrows + 1) * 4
                      + (x.shape[0] + nrows) * vb)
    gbps = stream_bytes / sec / 1e9
    peak = device_hbm_gbps(x.device)
    return {
        "spmv_s": sec,
        "gnnz_per_s": nnz / sec / 1e9,
        "achieved_gbps": gbps,
        "peak_gbps": peak,
        "hbm_utilization": None if peak is None else gbps / peak,
        "stream_bytes": stream_bytes,
        "function_bytes": function_bytes,
        "function_utilization": (None if peak is None
                                 else function_bytes / sec / 1e9 / peak),
    }
