"""The host's time in the stop tests' device→host reads
(`sync_wait_ns`, the device's wait for the queued work included) per
inner CG iteration (`span_n:lsbench.cg.iter`) over the traced solves, µs
(`ops/launches.py`)."""


def read(ctx):
    p = ctx.profiled
    if p is None:
        return None
    wait_ns = p["launches"].get("sync_wait_ns")
    iters = p["launches"].get("span_n:lsbench.cg.iter")
    if not wait_ns or not iters:
        return None
    return wait_ns / iters / 1e3
