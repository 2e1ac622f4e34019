"""Device idle time in the traced span divided by the inner iterations of
the traced solves, µs: the host's dispatch and the per-iteration stop
test, as far as the card waits for them."""


def read(ctx):
    p = ctx.profiled
    if p is None or not p["iters"]:
        return None
    return (p["span_us"] - p["busy_us"]) / p["iters"]
