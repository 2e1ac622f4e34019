"""Device busy time in the traced span divided by the PCG iterations of the
traced solves, µs: with an AMG preconditioner, mostly the V-cycle."""


def read(ctx):
    p = ctx.profiled
    if p is None or not p["iters"] or not p["busy_us"]:
        return None
    return p["busy_us"] / p["iters"]
