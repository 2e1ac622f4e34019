"""1 − (union of device intervals ÷ traced span), in %."""


def read(ctx):
    p = ctx.profiled
    if p is None or not p["span_us"]:
        return None
    return 100.0 * (1.0 - p["busy_us"] / p["span_us"])
