"""The program's layout build (`setup_breakdown["layout_s"]`: the SELL f32
and f64 layouts of A, matrix/sell.py), seconds."""


def read(ctx):
    return ctx.setup_breakdown.get("layout_s")
