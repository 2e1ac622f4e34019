"""Right-hand sides solved to the guarantee (the program reports the solve
converged) per second of the whole window."""


def read(ctx):
    done = sum(r.converged for r in ctx.solves) * ctx.rhs_per_solve
    return done / ctx.window_s
