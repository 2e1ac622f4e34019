"""Mean inner Krylov iterations per solve over the window
(`SolveResult.iters`: cg_loop's iterations summed over the passes)."""


def read(ctx):
    iters = [r.iters for r in ctx.solves]
    return sum(iters) / len(iters) if any(iters) else None
