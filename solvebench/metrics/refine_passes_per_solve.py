"""Mean f64 refinement passes per solve over the window
(`SolveResult.extra["refine_passes"]`, solvers/refine.py)."""


def read(ctx):
    passes = [r.passes for r in ctx.solves]
    return sum(passes) / len(passes) if any(passes) else None
