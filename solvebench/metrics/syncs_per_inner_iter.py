"""The program's device→host reads (`host_syncs`, counted by
`ops/launches.py`) per inner CG iteration (the `iters` of the traced
solves' results, summed), over the traced solves: the eager loop reads
once an iteration, the graphed loop once a block of guarded iterations
(`solvers/cg.py::CgGraphs`); `cg_ir` adds one a refinement pass and two
a solve. A program that counts no read gives nothing to read."""


def read(ctx):
    p = ctx.profiled
    if p is None:
        return None
    syncs = p["launches"].get("host_syncs")
    iters = p.get("iters")
    if not syncs or not iters:
        return None
    return syncs / iters
