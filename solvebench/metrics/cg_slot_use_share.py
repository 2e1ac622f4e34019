"""The share of the graphed CG loop's guarded iterations that ran, in %:
the traced solves' inner iterations (their results' `iters`, summed) ÷
the slots of the block graphs replayed for them
(`graph_slots:lsbench.cg.block`, counted by `ops/launches.py`,
`solvers/cg.py::CgGraphs`). The rest are slots whose guard skipped the
body. A program without the block graph counts no slot: nothing to
read."""

SLOTS = "graph_slots:lsbench.cg.block"


def read(ctx):
    p = ctx.profiled
    if p is None:
        return None
    slots = p["launches"].get(SLOTS)
    if not slots:
        return None
    return 100.0 * p["iters"] / slots
