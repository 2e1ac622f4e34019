"""The share of the CG iteration bodies that ran as a replayed CUDA graph
(`graph_replays:lsbench.cg.iter` ÷ `span_n:lsbench.cg.iter`, both counted
by `ops/launches.py` over the traced solves, `solvers/cg.py::CgGraphs`),
in %. A program without the graphs counts no replay: nothing to read."""


def read(ctx):
    p = ctx.profiled
    if p is None:
        return None
    replays = p["launches"].get("graph_replays:lsbench.cg.iter")
    iters = p["launches"].get("span_n:lsbench.cg.iter")
    if replays is None or not iters:
        return None
    return 100.0 * replays / iters
