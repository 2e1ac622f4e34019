"""The program's device→host reads of its stop tests (`host_syncs`) per
inner CG iteration (`span_n:lsbench.cg.iter`), both counted by
`ops/launches.py` over the traced solves: one a CG iteration, plus two a
refinement pass and three a solve on the `cg_ir` path."""


def read(ctx):
    p = ctx.profiled
    if p is None:
        return None
    syncs = p["launches"].get("host_syncs")
    iters = p["launches"].get("span_n:lsbench.cg.iter")
    if not syncs or not iters:
        return None
    return syncs / iters
