"""The host's mean time inside one AMG preconditioner apply
(`span_ns:lsbench.amg.vcycle` ÷ `span_n:lsbench.amg.vcycle`,
`solvers/amg.py::amg_precond`, every level and the coarse solve) over the
traced solves, µs."""


def read(ctx):
    p = ctx.profiled
    if p is None:
        return None
    ns = p["launches"].get("span_ns:lsbench.amg.vcycle")
    n = p["launches"].get("span_n:lsbench.amg.vcycle")
    if not ns or not n:
        return None
    return ns / n / 1e3
