"""The host's mean time inside one CG iteration body
(`span_ns:lsbench.cg.iter` ÷ `span_n:lsbench.cg.iter`, `solvers/cg.py::
cg_loop`, the stop test outside it) over the traced solves, µs: the
enqueue of the iteration's kernels, the preconditioner's included."""


def read(ctx):
    p = ctx.profiled
    if p is None:
        return None
    ns = p["launches"].get("span_ns:lsbench.cg.iter")
    n = p["launches"].get("span_n:lsbench.cg.iter")
    if not ns or not n:
        return None
    return ns / n / 1e3
