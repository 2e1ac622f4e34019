"""The f32 SpMV's share of its roofline, in %: the least time one y = A·x
can take (the larger of the function's CSR bytes over the card's HBM peak
and its operations over the f32 peak, `costs/spmv_csr.py`; the bytes
bound it) divided by the mean device time of the f32 SELL kernel's events
in the trace of the traced solves.

Read only where every one of those events is A's product: the launches
equal the inner iterations (one SpMV per CG iteration, as with Jacobi),
and the trace holds as many events as the kernel counter counted."""

KERNEL = "spmv_sell_f32_kernel"


def read(ctx):
    p = ctx.profiled
    if p is None or ctx.peaks is None or not p["events_complete"]:
        return None
    if p["launches"].get("sell_f32", 0) != p["iters"]:
        return None
    durs = [d for name, d in p["device_events"] if KERNEL in name]
    if not durs:
        return None
    mean_s = sum(durs) / len(durs) * 1e-6
    cost = ctx.cost("spmv_csr")
    shape = (ctx.n, ctx.n, ctx.nnz, 4)
    bound_s = max(cost.bytes_moved(*shape) / ctx.peaks["hbm_bytes_per_s"],
                  cost.flops(*shape) / ctx.peaks["f32_flops_per_s"])
    return 100.0 * bound_s / mean_s
