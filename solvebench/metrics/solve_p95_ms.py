"""95th percentile of the latency of every solve in the window, each from
its call to the synchronize after it returns (numpy's linear
interpolation)."""

import numpy as np


def read(ctx):
    return float(np.percentile([r.latency_s for r in ctx.solves], 95)) * 1e3
