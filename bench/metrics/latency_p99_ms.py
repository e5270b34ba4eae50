"""99th percentile, in ms, of every request due in the window, from the
moment it was due to the moment the client held its response (linear
interpolation between order statistics)."""
import numpy as np


def read(ctx):
    if len(ctx.latency_s) == 0:
        return None
    return float(np.percentile(ctx.latency_s, 99)) * 1e3
