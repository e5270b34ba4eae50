"""Share (%) of the cards' fp32 peak that the window's completed requests
needed: each request's operations as the reference counts them for its
image (the analog layer's in-bounds multiply-adds at two operations, once;
every event-driven and classifier accumulate at one), summed over the
window's requests, over window seconds x cards x 67 TFLOP/s. Pure
accumulates cannot pass half of that peak."""
from bench.harness import roofline


def read(ctx):
    if ctx.n_done == 0:
        return None
    adds = ctx.ref["add_ops"].astype("float64")
    per_image = roofline.analog_flops(ctx.stages[0]) + adds[:, 1:].sum(1)
    flops = per_image[ctx.pool_of_rid[ctx.window_rids]].sum()
    peak = (ctx.t1 - ctx.t0) * ctx.chips * roofline.FP32_FLOP_PER_S
    return 100.0 * flops / peak
