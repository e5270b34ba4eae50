"""Share (%) of its roofline that B1, the fused spike compact + accumulate
kernel (``csrc/spike_pipeline.cu``), reaches in the traced stretch: the
least time its calls need over its device time. A call's least time is
the larger of its bytes (occupancy and weights read once, charge written
once) over 3.35 TB/s and its adds (the reference's, for the images it
served) over 67 TFLOP/s; one call per event-driven stage per plan run,
each shard of a sharded bucket its own call."""

from bench.harness import profile, roofline

KERNELS = ("fused_spike_accum_encode", "fused_spike_accum_gather")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    device_s = profile.kernel_seconds(t, KERNELS)
    if device_s <= 0:
        return None
    T = ctx.cfg["net"]["T"]
    adds = ctx.ref["add_ops"].astype("float64")
    events = ctx.stages[1:]
    need = 0.0
    for bucket, rids in zip(ctx.traced_steps["bucket"], ctx.traced_rids):
        bucket = int(bucket)
        imgs = ctx.pool_of_rid[rids]
        shards = ctx.chips if ctx.chips > 1 and bucket % ctx.chips == 0 else 1
        k = bucket // shards
        for s in range(shards):
            mine = imgs[s * k:(s + 1) * k]
            for li, st in enumerate(events, start=1):
                need += roofline.bound_s(roofline.b1_call_bytes(st, k * T),
                                         adds[mine, li].sum())
    return 100.0 * need / device_s
