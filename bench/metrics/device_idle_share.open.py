"""Share (%) of the traced stretch in which no operation ran on the device:
1 - busy / wall, busy as the union of the profiler's device intervals,
averaged over the cards."""


def read(ctx):
    t = ctx.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
