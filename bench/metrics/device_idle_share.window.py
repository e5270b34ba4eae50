"""Share (%) of the measured window in which the cards ran none of the
program's replays: 100 x (1 - the device seconds of every bucket and card
over the window, from the runtime's ``stats_summary()["device_s"]`` (each
replay's span between its two CUDA timing events), over window seconds x
cards). The window runs without a profiler. Each span counts the gaps
inside a replay as busy, so this is a lower bound on the idle share. None
where the program's summary has no device times for the window."""


def read(ctx):
    s0, s1 = ctx.summary
    after = s1.get("device_s", {})
    before = s0.get("device_s", {})
    busy = sum(s - before.get(b, {}).get(c, 0.0)
               for b, cards in after.items() for c, s in cards.items())
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / ((ctx.t1 - ctx.t0) * ctx.chips))
