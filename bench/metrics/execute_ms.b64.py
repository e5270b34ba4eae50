"""Mean ms of the window's bucket-64 executions: the runtime's host clock
around ``run_bucket`` (copy in, graph replay, synchronize, copy out)."""


def read(ctx):
    s = ctx.steps
    sel = s["bucket"] == 64
    if not sel.any():
        return None
    return float(s["service_s"][sel].mean()) * 1e3
