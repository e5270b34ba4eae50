"""Requests completed in the window over the window's seconds: every
request of every step from the window's start to the end of its last step."""


def read(ctx):
    if ctx.n_done == 0:
        return None
    return ctx.n_done / (ctx.t1 - ctx.t0)
