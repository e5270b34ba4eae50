"""Set-up seconds: process start to the first timed request (imports, the
kernel libraries from the compile cache, weights and the request pool from
the seed, graph capture and warm steps of the cell's buckets)."""


def read(ctx):
    return ctx.setup_s
