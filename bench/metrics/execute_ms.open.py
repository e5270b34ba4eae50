"""Mean ms of every execution in the window, whatever its bucket: the
runtime's host clock around ``run_bucket``."""


def read(ctx):
    s = ctx.steps
    if len(s["n"]) == 0:
        return None
    return float(s["service_s"].mean()) * 1e3
