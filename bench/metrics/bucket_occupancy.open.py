"""Share (%) of executed bucket slots that held a request in the window:
served / (served + padded), from the runtime's service counters."""


def read(ctx):
    a, b = ctx.summary
    served = b["served"] - a["served"]
    slots = sum(k * (v - a["bucket_histogram"].get(k, 0))
                for k, v in b["bucket_histogram"].items())
    return 100.0 * served / slots if slots else None
