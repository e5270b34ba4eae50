"""Share (%) of the runtime's step time spent outside the device call: the
sum over the window's steps of batch forming and pricing with response
assembly, over the sum of whole steps, from each step's own telescoping
clock reads (``batch_form_s + service_s + price_s == step_total_s``)."""


def read(ctx):
    s = ctx.steps
    if len(s["n"]) == 0:
        return None
    return 100.0 * (s["batch_form_s"] + s["price_s"]).sum() / s["step_total_s"].sum()
