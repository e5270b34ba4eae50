"""Mean ms of the window's bucket-64 executions spent in the served
step's ``copy_in`` phase (registry):
the plan lookup, the contiguous copy, the pinned staging copy and the
host-to-device enqueue, summed over shards.
Read by ``bench.harness.phases`` from the runtime's
``stats_summary()["phase_s"]`` diffed over the window; None where no
bucket of 64 ran, or where the program's summary has no ``phase_s``."""
from bench.harness import phases


def read(ctx):
    return phases.mean_ms(ctx, "copy_in")
