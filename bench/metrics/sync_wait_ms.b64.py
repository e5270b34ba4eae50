"""Mean ms of the window's bucket-64 executions spent in the served
step's ``sync_wait`` phase (registry):
the one host sync after the replay (the wait for the device) and the
device-event reads after it.
Read by ``bench.harness.phases`` from the runtime's
``stats_summary()["phase_s"]`` diffed over the window; None where no
bucket of 64 ran, or where the program's summary has no ``phase_s``."""
from bench.harness import phases


def read(ctx):
    return phases.mean_ms(ctx, "sync_wait")
