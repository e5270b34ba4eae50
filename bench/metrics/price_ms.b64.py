"""Mean ms of the window's bucket-64 executions spent in the served
step's ``price`` phase (runtime): ``price_record`` over the bucket and its two reads of the
energies. Read from the runtime's
``stats_summary()["phase_s"]``, the seven phases every step is cut into at
shared clock reads, diffed between the snapshots taken before and after
the window, over the window's bucket-64 executions (the difference of
``bucket_histogram[64]``). None where none ran, or where the program's
summary has no ``phase_s``."""

PHASE, BUCKET = "price", 64


def read(ctx):
    s0, s1 = ctx.summary
    n = (s1["bucket_histogram"].get(BUCKET, 0)
         - s0["bucket_histogram"].get(BUCKET, 0))
    if n <= 0 or BUCKET not in s1.get("phase_s", {}):
        return None
    was = s0["phase_s"].get(BUCKET, {}).get(PHASE, 0.0)
    return (s1["phase_s"][BUCKET][PHASE] - was) / n * 1e3
