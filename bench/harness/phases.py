"""The window's share of the served step's phases in its bucket-64
executions, read from the runtime's ``stats_summary()`` snapshots taken
before and after the window.

``phase_s`` holds the seven phases every step is cut into at shared clock
reads, summed per bucket; the window's part of one is its difference
between the two snapshots, and its mean a step divides that by the
window's bucket-64 executions (the difference of ``bucket_histogram[64]``).
"""
from __future__ import annotations

BUCKET = 64


def executions(ctx) -> int:
    """Bucket-64 executions in the window."""
    s0, s1 = ctx.summary
    return (s1["bucket_histogram"].get(BUCKET, 0)
            - s0["bucket_histogram"].get(BUCKET, 0))


def mean_ms(ctx, phase: str) -> float | None:
    """Mean ms of the window's bucket-64 executions spent in ``phase``.
    None where none ran, or where the program's summary has no
    ``phase_s``."""
    s0, s1 = ctx.summary
    n = executions(ctx)
    if n <= 0 or BUCKET not in s1.get("phase_s", {}):
        return None
    was = s0["phase_s"].get(BUCKET, {}).get(phase, 0.0)
    return (s1["phase_s"][BUCKET][phase] - was) / n * 1e3
