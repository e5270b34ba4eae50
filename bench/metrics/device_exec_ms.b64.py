"""Mean ms of device time a window's bucket-64 execution took a card:
each card's seconds between the two CUDA timing events of its replays
(from the input's host-to-device copy to the last work its plan enqueues
there, gaps inside counted busy, so an upper bound on busy time), read
from the runtime's ``stats_summary()["device_s"]``, diffed over the
window, over the window's bucket-64 executions, averaged over the cards.
None where none ran, or where the program's summary has no ``device_s``
(or, on the CPU, an empty one)."""

BUCKET = 64


def read(ctx):
    s0, s1 = ctx.summary
    n = (s1["bucket_histogram"].get(BUCKET, 0)
         - s0["bucket_histogram"].get(BUCKET, 0))
    cards = s1.get("device_s", {}).get(BUCKET, {})
    if n <= 0 or not cards:
        return None
    was = s0["device_s"].get(BUCKET, {})
    per_card = [(s - was.get(c, 0.0)) / n for c, s in cards.items()]
    return sum(per_card) / len(per_card) * 1e3
