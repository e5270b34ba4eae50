"""Dynamic bucketed batching (port of ``repro.serve.batching``, unchanged).

Serving a few fixed batch shapes keeps per-shape state (cuDNN algorithm
choices now, captured CUDA graphs later) reusable. The policy quantizes
every batch to one of a few fixed *buckets* (powers of two by default,
B ∈ {1, 4, 16, 64}): take up to ``max_bucket`` waiting requests, round the
count to a bucket (up with zero-padding, or down to a completely full
smaller bucket when padding would exceed half the slots — padded compute
is real even though padded results are masked). The engine's
mask contract (see ``engine.infer_batch``) guarantees the padded slots
cannot pollute the valid rows — results for the first ``n_valid`` rows are
identical to an unpadded call — so correctness never depends on what the
padding contains.
"""
from __future__ import annotations

import bisect

import numpy as np

DEFAULT_BUCKETS = (1, 4, 16, 64)


class BucketPolicy:
    """The bucket ladder + padding rules for the dynamic batcher.

    ``bucket_sizes`` must be strictly increasing positive ints. ``select``
    maps a waiting-request count to the bucket it executes in; a count
    above ``max_bucket`` means the batcher takes ``max_bucket`` requests
    now and leaves the rest queued for the next step.
    """

    def __init__(self, bucket_sizes=DEFAULT_BUCKETS):
        sizes = tuple(bucket_sizes)
        if not sizes:
            raise ValueError("bucket_sizes must be non-empty")
        if any(not isinstance(b, int) or b < 1 for b in sizes):
            raise ValueError(
                f"bucket sizes must be positive ints, got {sizes!r}")
        if list(sizes) != sorted(set(sizes)):
            raise ValueError(
                f"bucket sizes must be strictly increasing, got {sizes!r}")
        self.bucket_sizes = sizes

    @property
    def max_bucket(self) -> int:
        return self.bucket_sizes[-1]

    def select(self, n_waiting: int) -> int:
        """Bucket for a batch of ``n_waiting`` requests (capped at max).

        Rounds UP to the smallest bucket that fits — unless that would
        leave the bucket more than half padding AND a smaller bucket could
        run completely full, in which case it rounds DOWN (the batcher
        serves a full bucket now and queues the remainder). Padded slots
        are masked out of the *results* for free, but their *compute* is
        real: a half-empty bucket costs more than two exact-fit smaller
        ones, so the policy never pads past half.
        """
        if n_waiting < 1:
            raise ValueError(f"n_waiting must be >= 1, got {n_waiting}")
        i = bisect.bisect_left(self.bucket_sizes, n_waiting)
        if i == len(self.bucket_sizes):
            return self.max_bucket                  # cap: take max, no pad
        up = self.bucket_sizes[i]
        if i > 0 and 2 * n_waiting <= up:
            return self.bucket_sizes[i - 1]         # round down: run full
        return up

    def pad(self, images: np.ndarray, bucket: int) -> np.ndarray:
        """(n, H, W, C) -> (bucket, H, W, C), zero rows appended.

        Zeros are an arbitrary choice — the mask contract makes any padding
        content equivalent — but they keep padded work minimal on the
        event-driven backends (a zero image emits no spikes).
        """
        n = images.shape[0]
        if n > bucket:
            raise ValueError(f"{n} images do not fit bucket {bucket}")
        if n == bucket:
            return images
        pad = np.zeros((bucket - n,) + images.shape[1:], images.dtype)
        return np.concatenate([images, pad])
