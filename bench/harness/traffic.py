"""The one request generator every traffic mix's file parameterises.

A mix file (``bench/traffic/<name>.json``) gives ``kind`` and its numbers;
the two kinds built in (``serve.KINDS``) are:

- ``closed``: a saturated backlog. ``backlog_buckets`` full largest
  buckets are queued before the window, and every completed request is
  replaced at once, so every step serves a full largest bucket.
- ``poisson``: arrivals at ``rate_rps`` on the wall clock, exponential
  gaps drawn from the seed.

A mix of another kind brings its own ``drive`` in
``bench/traffic/<name>.py`` (``serve.driver``). ``"warm": "largest"``
warms only the largest bucket in set-up, for a mix that serves no other;
by default every bucket of the ladder is warmed.

Every request serves one image of a pool of ``pool`` procedural images of
the configuration's dataset, made from the seed; which one is drawn from
the seed too. Each stream has a key of its own under the seed, so the
pool, the draws and the arrivals do not move one another.
"""
from __future__ import annotations

import numpy as np

from . import images

POOL, DRAWS, ARRIVALS = 0, 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([stream, seed])


def pool(dataset: str, n: int, seed: int) -> np.ndarray:
    """(n, H, W, C) float32 request images."""
    return images.DATASETS[dataset](n, seed=int(rng(seed, POOL)
                                                .integers(2**62)))[0]


class Draws:
    """Pool indices of successive requests, drawn from the seed in blocks."""

    def __init__(self, seed: int, pool_size: int, block: int = 4096):
        self._rng, self._n, self._block = rng(seed, DRAWS), pool_size, block
        self._buf, self._i = np.empty(0, np.int64), 0

    def next(self) -> int:
        if self._i == len(self._buf):
            self._buf = self._rng.integers(0, self._n, self._block)
            self._i = 0
        self._i += 1
        return int(self._buf[self._i - 1])


def poisson(seed: int, rate_rps: float, start_s: float,
            seconds: float) -> np.ndarray:
    """Due times in [start_s, start_s + seconds) of Poisson arrivals at
    ``rate_rps``, seconds from the window's start. A later stretch of the
    same seed draws its own gaps (``start_s`` keys the stream)."""
    g = np.random.default_rng([ARRIVALS, seed, int(start_s * 1e6)])
    n = int(rate_rps * seconds * 1.2) + 64
    due = start_s + np.cumsum(g.exponential(1.0 / rate_rps, n))
    while due[-1] < start_s + seconds:
        more = due[-1] + np.cumsum(g.exponential(1.0 / rate_rps, n))
        due = np.concatenate([due, more])
    return due[due < start_s + seconds]
