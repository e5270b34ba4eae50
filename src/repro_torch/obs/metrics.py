"""Counters, gauges, and histograms with numpy-exact percentiles (port of
``repro.obs.metrics``).

The histogram keeps raw samples (these are trace-session-scoped, not
long-running-daemon-scoped, so memory is bounded by the run) and computes
percentiles with ``numpy.percentile``'s default linear interpolation —
the same estimator as the reference package's, so
``repro_torch.serve.bench`` reports the reference's numbers.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Sequence, Tuple

import numpy as np

DEFAULT_QS: Tuple[float, ...] = (50.0, 95.0, 99.0)


def percentiles(values: Iterable[float],
                qs: Sequence[float] = DEFAULT_QS) -> Dict[float, float]:
    """``{q: value}`` via ``np.percentile`` (linear interpolation).
    Empty input yields NaNs rather than raising so callers can render
    partial tables."""
    # float32 like everything else in the repo: these are durations and
    # ratios (already small diffs), where f32's 1e-7 relative precision is
    # far below timer noise
    a = np.asarray(list(values), dtype=np.float32)
    if a.size == 0:
        return {float(q): float("nan") for q in qs}
    out = np.percentile(a, list(qs))
    return {float(q): float(v) for q, v in zip(qs, out)}


class Histogram:
    """Raw-sample histogram; summary() reports count/mean/min/max/p50/p95/p99."""

    def __init__(self) -> None:
        self._values: List[float] = []

    def observe(self, value: float) -> None:
        self._values.append(float(value))

    @property
    def count(self) -> int:
        return len(self._values)

    def values(self) -> List[float]:
        return list(self._values)

    def percentile(self, q: float) -> float:
        return percentiles(self._values, (q,))[float(q)]

    def summary(self) -> Dict[str, float]:
        if not self._values:
            return {"count": 0}
        a = np.asarray(self._values, dtype=np.float32)
        ps = percentiles(a, DEFAULT_QS)
        return {
            "count": int(a.size),
            "mean": float(a.mean()),
            "min": float(a.min()),
            "max": float(a.max()),
            "p50": ps[50.0],
            "p95": ps[95.0],
            "p99": ps[99.0],
        }


class Metrics:
    """Thread-safe named counters / gauges / histograms."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter_inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = self._histograms[name] = Histogram()
            hist.observe(value)

    def counter_value(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = self._histograms[name] = Histogram()
            return hist

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.summary()
                               for k, h in self._histograms.items()},
            }

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
