"""repro_torch.obs — low-overhead structured tracing + metrics for every
layer of the port (port of ``repro.obs``: the same API, the same JSONL and
Chrome-trace formats, the same span, event and counter names).

One module-level switch gates everything:

    from repro_torch import obs
    obs.enable()                      # or REPRO_TORCH_TRACE=/path/trace.jsonl
    with obs.span("serve.execute", bucket=8):
        ...
    obs.counter("engine.jit_miss")
    obs.observe("serve.bucket_occupancy", 0.75)
    obs.save_jsonl("trace.jsonl")     # or obs.save_chrome_trace("t.json")

Design rules (pinned by ``tests/test_torch_obs.py``):

* **Zero-cost when disabled** — ``span()`` returns one shared no-op
  object and the metric calls return before touching any lock.
* **Host-side only** — obs never touches a tensor. A call made while a CUDA
  graph is being captured runs once, at capture, and never at a replay:
  the serving layer records around its captured region, never inside it.
* **Deterministic under test** — ``enable(clock=...)`` injects the time
  source used for every span/event timestamp.
* **On the profiler's clock** — while a ``torch.profiler`` session
  records, every span is also a ``record_function`` range of its name,
  tracing on or off (``span()`` checks one module attribute for it).
  With neither on, ``span()`` stays the shared no-op.

A caller that already holds a region's clock reads records it with
``Tracer.record(name, t0, t1)``; ``split(clock, phases)`` cuts a stretch into
telescoping phases at shared reads, always on, whose regions become spans
and profiler ranges when either is on (``obs/phase.py``; the served step,
``serve/runtime.py``, and ``docs/OBSERVABILITY_TORCH.md``).

Setting ``REPRO_TORCH_TRACE=<path>`` in the environment enables tracing at
import time and writes the JSONL trace (spans + events + a trailing
metrics snapshot) to ``<path>`` at interpreter exit. The variable is not
the reference's ``REPRO_TRACE``, so a process that imports both packages
never gets two exit-time writers on one path.
"""
from __future__ import annotations

import atexit
import os
from typing import Any, Callable, Dict, List, Optional

from . import export
from .metrics import DEFAULT_QS, Histogram, Metrics, percentiles
from .phase import NO_SPLIT, NoSplit, Split
from .trace import (NOOP_SPAN, EventRecord, NoopSpan, Span, SpanRecord,
                    Tracer, _profiler)

__all__ = [
    "enable", "disable", "enabled", "reset", "span", "split", "event",
    "counter", "gauge", "observe", "spans", "events",
    "metrics_snapshot", "save_jsonl", "save_chrome_trace", "percentiles",
    "Histogram", "Metrics", "Tracer", "SpanRecord", "EventRecord", "Span",
    "NoopSpan", "Split", "NoSplit", "NO_SPLIT", "NOOP_SPAN",
    "DEFAULT_QS", "ENV_TRACE",
]

ENV_TRACE = "REPRO_TORCH_TRACE"

_enabled: bool = False
_tracer: Tracer = Tracer()
_metrics: Metrics = Metrics()


def enable(clock: Optional[Callable[[], float]] = None) -> None:
    """Turn tracing on; optionally inject the clock (``() -> float`` in
    seconds) used for every subsequent span and event timestamp."""
    global _enabled
    if clock is not None:
        _tracer.clock = clock
    _enabled = True


def disable() -> None:
    """Turn tracing off. Buffered records stay readable until reset()."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop all buffered spans/events/metrics (keeps the enabled flag)."""
    _tracer.clear()
    _metrics.clear()


def span(name: str, **attrs: Any):
    """Context manager timing a named region. Disabled, it is a profiler
    range alone while a ``torch.profiler`` session records, else the
    shared no-op."""
    if not _enabled:
        if _profiler._is_profiler_enabled:
            return Span(None, name, attrs)
        return NOOP_SPAN
    return _tracer.span(name, **attrs)


def split(clock: Callable[[], float], phases, prefix: str = "") -> Split:
    """A :class:`Split` starting now on ``clock``: its regions become
    spans while tracing is on, and profiler ranges while a
    ``torch.profiler`` session records."""
    return Split(clock, phases, prefix=prefix,
                 tracer=_tracer if _enabled else None,
                 spans=_enabled or _profiler._is_profiler_enabled)


def event(name: str, **attrs: Any) -> None:
    """Record an instant event (evictions, cache decisions, markers)."""
    if not _enabled:
        return
    _tracer.event(name, **attrs)


def counter(name: str, n: float = 1) -> None:
    if not _enabled:
        return
    _metrics.counter_inc(name, n)


def gauge(name: str, value: float) -> None:
    if not _enabled:
        return
    _metrics.gauge_set(name, value)


def observe(name: str, value: float) -> None:
    """Add one sample to the named histogram."""
    if not _enabled:
        return
    _metrics.observe(name, value)


def spans() -> List[SpanRecord]:
    return _tracer.spans()


def events() -> List[EventRecord]:
    return _tracer.events()


def metrics_snapshot() -> Dict[str, Any]:
    return _metrics.snapshot()


def save_jsonl(path: str) -> None:
    export.write_jsonl(path, _tracer.spans(), _tracer.events(),
                       _metrics.snapshot())


def save_chrome_trace(path: str) -> None:
    export.write_chrome_trace(path, _tracer.spans(), _tracer.events())


_env_trace = os.environ.get(ENV_TRACE, "")
if _env_trace:
    enable()
    atexit.register(save_jsonl, _env_trace)
