"""Span tracing core: monotonic nested spans with thread-safe buffering
(port of ``repro.obs.trace``, record for record).

A :class:`Tracer` hands out context-manager spans.  Each thread keeps its
own span stack (``threading.local``) so nesting depth and parent links are
correct even when the serve runtime's admission thread and the caller's
thread trace concurrently; finished spans are appended to one shared,
lock-guarded buffer.

The clock is injectable (any ``() -> float`` in seconds) so tests can pin
exact durations; the default is ``time.perf_counter``.  A caller that
already holds a region's clock reads opens and closes its span at them
(:meth:`Span.begin` / :meth:`Span.end`), or records a past one
(:meth:`Tracer.record`), so a span and a counter built from the same reads
agree exactly.  Everything here is plain host-side Python: a call made
while a CUDA graph is being captured runs once, at capture, and never at a
replay, so callers record around a captured region, never inside it.

The profiler mirror: while a ``torch.profiler`` session records (read from
``torch.autograd.profiler._is_profiler_enabled``, a module attribute, so
the check is one attribute read), a :class:`Span` is also a
``record_function`` range of the same name, opened in :meth:`Span.begin`
and closed in :meth:`Span.end`, on the profiler's clock beside the
device's operations. A span with no tracer is that range alone.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from torch.autograd import profiler as _profiler


@dataclass
class SpanRecord:
    """One finished span. ``t0``/``t1`` are clock readings in seconds."""

    sid: int
    parent: int  # sid of the enclosing span, -1 for roots
    name: str
    t0: float
    t1: float
    depth: int
    tid: int
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "type": "span",
            "sid": self.sid,
            "parent": self.parent,
            "name": self.name,
            "ts": self.t0,
            "dur": self.dur,
            "depth": self.depth,
            "tid": self.tid,
        }
        if self.attrs:
            d["attrs"] = self.attrs
        return d


@dataclass
class EventRecord:
    """One instant (zero-duration) event."""

    name: str
    ts: float
    tid: int
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"type": "event", "name": self.name,
                             "ts": self.ts, "tid": self.tid}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class Span:
    """A live span; use as a context manager, or open and close it at given
    clock readings (:meth:`begin` / :meth:`end`). ``set()`` adds attributes
    after entry (e.g. a batch size known only mid-span). With no tracer it
    records nothing and is a profiler range alone."""

    __slots__ = ("_tracer", "name", "attrs", "sid", "parent", "depth", "_t0",
                 "_range")

    def __init__(self, tracer: Optional["Tracer"], name: str,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.sid = -1
        self.parent = -1
        self.depth = 0
        self._t0 = 0.0
        self._range = None

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def begin(self, t0: float) -> "Span":
        """Open the span at the clock reading ``t0``: it becomes the parent
        of spans opened on this thread until :meth:`end`; while a profiler
        records, its range opens here."""
        tr = self._tracer
        if tr is not None:
            stack = tr._stack()
            self.sid = next(tr._ids)
            self.parent = stack[-1].sid if stack else -1
            self.depth = len(stack)
            stack.append(self)
            self._t0 = t0
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def end(self, t1: float) -> Optional[SpanRecord]:
        """Close the span (and its range) at the clock reading ``t1`` and
        record it."""
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        tr = self._tracer
        if tr is None:
            return None
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # tolerate out-of-order exits
            stack.remove(self)
        rec = SpanRecord(
            sid=self.sid, parent=self.parent, name=self.name,
            t0=self._t0, t1=t1, depth=self.depth,
            tid=threading.get_ident(), attrs=self.attrs)
        tr._record(rec)
        return rec

    def _now(self) -> float:
        return self._tracer.clock() if self._tracer is not None else 0.0

    def __enter__(self) -> "Span":
        return self.begin(self._now())

    def __exit__(self, *exc: Any) -> bool:
        self.end(self._now())
        return False


class NoopSpan:
    """Shared do-nothing span returned while tracing is disabled — the
    whole point is that the disabled hot path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "NoopSpan":
        return self


NOOP_SPAN = NoopSpan()


class Tracer:
    """Collects spans and instant events from any number of threads."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._spans: List[SpanRecord] = []
        self._events: List[EventRecord] = []
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            self._spans.append(rec)

    def span(self, name: str, **attrs: Any) -> Span:
        return Span(self, name, attrs)

    def record(self, name: str, t0: float, t1: float,
               **attrs: Any) -> SpanRecord:
        """Record a finished span whose clock reads the caller already
        holds (past: no profiler range); its parent is the span open on
        this thread, if any."""
        stack = self._stack()
        rec = SpanRecord(
            sid=next(self._ids), parent=stack[-1].sid if stack else -1,
            name=name, t0=t0, t1=t1, depth=len(stack),
            tid=threading.get_ident(), attrs=attrs)
        self._record(rec)
        return rec

    def event(self, name: str, **attrs: Any) -> None:
        rec = EventRecord(name=name, ts=self.clock(),
                          tid=threading.get_ident(), attrs=attrs)
        with self._lock:
            self._events.append(rec)

    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def events(self) -> List[EventRecord]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._events.clear()
        self._ids = itertools.count()
