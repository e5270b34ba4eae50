"""Trace exporters: JSON-lines (the repo-native format) and Chrome-trace
(port of ``repro.obs.export``; the same formats, so one summarizer reads a
trace from either package).

JSONL schema — one object per line, discriminated by ``type``:

    {"type": "span",  "sid": 3, "parent": 1, "name": "serve.execute",
     "ts": 0.12, "dur": 0.003, "depth": 2, "tid": 1234, "attrs": {...}}
    {"type": "event", "name": "serve.plan_evict", "ts": 0.5, "tid": 1234,
     "attrs": {...}}
    {"type": "metrics", "counters": {...}, "gauges": {...},
     "histograms": {...}}

``ts``/``dur`` are seconds from the tracer's (possibly injected) clock.
The Chrome-trace exporter emits the ``traceEvents`` JSON-object form that
``chrome://tracing`` and Perfetto both load: complete events (``ph="X"``)
with microsecond ``ts``/``dur``, instant events as ``ph="i"``.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

from .trace import EventRecord, SpanRecord


def write_jsonl(path: str, spans: Iterable[SpanRecord],
                events: Iterable[EventRecord] = (),
                metrics_snapshot: Optional[Dict[str, Any]] = None) -> None:
    with open(path, "w") as f:
        for s in spans:
            f.write(json.dumps(s.to_dict()) + "\n")
        for e in events:
            f.write(json.dumps(e.to_dict()) + "\n")
        if metrics_snapshot is not None:
            f.write(json.dumps({"type": "metrics", **metrics_snapshot}) + "\n")


def read_jsonl(path: str) -> Dict[str, Any]:
    """Parse a trace written by :func:`write_jsonl` back into plain dicts:
    ``{"spans": [...], "events": [...], "metrics": {...} | None}``."""
    spans: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    metrics: Optional[Dict[str, Any]] = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("type")
            if kind == "span":
                spans.append(rec)
            elif kind == "event":
                events.append(rec)
            elif kind == "metrics":
                metrics = rec
    return {"spans": spans, "events": events, "metrics": metrics}


def chrome_events(spans: Iterable[Dict[str, Any]],
                  events: Iterable[Dict[str, Any]] = ()) -> Dict[str, Any]:
    """The ``{"traceEvents": [...]}`` object form (Perfetto-loadable) of
    span and event records in their JSONL form (``to_dict()`` or
    :func:`read_jsonl`)."""
    out: List[Dict[str, Any]] = []
    for s in spans:
        ev: Dict[str, Any] = {
            "name": s["name"], "ph": "X", "pid": 0, "tid": s.get("tid", 0),
            "ts": s["ts"] * 1e6, "dur": s["dur"] * 1e6,
        }
        if s.get("attrs"):
            ev["args"] = s["attrs"]
        out.append(ev)
    for e in events:
        ev = {"name": e["name"], "ph": "i", "s": "t", "pid": 0,
              "tid": e.get("tid", 0), "ts": e["ts"] * 1e6}
        if e.get("attrs"):
            ev["args"] = e["attrs"]
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def chrome_trace(spans: Iterable[SpanRecord],
                 events: Iterable[EventRecord] = ()) -> Dict[str, Any]:
    """The ``{"traceEvents": [...]}`` object form (Perfetto-loadable)."""
    return chrome_events([s.to_dict() for s in spans],
                         [e.to_dict() for e in events])


def write_chrome_trace(path: str, spans: Iterable[SpanRecord],
                       events: Iterable[EventRecord] = ()) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans, events), f)
