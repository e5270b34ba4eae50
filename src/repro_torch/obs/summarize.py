"""Render a trace file into human-readable tables (port of
``repro.obs.summarize``; reads a trace written by either package).

Two views:

* **span table** — per span-name count / total / mean / p50 / p95 / p99,
  sorted by total time descending, so "where did the run spend its time"
  is the first thing you read.
* **serve waterfall** — one row per ``serve.request`` event (emitted by
  ``repro_torch.serve.runtime`` with the request's full breakdown in
  attrs): queue-wait / batch-form / execute / price bars plus the measured
  total, making padding waste and queue pressure visible per request.

Output is GitHub-flavored markdown (renders fine in a terminal, and CI
pipes it straight into ``$GITHUB_STEP_SUMMARY``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

from .export import read_jsonl
from .metrics import percentiles

_WATERFALL_PARTS = ("queue_wait_s", "batch_form_s", "execute_s", "price_s")
_BAR_WIDTH = 24


def markdown_table(headers: list[str], rows: list[list[str]]) -> str:
    """A GitHub-flavored markdown table (no alignment frills)."""
    lines = ["| " + " | ".join(headers) + " |",
             "|" + "---|" * len(headers)]
    lines += ["| " + " | ".join(str(c) for c in row) + " |" for row in rows]
    return "\n".join(lines)


def emit(report: str, summary_path: str = "") -> None:
    """Print the report; also append to ``summary_path`` when set (pass
    ``$GITHUB_STEP_SUMMARY`` in CI)."""
    print(report)
    if summary_path:
        with open(summary_path, "a") as f:
            f.write(report + "\n")


def _fmt_s(seconds: float) -> str:
    """Seconds rendered in the natural unit (s / ms / µs)."""
    a = abs(seconds)
    if a >= 1.0:
        return f"{seconds:.3f}s"
    if a >= 1e-3:
        return f"{seconds * 1e3:.3f}ms"
    return f"{seconds * 1e6:.1f}us"


def span_table(spans: Sequence[Dict[str, Any]]) -> str:
    """Markdown table aggregating spans by name."""
    by_name: Dict[str, List[float]] = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(float(s["dur"]))
    rows = []
    for name, durs in sorted(by_name.items(),
                             key=lambda kv: -sum(kv[1])):
        ps = percentiles(durs)
        rows.append([name, len(durs), _fmt_s(sum(durs)),
                     _fmt_s(sum(durs) / len(durs)),
                     _fmt_s(ps[50.0]), _fmt_s(ps[95.0]), _fmt_s(ps[99.0])])
    if not rows:
        return "_no spans in trace_"
    return markdown_table(
        ["span", "count", "total", "mean", "p50", "p95", "p99"], rows)


def _bar(parts: Sequence[float], total: float) -> str:
    """Stacked text bar: one glyph class per breakdown part."""
    glyphs = "░▒▓█"
    if total <= 0:
        return ""
    out = []
    for part, g in zip(parts, glyphs):
        out.append(g * max(0, round(part / total * _BAR_WIDTH)))
    return "`" + "".join(out) + "`"


def request_waterfall(events: Sequence[Dict[str, Any]],
                      limit: int = 40) -> str:
    """Markdown waterfall over ``serve.request`` events (first ``limit``)."""
    reqs = [e for e in events if e.get("name") == "serve.request"]
    if not reqs:
        return "_no serve.request events in trace_"
    rows = []
    for e in reqs[:limit]:
        a = e.get("attrs", {})
        parts = [float(a.get(k, 0.0)) for k in _WATERFALL_PARTS]
        total = float(a.get("latency_s", sum(parts)))
        rows.append([
            a.get("rid", "?"), a.get("model", "?"),
            f"B{a.get('bucket', '?')}",
            *[_fmt_s(p) for p in parts],
            _fmt_s(total),
            f"{float(a.get('pad_fraction', 0.0)):.2f}",
            _bar(parts, total),
        ])
    table = markdown_table(
        ["rid", "model", "bucket", "queue-wait", "batch-form", "execute",
         "price", "total", "pad", "waterfall ░queue ▒batch ▓exec █price"],
        rows)
    if len(reqs) > limit:
        table += f"\n\n_…and {len(reqs) - limit} more requests_"
    return table


def metrics_table(metrics: Dict[str, Any]) -> str:
    """Counters and histogram summaries from the trailing metrics record."""
    parts: List[str] = []
    counters = metrics.get("counters") or {}
    if counters:
        rows = [[k, f"{v:g}"] for k, v in sorted(counters.items())]
        parts.append("**Counters**\n\n"
                     + markdown_table(["counter", "value"], rows))
    hists = metrics.get("histograms") or {}
    if hists:
        rows = []
        for name, h in sorted(hists.items()):
            if not h.get("count"):
                continue
            rows.append([name, h["count"],
                         f"{h.get('mean', float('nan')):.4g}",
                         f"{h.get('p50', float('nan')):.4g}",
                         f"{h.get('p95', float('nan')):.4g}",
                         f"{h.get('p99', float('nan')):.4g}"])
        if rows:
            parts.append("**Histograms**\n\n" + markdown_table(
                ["histogram", "count", "mean", "p50", "p95", "p99"], rows))
    return "\n\n".join(parts)


def summarize(path: str, limit: int = 40) -> str:
    """Full markdown report for one JSONL trace file."""
    trace = read_jsonl(path)
    sections = [
        f"## Trace summary — `{path}`",
        "",
        f"{len(trace['spans'])} spans, {len(trace['events'])} events.",
        "",
        "### Time by span",
        "",
        span_table(trace["spans"]),
        "",
        "### Serve request waterfall",
        "",
        request_waterfall(trace["events"], limit=limit),
    ]
    if trace["metrics"]:
        mt = metrics_table(trace["metrics"])
        if mt:
            sections += ["", "### Metrics", "", mt]
    return "\n".join(sections).rstrip() + "\n"
