"""Shared report-to-``$GITHUB_STEP_SUMMARY`` markdown helper.

A copy of ``repro.audit.gh_summary``: the port's audit (``python -m
repro_torch.audit``) renders its verdict through it, as the reference's
audit and bench-regression gate do, so the job-summary pages look and
behave the same: a title, a one-line verdict, optional tables, appended
(never truncated) to the summary file when one is given.
"""
from __future__ import annotations


def markdown_table(headers: list[str], rows: list[list[str]]) -> str:
    """A GitHub-flavored markdown table (no alignment frills)."""
    lines = ["| " + " | ".join(headers) + " |",
             "|" + "---|" * len(headers)]
    lines += ["| " + " | ".join(str(c) for c in row) + " |" for row in rows]
    return "\n".join(lines)


def render_report(title: str, verdict: str, sections: list[tuple[str, str]],
                  ) -> str:
    """``sections`` is ``[(heading, body_markdown), ...]``; empty bodies
    are skipped so callers can pass conditionally-built sections."""
    parts = [f"## {title}", "", verdict, ""]
    for heading, body in sections:
        if not body:
            continue
        parts += [f"### {heading}", "", body, ""]
    return "\n".join(parts).rstrip() + "\n"


def emit(report: str, summary_path: str = "") -> None:
    """Print the report; also append to ``summary_path`` when set (pass
    ``$GITHUB_STEP_SUMMARY`` in CI)."""
    print(report)
    if summary_path:
        with open(summary_path, "a") as f:
            f.write(report + "\n")
