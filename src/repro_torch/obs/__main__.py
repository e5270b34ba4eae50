"""CLI: ``python -m repro_torch.obs summarize <trace.jsonl> [--limit N]
[--chrome out.json] [--summary $GITHUB_STEP_SUMMARY]``.

``summarize`` renders the per-span latency/count table, the serve-request
waterfall, and the metrics snapshot as markdown; ``--chrome`` additionally
re-exports the trace in Chrome-trace format for Perfetto. It reads a trace
written by either package (the formats are the same).
"""
from __future__ import annotations

import argparse
import json
import sys

from .export import chrome_events, read_jsonl
from .summarize import emit, summarize


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_sum = sub.add_parser("summarize",
                           help="render a JSONL trace as markdown tables")
    p_sum.add_argument("trace", help="path to a trace.jsonl")
    p_sum.add_argument("--limit", type=int, default=40,
                       help="max requests in the waterfall (default 40)")
    p_sum.add_argument("--chrome", default="",
                       help="also write a Chrome-trace JSON to this path")
    p_sum.add_argument("--summary", default="",
                       help="append the report to this file "
                            "(pass $GITHUB_STEP_SUMMARY in CI)")
    args = parser.parse_args(argv)

    if args.cmd == "summarize":
        emit(summarize(args.trace, limit=args.limit), args.summary)
        if args.chrome:
            trace = read_jsonl(args.trace)
            with open(args.chrome, "w") as f:
                json.dump(chrome_events(trace["spans"], trace["events"]), f)
            print(f"chrome trace -> {args.chrome}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
