"""The port's persistent compile cache: the directory of its nvcc-built
kernel libraries (port of ``repro.core.compile_cache``).

The reference's cold start pays XLA compiles, and its compile cache keeps
them across processes. The port's one persistent compile artifact is the
six kernel libraries ``kernels/_cuda.py`` builds with ``nvcc`` (95–130 s
of a fresh process on the card, all six in parallel); the engine's calls
and the serving layer's CUDA graphs are rebuilt in each process and cannot
be kept on disk. This module is the one place that directory is chosen:

- :func:`configure` points it at a directory; ``REPRO_TORCH_COMPILE_CACHE=
  <dir>`` does the same with no code change (:func:`configure_from_env`),
  so a fleet's replicas share one build by exporting one variable. Neither
  set: the libraries go to ``src/repro_torch/build/`` (git-ignored).
- ``kernels/_cuda.py`` resolves the directory through :func:`cache_dir` at
  build time, never at import, and counts each library it finds there as
  a hit, each one it compiles as a miss and then a put: the module-level
  :data:`counters` and the obs counters ``compile_cache.hit`` /
  ``compile_cache.miss`` / ``compile_cache.put``. The port owns the hook,
  so ``counters["instrumented"]`` is always True.
- ``REPRO_TORCH_CACHE_STATS=<path>``: at process exit, append one JSON line
  of counters + directory totals (``python -m repro_torch.core.
  compile_cache summarize <path>`` renders them).

A library's file name is the hash of its source, every shared header and
the flags, so a shared directory never serves a stale library: a changed
source is a miss and rebuilds.
"""
from __future__ import annotations

import atexit
import json
import os
from pathlib import Path

from .. import obs

ENV_DIR = "REPRO_TORCH_COMPILE_CACHE"
ENV_STATS = "REPRO_TORCH_CACHE_STATS"
DEFAULT_DIR = str(Path(__file__).resolve().parents[1] / "build")

#: process-wide cache statistics, updated by ``kernels/_cuda.build_all``
counters = {"hits": 0, "misses": 0, "puts": 0, "instrumented": True}

_state = {"dir": None, "atexit": False}


def configure(directory: str | None = None) -> str | None:
    """Keep the kernel libraries under ``directory``.

    ``directory=None`` falls back to ``$REPRO_TORCH_COMPILE_CACHE``; with
    neither set this is a no-op returning None. Repeat calls repoint the
    directory. Returns the active directory.
    """
    directory = directory or os.environ.get(ENV_DIR) or None
    if directory is None:
        return None
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    _state["dir"] = directory
    if os.environ.get(ENV_STATS) and not _state["atexit"]:
        _state["atexit"] = True
        atexit.register(_dump_stats, os.environ[ENV_STATS])
    return directory


def configure_from_env() -> str | None:
    """:func:`configure` iff ``$REPRO_TORCH_COMPILE_CACHE`` is set."""
    if os.environ.get(ENV_DIR):
        return configure()
    return None


def cache_dir() -> str:
    """The directory the kernel libraries live in: the configured one,
    else ``$REPRO_TORCH_COMPILE_CACHE``, else ``src/repro_torch/build/``."""
    return _state["dir"] or configure_from_env() or DEFAULT_DIR


_COUNTER = {"hit": "hits", "miss": "misses", "put": "puts"}


def count(kind: str) -> None:
    """One cache decision: ``kind`` is ``hit``, ``miss`` or ``put``."""
    counters[_COUNTER[kind]] += 1
    obs.counter(f"compile_cache.{kind}")


def stats() -> dict:
    """Counters + on-disk totals (libraries and their bytes) for the cache
    directory in use."""
    d = cache_dir()
    out = dict(counters, dir=d, entries=0, bytes=0)
    if os.path.isdir(d):
        for f in os.listdir(d):
            if f.endswith(".so"):
                try:
                    out["bytes"] += os.path.getsize(os.path.join(d, f))
                    out["entries"] += 1
                except OSError:
                    continue  # a concurrent build renamed it
    return out


def _dump_stats(path: str) -> None:
    """Append this process's cache stats as one JSON line (fleet-safe)."""
    try:
        line = json.dumps(dict(stats(), pid=os.getpid()))
        with open(path, "a") as f:
            f.write(line + "\n")
    except OSError:
        pass  # stats are advisory; never fail a run over them


# ---------------------------------------------------------------------------
# CLI: aggregate REPRO_TORCH_CACHE_STATS lines into a markdown table
# ---------------------------------------------------------------------------

def summarize(paths: list[str]) -> str:
    """Markdown table over the JSONL stat lines in ``paths``."""
    rows = []
    for path in paths:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        rows.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
    if not rows:
        return ("## Kernel compile cache\n\nno stats recorded (is "
                f"`{ENV_STATS}` set?)\n")
    hits = sum(r.get("hits", 0) for r in rows)
    misses = sum(r.get("misses", 0) for r in rows)
    puts = sum(r.get("puts", 0) for r in rows)
    total = hits + misses
    rate = f"{hits / total:.0%}" if total else "n/a"
    last = rows[-1]
    lines = [
        "## Kernel compile cache",
        "",
        "| processes | hits | misses | puts | hit rate | libraries | size |",
        "|---:|---:|---:|---:|---:|---:|---:|",
        f"| {len(rows)} | {hits} | {misses} | {puts} | {rate} "
        f"| {last.get('entries', 0)} | {last.get('bytes', 0) / 1e6:.1f} MB |",
        "",
        f"dir: `{last.get('dir')}`",
        "",
    ]
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="summarize REPRO_TORCH_CACHE_STATS JSONL dumps")
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("summarize",
                       help="aggregate stat lines into a markdown table")
    s.add_argument("paths", nargs="+")
    s.add_argument("--summary", default="", metavar="FILE",
                   help="also append the table to FILE "
                        "(e.g. $GITHUB_STEP_SUMMARY)")
    args = ap.parse_args(argv)

    table = summarize(args.paths)
    print(table)
    if args.summary:
        with open(args.summary, "a") as f:
            f.write(table)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
