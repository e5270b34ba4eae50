"""Runs one benchmark cell once and prints its result as the last line.

    python3 bench/run.py --workload cifar10-closed --seed 7 --seconds 10 \\
        --trace 0

from the root of a checkout. The cell, its configuration, its traffic
mix and its metrics are found by name from ``BENCHMARK.json``. Exits 1,
printing no result, without the CUDA cards the cell asks for, or if the
process has loaded JAX or the JAX package by the time the result is due.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "bench" / ".cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program at a fixed place inside
    # the checkout, so only a checkout's first run builds
    os.environ["REPRO_TORCH_COMPILE_CACHE"] = str(CACHE / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("REPRO_TORCH_TRACE", None)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench.harness import cell, manifest

    chips = manifest.workload(manifest.load(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    result = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    bad = cell.forbidden_modules()
    if bad:
        print(f"[bench] the process loaded {bad}: no result", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
