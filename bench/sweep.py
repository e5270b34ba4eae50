"""Sweeps an open-loop mix's offered rate on one card, once, to find the
knee: the highest rate the program serves without a growing backlog.

    python3 bench/sweep.py --config cifar10 --traffic open --seed 5 \\
        --seconds 5 --rates 6000,8000,10000,12000

One process, one set-up through the configuration's runner (as a cell's
run), then the mix's drive over ``--seconds`` at each rate in turn (each
stretch drains before the next). A line per rate: offered and
completed rate over the stretch, the backlog at its end, the drain after
it, the latency p50 / p99, and the median latency of its first and last
second (a growing backlog shows as the last far above the first). The
mix's ``rate_rps`` is then set by hand to 4/5 of the knee.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_COMPILE_CACHE"] = str(ROOT / "bench" / ".cache"
                                                  / "kernels")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import numpy as np
    import torch

    from bench.harness import cell, traffic

    if not torch.cuda.is_available():
        print("[sweep] needs a CUDA card", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    w = {"name": f"{args.config}.{args.traffic}", "config": args.config,
         "traffic": args.traffic, "chips": 1}
    s = cell.setup(w["name"], args.seed, t_start=T_START, w=w)
    print(f"[sweep] {w['name']} through the {s.cfg['runner']!r} runner, "
          f"set-up {s.setup_s:.2f} s", file=sys.stderr)
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        log = s.prog.new_log()
        d = s.prog.drive(log, mix=dict(s.mix, rate_rps=rate), seed=args.seed,
                         start_s=1000.0 * (k + 1), seconds=args.seconds)
        t0, t_end = d["t0"], d["t1"]
        due = traffic.poisson(args.seed, rate, 1000.0 * (k + 1),
                              args.seconds) - 1000.0 * (k + 1)
        steps = log.step_array()
        done_in = steps["n"][steps["t_done"] <= t0 + args.seconds].sum()
        lat = np.concatenate(log.latency)
        first = lat[due < 1.0]
        last = lat[due >= args.seconds - 1.0]
        print(json.dumps({
            "rate_rps": rate, "requests": len(due),
            "completed_rps": float(done_in / args.seconds),
            "backlog_at_end": int(len(due) - done_in),
            "drain_s": t_end - (t0 + args.seconds),
            "p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "first_s_median_ms": float(np.median(first) * 1e3),
            "last_s_median_ms": float(np.median(last) * 1e3),
            "buckets": {int(b): int((steps["bucket"] == b).sum())
                        for b in np.unique(steps["bucket"])}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
