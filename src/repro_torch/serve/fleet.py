"""Replica fleet: N worker processes serving one checkpointed registry
(port of ``repro.serve.fleet``).

One process builds the model and checkpoints it (``serve/persist.py``),
then every replica cold-starts from the shared artifacts —

    python -m repro_torch.serve.fleet --replicas 4 --cache-dir /var/repro

``--cache-dir D`` holds everything shared: ``D/registry`` (the params +
plan-ladder checkpoint), ``D/kernels`` (the kernel compile cache, exported
to workers as ``REPRO_TORCH_COMPILE_CACHE``: a replica finds the six
libraries there and compiles nothing) and ``D/study`` (train/convert
artifacts when ``--trained``). Workers are plain subprocesses of this
module with ``--worker`` (started by ``subprocess``, so a parent that has
initialised CUDA never forks), with ``PYTHONPATH`` naming this checkout's
``src``. Each restores the registry (re-capturing every saved bucket's
CUDA graph on the card), warms the bucket ladder (execute-only), serves
the same deterministic request set to every registered model, and reports
one JSON line: time to first response measured from the *parent's* spawn
time (interpreter and imports included, what a scale-out event pays),
restore and warmup seconds, ``compile_count``, every response's pred and
float32 energy, its compile-cache counters and its kernel launches.

The parent then asserts the replies agree **bit for bit** — same preds,
same float32 per-request energies on every replica — and raises
:class:`~.api.ServeError` otherwise. A worker that hangs past ``--timeout``
gets the whole fleet killed and exit code 124; a worker that fails (for
one, a worker without a GPU unless ``--device cpu``) fails the fleet.
The parent prints, as its last line, ``{"replicas": [...]}``: every
worker's report.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from .. import obs
from ..core import compile_cache
from .api import ServeError
from .batching import BucketPolicy
from .bench import build_runtime, request_images, serve_spec
from .runtime import ServeRuntime

_T0_ENV = "REPRO_TORCH_FLEET_T0"
SRC = str(Path(__file__).resolve().parents[2])   # the checkout's src/
# --quick serves the reference coldstart tests' small net
QUICK_NET = "4C3-P2-8"


def _dirs(cache_dir: str) -> tuple[str, str, str]:
    cache_dir = os.path.abspath(cache_dir)
    return (os.path.join(cache_dir, "registry"),
            os.path.join(cache_dir, "kernels"),
            os.path.join(cache_dir, "study"))


def _device(args):
    # None resolves to the card and raises without one: no silent CPU run
    return None if args.device == "cuda" else "cpu"


def _spec(args):
    spec = serve_spec(args.dataset, backend=args.backend)
    return spec.replace(net=QUICK_NET) if args.quick else spec


def _buckets(args) -> tuple:
    return tuple(int(b) for b in args.buckets.split(","))


def _build_registry(args, ck_dir: str, study_dir: str):
    """Build (train if ``--trained``), warm up, and checkpoint."""
    from . import persist

    cache = None
    if args.trained:
        from ..study import StudyCache

        cache = StudyCache(dir=study_dir)
    runtime, _ = build_runtime(_spec(args), _buckets(args),
                               trained=args.trained, cache=cache,
                               device=_device(args))
    persist.save_registry(runtime.registry, ck_dir)
    return runtime.registry


def serve_requests(registry, images, buckets):
    """Every image to every registered model (models in registry order,
    images in order), through one runtime; returns (responses sorted by
    rid, the wall time when the first batch's responses were out). The
    same call on the same registry and images gives the same rids, so two
    replicas compare row by row."""
    runtime = ServeRuntime(registry, BucketPolicy(buckets))
    for name in registry.names():
        for img in images:
            runtime.submit(img, name)
    with obs.span("coldstart.first_execute"):
        responses = runtime.step()
    # audit: allow[host-sync] the measurement itself: first response is out
    t_first = time.time()
    responses += runtime.run_until_drained()
    responses.sort(key=lambda r: r.rid)
    return responses, t_first


def replayed_launches(registry) -> dict:
    """Kernel launches the registry's graph replays ran: each bucket's
    captured launches times its replays (a replay runs no wrapper, so
    ``ops.launch_counts`` misses them). Empty on the CPU."""
    out: dict = {}
    for name in registry.names():
        h = registry.get(name)
        for b, n in h.replay_count.items():
            for k, v in h.plan_launches.get(b, {}).items():
                out[k] = out.get(k, 0) + v * n
    return out


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------

def run_worker(args) -> int:
    """One replica: restore -> warm up -> serve -> report a JSON line."""
    from ..kernels import ops
    from . import persist

    # audit: allow[host-sync] cold-start metering: first-response time is
    # charged from parent-side spawn (interpreter + imports included)
    now = time.time()
    t0 = float(os.environ.get(_T0_ENV, now))
    if args.trace:
        obs.enable()
    ck_dir, kernels_dir, _ = _dirs(args.cache_dir)
    compile_cache.configure(kernels_dir)

    with obs.span("coldstart.restore"):
        registry = persist.load_registry(ck_dir, device=_device(args))
    # audit: allow[host-sync] phase timing for the cold-start breakdown
    t_restore = time.time()

    buckets = _buckets(args)
    with obs.span("coldstart.warmup", buckets=str(buckets)):
        for name in registry.names():
            registry.get(name).warmup(buckets)
    # audit: allow[host-sync] phase timing for the cold-start breakdown
    t_warm = time.time()

    images = request_images(args.dataset, args.requests, seed=args.seed)
    responses, t_first = serve_requests(registry, images, buckets)
    # audit: allow[host-sync] total serve wall time for the report
    t_done = time.time()

    cache = compile_cache.stats()
    result = {
        "replica": args.replica,
        "models": list(registry.names()),
        "device": str(registry.device),
        "n": len(responses),
        "first_response_s": t_first - t0,
        "serve_path_s": t_first - now,
        "restore_s": t_restore - now,
        "warmup_s": t_warm - t_restore,
        "total_s": t_done - t0,
        "compile_count": sum(registry.get(n).compile_count
                             for n in registry.names()),
        "preds": [int(r.pred) for r in responses],
        # float32 energies pass through float() exactly, so JSON round-trips
        # them bit-identically for the parent's cross-replica comparison
        "energies": [float(np.float32(r.energy_j)) for r in responses],
        "compile_cache": {k: cache[k] for k in
                          ("hits", "misses", "puts", "dir")},
        "launches": dict(ops.launch_counts),
        "replayed": replayed_launches(registry),
    }
    if args.trace:
        obs.save_jsonl(args.trace)
    print(json.dumps(result), flush=True)
    return 0


# ---------------------------------------------------------------------------
# Parent
# ---------------------------------------------------------------------------

def _worker_cmd(args, replica: int) -> list[str]:
    cmd = [sys.executable, "-m", "repro_torch.serve.fleet", "--worker",
           "--cache-dir", args.cache_dir, "--replica", str(replica),
           "--requests", str(args.requests), "--seed", str(args.seed),
           "--buckets", args.buckets, "--dataset", args.dataset,
           "--backend", args.backend, "--device", args.device]
    if args.trace:
        root, ext = os.path.splitext(args.trace)
        cmd += ["--trace", f"{root}.r{replica}{ext or '.jsonl'}"]
    return cmd


def _worker_env(kernels_dir: str) -> dict:
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, **{
        compile_cache.ENV_DIR: kernels_dir,
        "PYTHONPATH": SRC + (os.pathsep + path if path else ""),
        # audit: allow[host-sync] spawn timestamp: the base of each
        # worker's cold-start-to-first-response measure
        _T0_ENV: repr(time.time())})


def _kill_all(procs) -> None:
    """Tear the whole fleet down and reap every process."""
    for q in procs:
        q.kill()
    for q in procs:
        q.communicate()


def run_fleet(args) -> int:
    from . import persist

    ck_dir, kernels_dir, study_dir = _dirs(args.cache_dir)
    compile_cache.configure(kernels_dir)
    if not os.path.exists(os.path.join(ck_dir, persist.MANIFEST)):
        print(f"fleet: no checkpoint under {ck_dir} — building one",
              flush=True)
        with obs.span("coldstart.prepare"):
            _build_registry(args, ck_dir, study_dir)
        print("fleet: registry checkpoint written", flush=True)
    if args.prepare_only:
        return 0

    procs = [subprocess.Popen(_worker_cmd(args, i),
                              env=_worker_env(kernels_dir), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(args.replicas)]
    print(f"fleet: launched {args.replicas} replicas "
          f"(shared cache: {args.cache_dir})", flush=True)

    # audit: allow[host-sync] fleet-wide teardown deadline
    deadline = time.time() + args.timeout
    results = []
    for i, p in enumerate(procs):
        try:
            # audit: allow[host-sync] remaining-budget computation
            out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            _kill_all(procs)
            print(f"fleet: replica {i} exceeded --timeout={args.timeout}s; "
                  "killed all replicas", file=sys.stderr, flush=True)
            return 124
        if p.returncode != 0:
            sys.stderr.write(err)
            print(f"fleet: replica {i} exited {p.returncode}",
                  file=sys.stderr, flush=True)
            _kill_all(procs)
            return p.returncode or 1
        try:
            results.append(json.loads(out.strip().splitlines()[-1]))
        except (IndexError, json.JSONDecodeError):
            sys.stderr.write(err)
            print(f"fleet: replica {i} produced no result line",
                  file=sys.stderr, flush=True)
            _kill_all(procs)
            return 1

    print("\n  replica  first_response_s  restore_s  warmup_s  total_s  "
          "compiles  cache hits/misses")
    for r in results:
        c = r["compile_cache"]
        print(f"  {r['replica']:7d}  {r['first_response_s']:16.3f}  "
              f"{r['restore_s']:9.3f}  {r['warmup_s']:8.3f}  "
              f"{r['total_s']:7.3f}  {r['compile_count']:8d}  "
              f"{c['hits']}/{c['misses']}")

    ref = results[0]
    for r in results[1:]:
        if r["preds"] != ref["preds"] or r["energies"] != ref["energies"]:
            raise ServeError(
                f"replica {r['replica']} disagrees with replica "
                f"{ref['replica']} on the same request set — preds equal: "
                f"{r['preds'] == ref['preds']}, energies equal: "
                f"{r['energies'] == ref['energies']}. The restored registry "
                "broke bit-exactness")
    total_j = sum(ref["energies"])
    print(f"\nfleet: {len(results)} replicas served {ref['n']} requests "
          f"each — preds and per-request energies bit-identical "
          f"(total {total_j * 1e6:.1f} uJ/replica)")
    print(json.dumps({"replicas": results}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="replica fleet over one checkpointed model registry")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--cache-dir", required=True,
                    help="shared artifact dir: registry checkpoint, kernel "
                         "compile cache, study cache")
    ap.add_argument("--quick", action="store_true",
                    help=f"serve a small net ({QUICK_NET}) at the "
                         "dataset's input size")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--buckets", default="1,4")
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--backend", default="queue_pallas")
    ap.add_argument("--trained", action="store_true",
                    help="serve the study-trained net (shares train/convert "
                         "artifacts via the study cache) instead of "
                         "initialized weights")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every process serves: the card (CUDA "
                         "kernels, a CUDA graph per bucket) or, on request, "
                         "the CPU")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="parent-side deadline; a late worker kills the fleet")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="per-replica obs traces (PATH.rN.jsonl)")
    ap.add_argument("--prepare-only", action="store_true",
                    help="build + checkpoint the registry, then exit")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--replica", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker:
        return run_worker(args)
    return run_fleet(args)


if __name__ == "__main__":
    raise SystemExit(main())
