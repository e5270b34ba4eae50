"""Load generator + serving benchmark for the port's serving runtime (port
of ``repro.serve.bench``).

Two arrival disciplines over the same runtime:

- **closed loop** — the whole request set is admitted up front (a saturated
  backlog); measures steady-state throughput and how well the dynamic
  batcher amortizes per-call overhead into large buckets.
- **open loop** — Poisson arrivals at ``--rate`` req/s on a *virtual*
  clock (service times are real measured wall times, arrival gaps are
  simulated), so queueing latency under partial load is measurable without
  sleeping through the experiment.

Every run can verify the serving runtime's energy metering against a
one-shot ``engine.infer_batch`` + ``price_record`` over the same inputs
(``--verify``): per-request energies must equal it element for element.

    PYTHONPATH=src python -m repro_torch.serve.bench --requests 256 \\
        --backend queue_pallas --mode both [--quick] [--verify] \\
        [--device cpu]

By default the served model is an *untrained* paper-spec SNN:
He-initialized weights from seed 0 and unit thresholds (weights do not
change serving cost structure). ``--trained`` serves the study pipeline's
trained and converted SNN instead (``ModelRegistry.register_study``). On
the card every bucket runs as a captured CUDA graph.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from ..core import engine
from ..obs import percentiles
from ..study.artifacts import StatsRecord
from ..study.stages import price_record
from .api import InferResponse
from .batching import DEFAULT_BUCKETS, BucketPolicy
from .registry import ModelRegistry
from .runtime import ServeRuntime

@dataclasses.dataclass
class LoadResult:
    """One load-generator run: throughput, latency percentiles, energy."""

    mode: str                 # 'closed' | 'open'
    n_requests: int
    wall_s: float             # closed: real wall; open: virtual clock span
    throughput_rps: float
    latency_p50_s: float
    latency_p95_s: float
    latency_p99_s: float
    energy_sum_j: float       # float32 pairwise sum over rid order
    bucket_histogram: dict
    responses: list           # InferResponse, rid order


def _finish(mode, responses, wall_s, runtime) -> LoadResult:
    responses = sorted(responses, key=lambda r: r.rid)
    ps = percentiles([r.latency_s for r in responses])
    return LoadResult(
        mode=mode, n_requests=len(responses), wall_s=wall_s,
        throughput_rps=len(responses) / wall_s if wall_s > 0 else float("inf"),
        latency_p50_s=ps[50.0], latency_p95_s=ps[95.0],
        latency_p99_s=ps[99.0],
        energy_sum_j=float(np.sum(energy_array(responses))),
        bucket_histogram=runtime.stats_summary()["bucket_histogram"],
        responses=responses)


def energy_array(responses: list[InferResponse]) -> np.ndarray:
    """Per-request energies as float32 in rid order (the parity layout)."""
    return np.asarray([r.energy_j for r in sorted(responses,
                                                  key=lambda r: r.rid)],
                      np.float32)


def closed_loop(runtime: ServeRuntime, model: str, images) -> LoadResult:
    """Admit everything, drain: saturated-backlog throughput."""
    # audit: allow[host-sync] the load generator IS the measurement: the
    # closed-loop wall spans submit -> drain by definition
    t0 = time.perf_counter()
    for img in images:
        runtime.submit(img, model)
    responses = runtime.run_until_drained()
    # audit: allow[host-sync] closing the measured wall
    return _finish("closed", responses, time.perf_counter() - t0, runtime)


def open_loop(runtime: ServeRuntime, model: str, images, *, rate_rps: float,
              seed: int = 0) -> LoadResult:
    """Poisson arrivals at ``rate_rps`` on a virtual clock.

    Arrival gaps advance simulated time; each batch advances it by the
    batch's *measured* service wall time. Latencies are therefore what a
    wall-clock run would see, without spending idle gaps sleeping.
    """
    n = len(images)
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, n))
    now, i, responses = 0.0, 0, []
    while len(responses) < n:
        if not runtime.pending() and i < n:
            now = max(now, arrivals[i])           # idle: jump to next arrival
        while i < n and arrivals[i] <= now:
            runtime.submit(images[i], model, arrival_s=float(arrivals[i]))
            i += 1
        # audit: allow[host-sync] real service wall advances the virtual
        # clock — the one place simulated and measured time meet
        t0 = time.perf_counter()
        batch = runtime.step(now=now)
        now += time.perf_counter() - t0  # audit: allow[host-sync]
        responses.extend(batch)
    return _finish("open", responses, now, runtime)


# ---------------------------------------------------------------------------
# Model + runtime construction
# ---------------------------------------------------------------------------

def serve_spec(dataset: str = "mnist", *, backend: str = "queue_pallas",
               depth: int = 64, T: int = 4, batch: int = 64,
               mode: str = "mttfs_cont"):
    """The :class:`~repro_torch.study.StudySpec` a bench-served model
    studies as: the dataset's paper net at the reference bench's
    defaults."""
    from ..study import StudySpec

    return StudySpec(dataset=dataset, depth=depth, T=T, batch=batch,
                     mode=mode, backend=backend)


def build_runtime(spec, buckets=DEFAULT_BUCKETS, *, trained: bool = False,
                  cache=None, init_seed: int = 0, warmup: bool = True,
                  device=None) -> tuple[ServeRuntime, str]:
    """Registry + runtime serving ``spec``'s model; returns (runtime, name).

    ``trained=False`` serves freshly initialized weights
    (``snn_model.init_params`` from ``init_seed``) with unit thresholds —
    the serving *cost structure* (shapes, buckets, captured plans) is
    weight-independent; ``trained=True`` trains and converts ``spec``
    through the study stages (``cache``) and serves that net. ``warmup``
    builds every bucket's plan (on the card: captures its graph) first.
    ``device`` is the registry's (``None``: the card).
    """
    import torch

    from ..core import snn_model

    registry = ModelRegistry(device=device)
    name = f"{spec.dataset}-{spec.backend}"
    if trained:
        handle = registry.register_study(name, spec, cache=cache)
    else:
        params = snn_model.init_params(
            torch.Generator().manual_seed(init_seed), spec.net,
            spec.input_hw, spec.input_c, device=registry.device)
        th = [1.0] * len(engine.parse_spec(spec.net))
        handle = registry.register(name, params, th, spec.snn_config(),
                                   backend=spec.backend,
                                   vmem_resident=spec.vmem_resident)
    if warmup:
        handle.warmup(buckets)
    return ServeRuntime(registry, BucketPolicy(buckets)), name


def request_images(dataset: str, n: int, *, seed: int = 123) -> np.ndarray:
    """``n`` procedural request images for ``dataset``."""
    from ..data.synthetic import DATASETS

    return DATASETS[dataset](n, seed=seed)[0]


def one_shot_energy(runtime: ServeRuntime, model: str, images) -> np.ndarray:
    """Per-sample energies from one ``engine.infer_batch`` over ``images``
    on the served artifacts (same params, thresholds, config and backend),
    priced at once with ``price_record``: what the per-request meters must
    equal element for element."""
    handle = runtime.registry.get(model)
    _, stats = engine.infer_batch(handle.params, handle.thresholds,
                                  handle.cfg, images, backend=handle.backend,
                                  device=handle.device)
    # audit: allow[host-sync] the verification's one-shot stats go to the
    # host pricing, once per check
    record = StatsRecord(*(getattr(stats, f).cpu().numpy()
                           for f in StatsRecord._fields))
    e = price_record(record, input_hw=handle.cfg.input_hw,
                     compressed=handle.cfg.compressed,
                     vmem_resident=handle.vmem_resident)
    return np.asarray(e.total_j, np.float32)


def verify_energy_parity(runtime: ServeRuntime, model: str, images,
                         responses) -> dict:
    """Served-vs-one-shot energy check; exact element and sum equality."""
    served = energy_array(responses)
    ref = one_shot_energy(runtime, model, images)
    return {
        "elementwise_bitexact": bool(np.array_equal(served, ref)),
        "sum_bitexact": bool(np.float32(np.sum(served))
                             == np.float32(np.sum(ref))),
        "served_sum_j": float(np.sum(served)),
        "one_shot_sum_j": float(np.sum(ref)),
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _print_result(tag: str, r: LoadResult) -> None:
    print(f"  [{tag:>12s}] {r.n_requests} reqs in {r.wall_s:.3f}s -> "
          f"{r.throughput_rps:8.1f} req/s | latency p50/p95/p99 = "
          f"{r.latency_p50_s * 1e3:.1f}/{r.latency_p95_s * 1e3:.1f}/"
          f"{r.latency_p99_s * 1e3:.1f} ms | energy "
          f"{r.energy_sum_j * 1e6:.2f} uJ | buckets {r.bucket_histogram}")


def _check_parity(runtime, name, images, responses) -> None:
    parity = verify_energy_parity(runtime, name, images, responses)
    print(f"  energy parity vs one-shot infer_batch+price: {parity}")
    if not (parity["elementwise_bitexact"] and parity["sum_bitexact"]):
        raise SystemExit("FAIL: serving energy meters diverged from one-shot "
                         f"infer_batch+price: {parity}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--dataset", default="mnist",
                    choices=("mnist", "svhn", "cifar10"))
    ap.add_argument("--backend", default="queue_pallas",
                    choices=engine.available_backends())
    ap.add_argument("--buckets", default="1,4,16,64",
                    help="comma-separated bucket ladder")
    ap.add_argument("--mode", default="both",
                    choices=("closed", "open", "both"))
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop arrival rate, req/s (0 = a quarter of "
                         "the measured closed-loop throughput; note open-"
                         "loop capacity is below the saturated closed-loop "
                         "number because partial load forms smaller buckets)")
    ap.add_argument("--depth", type=int, default=64)
    ap.add_argument("--T", type=int, default=4)
    ap.add_argument("--trained", action="store_true",
                    help="serve the study pipeline's trained+converted SNN "
                         "(slower; default serves untrained weights)")
    ap.add_argument("--verify", action="store_true",
                    help="check per-request energies bit-exactly against "
                         "a one-shot infer_batch+price over the same inputs")
    ap.add_argument("--quick", action="store_true",
                    help="32 requests (CI smoke)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to serve: the card (CUDA kernels, a CUDA "
                         "graph per bucket) or, on request, the CPU (the "
                         "kernels' plain versions, eager plans)")
    args = ap.parse_args(argv)

    n = 32 if args.quick else args.requests
    buckets = tuple(int(b) for b in args.buckets.split(","))
    spec = serve_spec(args.dataset, backend=args.backend, depth=args.depth,
                      T=args.T)
    images = request_images(args.dataset, n)
    # one study cache for the CLI's runtimes: --trained trains once
    from ..study import StudyCache

    cache = StudyCache()

    def runtime_for(ladder):
        return build_runtime(spec, ladder, trained=args.trained, cache=cache,
                             device=args.device)

    runtime, name = runtime_for(buckets)
    where = runtime.registry.get(name).device
    print(f"serving {args.dataset} ({spec.net}) on backend={args.backend}, "
          f"buckets={buckets}, {n} requests, device={where}"
          f"{', trained' if args.trained else ''}")

    closed = None
    if args.mode in ("closed", "both"):
        closed = closed_loop(runtime, name, images)
        _print_result("closed", closed)
        if args.verify:
            _check_parity(runtime, name, images, closed.responses)

        # the per-request baseline: same runtime machinery, bucket ladder (1,)
        b1 = closed_loop(runtime_for((1,))[0], name, images)
        _print_result("closed B=1", b1)
        print(f"  bucketing speedup: "
              f"{b1.wall_s / closed.wall_s:.2f}x throughput")

    if args.mode in ("open", "both"):
        rate = args.rate
        if rate <= 0:
            rate = (closed.throughput_rps / 4 if closed is not None else 50.0)
        rt_open = runtime_for(buckets)[0]
        opened = open_loop(rt_open, name, images, rate_rps=rate)
        _print_result(f"open @{rate:.0f}/s", opened)
        if args.verify and args.mode == "open":
            # closed mode already verified above; open-only runs check the
            # open-loop responses so --verify is never silently ignored
            _check_parity(rt_open, name, images, opened.responses)


if __name__ == "__main__":
    main()
