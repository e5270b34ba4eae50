"""One run of one cell: set-up, the measured window, an optional traced
stretch, the comparison with the reference, and the result line.

The order is fixed by what each step may disturb. Set-up (the program's
imports, kernel libraries from the compile cache, weights and the request
pool from the seed, graph capture and a few warm steps of the cell's
buckets) ends where the window starts; nothing is built inside it. With
``--trace 1`` the window is followed by a stretch of the same traffic
under ``torch.profiler`` alone (the program's own tracing stays off: its
event a response would lengthen the very host phases the stretch names),
so the window itself is never profiled. The peak device memory is read before the
program's state is freed; only then does the reference run, on the card,
in blocks, over the pool's images.
"""
from __future__ import annotations

import collections
import gc
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..reference import snn
from . import judge, manifest, profile, serve, traffic, weights

TRACE_SECONDS = 3.0          # the traced stretch after the window
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that no run may load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class GcWatch:
    """Pauses of the interpreter's garbage collector, by generation."""

    def __init__(self):
        self.t, self.pauses = 0.0, collections.defaultdict(list)

    def __call__(self, phase, info):
        if phase == "start":
            self.t = time.perf_counter()
        else:
            self.pauses[info["generation"]].append(time.perf_counter() - self.t)

    def summary(self) -> str:
        return ", ".join(f"gen{g} {len(v)}x {sum(v) * 1e3:.1f} ms "
                         f"(max {max(v) * 1e3:.2f})"
                         for g, v in sorted(self.pauses.items()))


def _device_info(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}


def setup(cell: str, seed: int, *, t_start: float, device: str = "cuda",
          root=manifest.ROOT, w: dict | None = None) -> SimpleNamespace:
    """Everything before the window: the cell's files, the weights and the
    request pool from the seed, the runtime with its buckets captured and
    warmed. ``setup_s`` runs from ``t_start`` to the end of it. ``w``, a
    workload entry, stands in for a cell the manifest does not list."""
    man = manifest.load(root)
    w = w or manifest.workload(man, cell)
    cfg = manifest.config(man, w["config"], root)
    mix = manifest.traffic(w["traffic"], root)
    chips = w["chips"]
    drive = serve.driver(w["traffic"], mix, root)
    dev = torch.device(device)
    net = cfg["net"]
    buckets = tuple(cfg["serve"]["buckets"])
    phases, t = {"start": time.perf_counter() - t_start}, time.perf_counter()

    def lap(name):
        nonlocal t
        now = time.perf_counter()
        phases[name], t = now - t, now

    params, ths = weights.make(net, seed, dev)
    ref_params, ref_ths = weights.copy(params, ths)
    lap("weights")
    pool = traffic.pool(cfg["dataset"], mix["pool"], seed)
    draws = traffic.Draws(seed, mix["pool"])
    lap("pool")
    rt, model, handle = serve.build(cfg, params, ths, chips=chips, device=dev)
    del params, ths
    lap("build")
    # a mix warms the largest bucket alone where it serves no other
    warm = buckets[-1:] if mix.get("warm") == "largest" else buckets
    handle.warmup(warm)
    lap("capture")
    client = serve.Client(rt, model, pool)
    client.warm(warm, draws)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    lap("warm_steps")
    return SimpleNamespace(
        man=man, w=w, cfg=cfg, mix=mix, drive=drive, chips=chips, dev=dev,
        net=net, pool=pool, draws=draws, rt=rt, client=client,
        ref=(ref_params, ref_ths), n_warm=len(client.pool_of_rid),
        setup_s=time.perf_counter() - t_start, setup_phases=phases)


def run(cell: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", root=manifest.ROOT, log=print) -> dict:
    """Run ``cell`` once; returns the result line's object. ``device`` is
    the card unless a test drives the harness on the CPU."""
    s = setup(cell, seed, t_start=t_start, device=device, root=root)
    man, w, cfg, mix, chips, net = s.man, s.w, s.cfg, s.mix, s.chips, s.net
    dev, rt, client, draws, pool = s.dev, s.rt, s.client, s.draws, s.pool
    n_warm, setup_s, ref_weights = s.n_warm, s.setup_s, s.ref
    s_phases = s.setup_phases
    window = serve.Log()
    summary0 = rt.stats_summary()
    watch = GcWatch()
    gc.callbacks.append(watch)

    # -- the window ---------------------------------------------------------
    d = s.drive(client, draws, window, mix=mix, seed=seed, start_s=0.0,
                seconds=seconds)
    t0, t1 = d["t0"], d["t1"]
    summary1 = rt.stats_summary()
    gc.callbacks.remove(watch)

    # -- the traced stretch -------------------------------------------------
    traced = None
    if trace:
        gc.collect()
        traced = serve.Log()
        prof = profile.start()
        dt = s.drive(client, draws, traced, mix=mix, seed=seed,
                     start_s=seconds, seconds=TRACE_SECONDS)
        trace_red = profile.reduce(prof, traced, dt["t0"], dt["t1"],
                                   chips if dev.type == "cuda" else 0)
        log(f"[bench] traced stretch: {_rate(traced, dt['t0'], dt['t1']):.1f}"
            f" req/s over {dt['t1'] - dt['t0']:.3f} s, against "
            f"{_rate(window, t0, t1):.1f} in the window", file=sys.stderr)

    device_info = _device_info(dev, chips)
    n_taken = len(client.pool_of_rid) - n_warm - rt.pending()
    pool_of_rid = np.asarray(client.pool_of_rid, np.int64)
    served = window.arrays()
    if traced is not None:
        more = traced.arrays()
        served = {k: (np.concatenate([v, more[k]]) if v is not None
                      else None) for k, v in served.items()}
    del rt, client, s
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference and the comparison -----------------------------------
    t_ref = time.perf_counter()
    used = np.unique(pool_of_rid[n_warm:])
    ref_params, ref_ths = ref_weights
    ref_out = snn.run_blocks(ref_params, ref_ths, net, pool[used],
                             block=cfg["reference_block"])
    ref = judge.reference_answers(ref_out, net, used, len(pool))
    checks = judge.compare(served, pool_of_rid, n_taken, ref, cfg["limits"])
    log(f"[bench] reference over the {len(used)} pool images served in "
        f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)

    # -- metrics ------------------------------------------------------------
    steps = window.step_array()
    n_done = int(steps["n"].sum()) if len(window.steps) else 0
    # what a metric's reader may read: the window's [t0, t1], its steps
    # (serve.STEP_FIELDS), its requests (rids, and latencies of an open
    # loop), the runtime's counters before and after it, the reference's
    # answers by pool image, the net's stages, and with --trace 1 the
    # traced stretch's reduction and its steps
    ctx = SimpleNamespace(
        cell=w, cfg=cfg, mix=mix, chips=chips, setup_s=setup_s, t0=t0, t1=t1, steps=steps, n_done=n_done,
        window_rids=(np.concatenate(window.rids) if window.rids
                     else np.zeros(0, np.int64)),
        latency_s=(np.concatenate(window.latency) if window.latency
                   else np.zeros(0)),
        summary=(summary0, summary1), pool_of_rid=pool_of_rid,
        ref=ref, stages=snn.plan(net["spec"], net["input_hw"],
                                 net["input_c"])[0],
        trace=trace_red if trace else None,
        traced_steps=traced.step_array() if traced else None,
        traced_rids=traced.rids if traced else None)
    wanted = (manifest.per_layer(man, cell) if trace
              else manifest.end_to_end(man, cell))
    metrics = {}
    for m in wanted:
        v = manifest.reader(m["name"], root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        elif not m["name"].endswith("_roofline"):
            # only a kernel's roofline may fall silent, where the kernel
            # has left the path; any other metric of the cell must read
            raise RuntimeError(f"metric {m['name']!r} of {cell} read "
                               f"nothing")
    late = d.get("late")
    if late is not None:
        log(f"[bench] open loop: {d['due']} requests due in {seconds:g} s; "
            f"generator lateness after a sleep p50/p99 "
            f"{_pct(late['late_idle_s'], 50):.1f}/"
            f"{_pct(late['late_idle_s'], 99):.1f} us over "
            f"{len(late['late_idle_s'])} admissions; every admission "
            f"p99 {_pct(late['late_all_s'], 99):.1f} us", file=sys.stderr)
    hist = {k: v - summary0["bucket_histogram"].get(k, 0)
            for k, v in summary1["bucket_histogram"].items()}
    log(f"[bench] {cell} seed {seed}: {n_done} requests in "
        f"{t1 - t0:.3f} s, {len(window.steps)} steps, buckets {hist}, "
        f"set-up {setup_s:.2f} s ("
        + ", ".join(f"{k} {v:.2f}" for k, v in s_phases.items()) + ")",
        file=sys.stderr)
    svc = steps["step_total_s"] if len(window.steps) else np.zeros(1)
    log(f"[bench] window: garbage collector {watch.summary() or 'idle'}; "
        f"step ms p50 {np.median(svc) * 1e3:.3f} max {svc.max() * 1e3:.3f}, "
        f"{int((svc > 2 * np.median(svc)).sum())} steps over twice the "
        f"median", file=sys.stderr)

    result = {"correct": judge.passed(checks), "attempted": n_taken,
              "failed": int(checks["missing"][0]), "metrics": metrics,
              "device": device_info}
    if trace:
        result["device"]["busy_s"] = trace_red["busy_s"]
        result["device"]["window_s"] = trace_red["window_s"]
        result["breakdown"] = {"device_ops": trace_red["device_ops"],
                               "idle_gaps": trace_red["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"[check] {k} {v!r} limit {lim!r} "
            f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    return result


def _rate(log, t0, t1):
    return sum(st[1] for st in log.steps) / max(t1 - t0, 1e-9)


def _pct(a, q):
    return float(np.percentile(a, q) * 1e6) if len(a) else float("nan")
