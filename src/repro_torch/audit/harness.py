"""Recompilation harness: prove the caches stay flat on repeat shapes
(port of ``repro.audit.harness``).

PyTorch runs eagerly, so the port's caches are the engine's first-call
tracking (``engine.jit_miss``, one per new (config, backend, batch) key:
where the reference compiles, the kernels load and cuDNN picks its
algorithms), ``compile_plan``'s plan cache, ``queue_sparse``'s gate keys
(``SparseQueueBackend.gate_keys``, the counterpart of the reference's
per-bucket jit caches) and, on the card, the serving registry's CUDA
graphs. This harness executes every backend twice over the same tiny shape
set and asserts none grows on the second pass. It is the one place the
audit runs code for its own sake — everything else records or parses.

On the card, :func:`check_graph_capture` also holds the serving layer: for
each backend that serves through ``GraphPlan``, a second
``ModelHandle.warmup`` pass leaves ``compile_count`` flat, and each plan's
captured launches equal the kernel launches of one eager
``engine.batch_runner`` call at the same bucket.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import obs
from ..core import engine
from ..device import resolve_device
from ..kernels import _cuda
from . import probe
from .findings import Finding

#: Two shapes per backend: enough to prove per-shape specialization works
#: AND that repeating a shape never re-specializes.
_HARNESS_BATCHES = (2, 4)
_ENGINE = "src/repro_torch/core/engine.py"
_REGISTRY = "src/repro_torch/serve/registry.py"


@contextlib.contextmanager
def _counting():
    """Tracing on for the block, into buffers of its own: ``read()`` gives
    the block's ``engine.jit_miss`` count. The process's tracing state (on
    or off, its spans and metrics) is put back as it was."""
    saved = obs.enabled(), obs._tracer, obs._metrics
    obs._tracer, obs._metrics = obs.Tracer(), obs.Metrics()
    obs.enable()
    try:
        yield lambda: obs._metrics.counter_value("engine.jit_miss")
    finally:
        was, obs._tracer, obs._metrics = saved
        if not was:
            obs.disable()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_recompilation(root: str, device=None) -> list[Finding]:
    """``recompile``: first-call tracking and the plan cache flat across a
    second pass (queue_sparse: its gate keys)."""
    device = resolve_device(device)
    cfg = probe.probe_config()
    plan = probe._plan(cfg)
    params = probe.probe_params(plan, device)
    thresholds = probe.probe_thresholds(plan, device)
    out = []

    for name in engine.available_backends():
        backend = engine.get_backend(name)

        def pass_once():
            for B in _HARNESS_BATCHES:
                engine.infer_batch(params, thresholds, cfg,
                                   probe.probe_images(cfg, B, device),
                                   backend=name, device=device)
            _sync(device)

        if getattr(backend, "host_dispatch", False):
            out += _check_host_dispatch(name, backend, pass_once)
            continue
        with _counting() as misses:
            pass_once()
            first = (misses(), engine.compile_plan.cache_info().currsize)
            pass_once()
            second = (misses(), engine.compile_plan.cache_info().currsize)
        if second[0] > first[0]:
            out.append(Finding(
                "recompile", "error", _ENGINE, 0,
                f"backend {name!r}: engine.jit_miss grew {first[0]} -> "
                f"{second[0]} on a second pass over the same batch shapes "
                f"{_HARNESS_BATCHES} — a call is not keyed on (config, "
                "backend, batch) alone"))
        if second[1] > first[1]:
            out.append(Finding(
                "recompile", "error", _ENGINE, 0,
                f"backend {name!r}: compile_plan's cache grew {first[1]} -> "
                f"{second[1]} on a second pass over the same batch shapes "
                f"{_HARNESS_BATCHES} — the plan is not keyed on the spec "
                "alone"))
    return out


def _check_host_dispatch(name, backend, pass_once) -> list[Finding]:
    """Same flatness for the sparse backend's gate keys."""
    pass_once()
    first = len(backend.gate_keys)
    pass_once()
    now = len(backend.gate_keys)
    if now > first:
        return [Finding(
            "recompile", "error", _ENGINE, 0,
            f"backend {name!r}: the gate's (e_cap, n_rows) keys grew "
            f"{first} -> {now} on identical inputs — the occupancy gate is "
            "producing unstable bucket keys")]
    return []


def second_pass_flat(runner, params, thresholds, images,
                     misses=lambda: 0) -> bool:
    """Test hook: True iff repeating ``images`` adds nothing to the
    engine's first-call tracking (``misses()``, e.g. a runner's own
    count) or to ``compile_plan``'s cache."""
    runner(params, thresholds, images)
    before = (misses(), engine.compile_plan.cache_info().currsize)
    runner(params, thresholds, images)
    return (misses(), engine.compile_plan.cache_info().currsize) == before


def check_graph_capture(root: str, device="cuda",
                        buckets=_HARNESS_BATCHES, rows=None) -> list[Finding]:
    """``graph-capture`` (the card): for each backend that serves through
    ``GraphPlan`` (neither host-dispatched nor refusing capture), at the
    probe net with TTFS input (so its
    first stage is event-driven and the kernels launch), and for
    ``queue_pallas`` with int8 weights too, a second ``warmup`` pass leaves
    ``compile_count`` flat, and each bucket's captured launches equal one
    eager ``batch_runner`` call's. ``rows`` (a list) receives one dict per
    (backend, bucket)."""
    from ..serve.api import ServeError
    from ..serve.registry import ModelRegistry

    device = resolve_device(device)
    base = probe.probe_config(input_mode="binary")
    cases = [(n, base) for n in engine.available_backends()
             if not getattr(engine.get_backend(n), "host_dispatch", False)
             and getattr(engine.get_backend(n), "capture_refusal",
                         None) is None]
    cases.append(("queue_pallas", base._replace(weight_bits=8)))
    out = []
    for name, cfg in cases:
        tag = name + ("[w8]" if cfg.weight_bits else "")
        plan = probe._plan(cfg)
        params = probe.probe_params(plan, device)
        thresholds = probe.probe_thresholds(plan, device)
        registry = ModelRegistry(device=device)
        handle = registry.register(tag, params, thresholds, cfg,
                                   backend=name)
        try:
            handle.warmup(buckets)
            compiled = handle.compile_count
            handle.warmup(buckets)
        except ServeError as e:
            out.append(Finding("graph-capture", "error", _REGISTRY, 0,
                               f"backend {tag!r}: {e}"))
            continue
        if handle.compile_count != compiled:
            out.append(Finding(
                "graph-capture", "error", _REGISTRY, 0,
                f"backend {tag!r}: a second warmup pass over buckets "
                f"{tuple(buckets)} recaptured ({compiled} -> "
                f"{handle.compile_count} plans built)"))
        runner = engine.batch_runner(cfg, name)
        for b in buckets:
            before = dict(_cuda.launch_counts)
            runner(handle.params, handle.thresholds,
                   torch.from_numpy(np.zeros(handle._shape(b), np.float32))
                   .to(device))
            _sync(device)
            eager = {k: _cuda.launch_counts[k] - before[k] for k in before}
            captured = handle.plan_launches[b]
            if rows is not None:
                rows.append(dict(backend=tag, bucket=b,
                                 compile_count=handle.compile_count,
                                 captured=captured, eager=eager))
            if captured != eager:
                out.append(Finding(
                    "graph-capture", "error", _REGISTRY, 0,
                    f"backend {tag!r} bucket {b}: the captured graph holds "
                    f"launches {captured}, one eager call makes {eager}"))
    return out
