"""Multi-model registry: named serving handles + a plan per bucket (port of
``repro.serve.registry``, without the mesh; persistence is
``serve/persist.py``).

A :class:`ModelHandle` owns one servable SNN — params and thresholds on its
device, the engine config, a backend name, and the pricing options its
responses are metered under. Per padded bucket size it holds a *plan* in an
LRU-bounded cache, as the reference holds one AOT-compiled executable per
bucket:

- on the card a plan is a :class:`GraphPlan`, one CUDA graph captured from
  the engine's batched call (``engine.batch_runner``) over a static input
  buffer, the handle's params and thresholds (static on the device) and
  static outputs. Serving a bucket copies its images in, replays the graph
  (the plan's few hundred kernels in one launch from the host) and copies
  the valid prefix out;
- on the CPU (``device="cpu"``) a plan is the eager bucket-shaped call,
  which fills the same cache and ``compile_count``.

The :class:`ModelRegistry` LRU-bounds the handles themselves.

Tracing (``repro_torch.obs``) uses the reference's names: ``serve.plan_hit``
/ ``serve.plan_compile`` per plan lookup, a ``serve.aot_compile`` span
around building a plan (on the card: the eager run and the capture; every
obs call stays outside the captured region), ``serve.plan_adopt``,
``serve.plan_evict`` events with ``serve.plan_evictions``, and
``serve.model_evict`` / ``serve.model_evictions``.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from .. import obs
from ..core import engine
from ..device import resolve_device
from ..kernels import ops
from .api import ServeError
from .batching import DEFAULT_BUCKETS


def _slice_copies(logits, stats, n_valid: int):
    """The valid prefix as tensors of its own (a later replay overwrites
    the static outputs)."""
    logits, stats = engine.slice_valid(logits, stats, n_valid)
    return logits.clone(), engine.SNNStats(*(a.clone() for a in stats))


class EagerPlan:
    """A bucket's plan on the CPU: the engine's batched call, run eagerly."""

    def __init__(self, runner, params, thresholds):
        self.runner, self.params, self.thresholds = runner, params, thresholds

    def __call__(self, images, n_valid: int):
        logits, stats = self.runner(self.params, self.thresholds,
                                    torch.from_numpy(images))
        return engine.slice_valid(logits, stats, n_valid)


class GraphPlan:
    """A bucket's plan on the card: one captured CUDA graph.

    The engine's batched call runs once eagerly on a side stream first (it
    builds the kernels, sets their shared-memory opt-ins and lets cuDNN pick
    its algorithms), then once under capture into ``pool``. ``launches``
    holds the kernel launches the capture recorded (``ops.launch_counts``
    moved by the wrappers during capture): every replay runs exactly these.
    A capture that fails raises; nothing falls back to eager execution.
    """

    def __init__(self, runner, params, thresholds, shape, device, pool):
        self.images = torch.zeros(shape, dtype=torch.float32, device=device)
        self.staging = torch.empty(shape, dtype=torch.float32,
                                   pin_memory=True)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            runner(params, thresholds, self.images)
        torch.cuda.current_stream(device).wait_stream(side)
        before = dict(ops.launch_counts)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.logits, self.stats = runner(params, thresholds, self.images)
        self.launches = {k: ops.launch_counts[k] - before[k] for k in before}

    def __call__(self, images, n_valid: int):
        # host images go to the static input through pinned memory
        np.copyto(self.staging.numpy(), images)
        self.images.copy_(self.staging, non_blocking=True)
        self.graph.replay()
        return _slice_copies(self.logits, self.stats, n_valid)


class ModelHandle:
    """One servable model: artifacts on its device + per-bucket plans."""

    def __init__(self, name: str, params, thresholds, cfg, *,
                 backend: str = "queue_pallas", vmem_resident: bool = True,
                 plan_cache_size: int = 8, device=None):
        b = engine.get_backend(backend)      # fail fast on unknown names
        if getattr(b, "host_dispatch", False):
            raise ValueError(
                f"backend {backend!r} dispatches on host-side occupancy "
                "totals, so its plan cannot be captured per bucket; serve "
                "with 'queue_pallas' (same semantics, static plan)")
        if plan_cache_size < 1:
            raise ValueError(                # 0 would recapture every batch
                f"plan_cache_size must be >= 1, got {plan_cache_size}")
        self.device = resolve_device(device)
        refusal = getattr(b, "capture_refusal", None)
        if self.device.type == "cuda" and refusal is not None:
            raise ValueError(
                f"backend {backend!r} cannot be captured in a CUDA graph: "
                f"{refusal}; serve with 'queue_pallas'")
        self.name = name
        # the study stage key the artifacts came from (register_study)
        self.source_key: str | None = None
        self.params, self.thresholds = engine.to_device(params, thresholds,
                                                        self.device)
        self.cfg = cfg
        self.backend = backend
        self.vmem_resident = vmem_resident
        self.plan_cache_size = plan_cache_size
        self._runner = engine.batch_runner(cfg, backend)
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        # bucket B -> plan, insertion-ordered for LRU
        self._plans: collections.OrderedDict = collections.OrderedDict()
        # plans built (cache misses in plan_for): the observable the warmup
        # recompilation guard asserts stays flat
        self.compile_count = 0
        # per bucket: the kernel launches its graph records (captures of
        # this handle), and how often a plan of it has run
        self.plan_launches: dict[int, dict] = {}
        self.replay_count: collections.Counter = collections.Counter()

    def _shape(self, bucket: int) -> tuple:
        cfg = self.cfg
        return (bucket, cfg.input_hw, cfg.input_hw, cfg.input_c)

    def _evict(self) -> None:
        while len(self._plans) > self.plan_cache_size:
            evicted, _ = self._plans.popitem(last=False)
            obs.event("serve.plan_evict", model=self.name, bucket=evicted)
            obs.counter("serve.plan_evictions")

    def build_plan(self, bucket: int):
        """A new plan for this bucket size, not installed: on the card a
        CUDA graph captured at the exact (config, backend, B) shape (its
        launches recorded in ``plan_launches``), on the CPU the eager
        call."""
        if self.device.type == "cuda":
            plan = GraphPlan(self._runner, self.params, self.thresholds,
                             self._shape(bucket), self.device, self._pool)
            self.plan_launches[bucket] = plan.launches
            return plan
        return EagerPlan(self._runner, self.params, self.thresholds)

    def plan_for(self, bucket: int):
        """The plan for this bucket size (LRU-cached, see
        :meth:`build_plan`). A cache hit is a dict lookup; eviction drops
        the least recently used plan (and frees its graph)."""
        if bucket in self._plans:
            self._plans.move_to_end(bucket)
            obs.counter("serve.plan_hit")
            return self._plans[bucket]
        obs.counter("serve.plan_compile")
        with obs.span("serve.aot_compile", model=self.name,
                      backend=self.backend, bucket=bucket):
            plan = self.build_plan(bucket)
        self.compile_count += 1
        self._plans[bucket] = plan
        self._evict()
        return plan

    def cached_buckets(self) -> tuple:
        return tuple(self._plans)

    def adopt_plan(self, bucket: int, plan) -> None:
        """Install a ready plan for ``bucket`` — ``plan(images, n_valid) ->
        (logits, stats)`` of the valid prefix, for a (B, H, W, C) float32
        numpy bucket, as :class:`GraphPlan` and :class:`EagerPlan` are. It
        enters the same LRU but does **not** bump ``compile_count``: an
        adopted plan is a cache hit by construction, so the warmup guard
        keeps working (``serve/persist.py`` restores a checkpoint's plans
        through here)."""
        self._plans.pop(bucket, None)
        self._plans[bucket] = plan
        obs.counter("serve.plan_adopt")
        self._evict()

    def run_bucket(self, images, n_valid: int):
        """Execute one padded (B, H, W, C) bucket of host images; return the
        valid prefix (see the engine's mask contract) as tensors that no
        later bucket overwrites.

        Synchronizes the device before returning, so the caller's clock
        read after it covers the bucket's execution.
        """
        images = np.ascontiguousarray(images, np.float32)
        bucket = images.shape[0]
        out = self.plan_for(bucket)(images, n_valid)
        self.replay_count[bucket] += 1
        if self.device.type == "cuda":
            # audit: allow[host-sync] serve latency metering: the response
            # timestamp must not be taken before the device is done
            torch.cuda.synchronize(self.device)
        return out

    def warmup(self, buckets=DEFAULT_BUCKETS) -> None:
        """Build (and once-execute) each bucket's plan before the first
        request: on the card this captures the graphs.

        **Recompilation guard**: after the first pass built every bucket's
        plan, a second pass over the same bucket sizes must be all cache
        hits — ``compile_count`` flat — or a plan is not keyed on the bucket
        size alone and live traffic would recapture.
        """
        def one_pass():
            for b in buckets:
                self.run_bucket(np.zeros(self._shape(b), np.float32), b)

        one_pass()
        if len(set(buckets)) > self.plan_cache_size:
            return  # LRU eviction makes second-pass rebuilds legitimate
        compiled = self.compile_count
        one_pass()
        if self.compile_count != compiled:
            raise ServeError(
                f"model {self.name!r}: warmup second pass recompiled "
                f"({compiled} -> {self.compile_count} compilations for "
                f"buckets {tuple(buckets)}) — the plan cache is not keying "
                "on bucket size alone")


class ModelRegistry:
    """Name -> :class:`ModelHandle`, LRU-bounded to ``capacity`` models."""

    def __init__(self, capacity: int = 4, plan_cache_size: int = 8, *,
                 device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if plan_cache_size < 1:
            raise ValueError(
                f"plan_cache_size must be >= 1, got {plan_cache_size}")
        self.capacity = capacity
        self.plan_cache_size = plan_cache_size
        self.device = resolve_device(device)
        self._models: collections.OrderedDict = collections.OrderedDict()

    def register(self, name: str, params, thresholds, cfg, *,
                 backend: str = "queue_pallas",
                 vmem_resident: bool = True) -> ModelHandle:
        """Register artifacts under ``name`` (replaces any old one)."""
        handle = ModelHandle(name, params, thresholds, cfg, backend=backend,
                             vmem_resident=vmem_resident,
                             plan_cache_size=self.plan_cache_size,
                             device=self.device)
        self._models.pop(name, None)
        self._models[name] = handle
        while len(self._models) > self.capacity:
            evicted, _ = self._models.popitem(last=False)
            obs.event("serve.model_evict", model=evicted)
            obs.counter("serve.model_evictions")
        return handle

    def register_study(self, name: str, spec, *, cache=None,
                       vmem_resident: bool | None = None) -> ModelHandle:
        """Train + convert ``spec`` through the study stages on the
        registry's device, then register the converted net.

        The served model is what ``study.collect`` executes for the same
        spec (same converted params, thresholds, config and backend), so
        serving-side energy metering and a study over the same inputs price
        the same stats. ``handle.source_key`` is the convert stage's key.
        """
        from ..study import stages

        trained = stages.train(spec, cache=cache, device=self.device)
        converted = stages.convert(spec, trained, cache=cache,
                                   device=self.device)
        handle = self.register(
            name, converted.snn_params, converted.thresholds,
            spec.snn_config(), backend=spec.backend,
            vmem_resident=(spec.vmem_resident if vmem_resident is None
                           else vmem_resident))
        handle.source_key = converted.key
        return handle

    def get(self, name: str) -> ModelHandle:
        try:
            handle = self._models[name]
        except KeyError:
            raise ServeError(
                f"unknown model {name!r}; registered models: "
                f"{sorted(self._models)}") from None
        self._models.move_to_end(name)
        return handle

    def names(self) -> tuple:
        return tuple(self._models)

    def __contains__(self, name: str) -> bool:
        return name in self._models

    def __len__(self) -> int:
        return len(self._models)
