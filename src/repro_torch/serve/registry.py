"""Multi-model registry: named serving handles + a plan per bucket (port of
``repro.serve.registry``; persistence is ``serve/persist.py``).

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
  which fills the same cache and ``compile_count``;
- with a data mesh set (``mesh=``, :meth:`ModelHandle.set_mesh`), a bucket
  that divides the mesh size gets a :class:`ShardedPlan`: one plan per
  shard (a graph captured on the shard's device, from the params' copy
  there, in that device's pool), run in turn, the outputs gathered to the
  first device. Its responses are bit-equal to the unsharded plan's; it
  counts one ``compile_count`` for the bucket.

The :class:`ModelRegistry` LRU-bounds the handles themselves.

A plan on the card launches without waiting: :meth:`ModelHandle.launch_bucket`
copies a bucket in, replays its graph and enqueues the device-to-host
copies of the valid prefix into pinned host buffers, and returns a
:class:`Flight`; :meth:`ModelHandle.finish_bucket` waits on that bucket's
own completion event (never the whole device, which may already run the
next bucket) and gives the prefix in those buffers. Each plan keeps two
slots, used in turn, of the pinned staging input, the pinned outputs and a
pair of CUDA timing events, all allocated once, so a bucket can be
launched while the one before it is still on the card.
:meth:`ModelHandle.run_bucket` is the two in one call, for callers that
want the answer at once (warm-up, tests).

Both take the runtime's step (an ``obs.Split``) and cut the work into
three phases on the runtime's clock: ``copy_in`` and ``launch`` at the
launch, ``sync_wait`` at the finish, each plan's replay a ``shard`` region
with its ``card``. When the launch was split, the finish adds each card's
time between the bucket's two timing events to the step's device seconds.
No event is allocated a step, and the one host sync is the declared one
(``docs/OBSERVABILITY_TORCH.md``).

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
from ..audit.contracts import BackendContract
from ..core import engine
from ..device import resolve_device
from ..kernels import ops
from ..parallel import mesh_size
from ..parallel.executor import gather, on_device, replicate
from .api import ServeError
from .batching import DEFAULT_BUCKETS


# Declared trace intent of the serving layer, verified by ``python -m
# repro_torch.audit``: the served plans are the engine's batched calls
# (zero cross-batch reductions — the mask contract is what makes padded
# buckets safe; on the card the audit's harness holds each captured
# graph's launches to the eager call's), and the one deliberate host sync
# is the per-bucket block-until-ready in ``Flight.wait`` (latency metering
# needs the bucket done before the response timestamp).
CONTRACT = BackendContract(name="serve",
                           allowed_host_syncs=("serve-block-until-ready",))


class _HostOut:
    """Pinned host buffers for a bucket's logits and five stats fields,
    the shapes of the device outputs they receive."""

    def __init__(self, logits, stats, rows: int):
        def like(t):
            return torch.empty((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                               pin_memory=True)
        self.logits = like(logits)
        self.stats = engine.SNNStats(*(like(a) for a in stats))

    def pull(self, logits, stats, n_valid: int) -> None:
        """Enqueue the copies of the valid prefix on the current stream."""
        self.logits[:n_valid].copy_(logits[:n_valid], non_blocking=True)
        for dst, src in zip(self.stats, stats):
            dst[:n_valid].copy_(src[:n_valid], non_blocking=True)

    def view(self, n_valid: int):
        return self.logits[:n_valid], engine.SNNStats(
            *(a[:n_valid] for a in self.stats))


class _Slot:
    """One of a :class:`GraphPlan`'s two turns: the pinned staging of its
    input, the pinned host copies of its outputs, and the timing events of
    its replay (``ev_end`` also marks the replay's work on the card done)."""

    def __init__(self, shape, logits, stats):
        self.staging = torch.empty(shape, dtype=torch.float32,
                                   pin_memory=True)
        self.out = _HostOut(logits, stats, shape[0])
        self.ev_start = torch.cuda.Event(enable_timing=True)
        self.ev_end = torch.cuda.Event(enable_timing=True)


class Flight:
    """A bucket launched on the card and not yet answered.

    ``done`` is the event recorded after the bucket's last work, the
    copies of its valid prefix into ``out`` (pinned host buffers of its
    ``plan``, which the flight keeps alive while the card may run it).
    ``slots`` are the :class:`_Slot` of each card's replay, in card order;
    ``timed`` says whether their start events were recorded. ``device``
    is where the plan's outputs live."""

    __slots__ = ("plan", "device", "done", "out", "n_valid", "slots",
                 "timed")

    def __init__(self, plan, device, done, out, n_valid, slots, timed):
        self.plan, self.device, self.done, self.out = plan, device, done, out
        self.n_valid, self.slots, self.timed = n_valid, slots, timed

    def wait(self, split=obs.NO_SPLIT):
        """Block until this bucket is done, add each card's replay
        seconds to ``split.device`` where the launch was timed, and give
        the valid prefix, as host tensors its plan reuses two launches
        later."""
        # audit: allow[host-sync] serve block-until-ready: latency
        # metering must not timestamp the response before the bucket is
        # done; this bucket's event alone, not the bucket launched after it
        self.done.synchronize()
        if self.timed and split.device is not None:
            for card, slot in enumerate(self.slots):
                split.device[card] = (
                    split.device.get(card, 0.0)
                    + slot.ev_start.elapsed_time(slot.ev_end) * 1e-3)
        return self.out.view(self.n_valid)


class EagerPlan:
    """A bucket's plan on the CPU: the engine's batched call, run eagerly.
    Its input is a view of the host array, so a split's ``copy_in`` holds
    nothing of it and the run is its ``launch``; nothing is timed on the
    device. It has no device to overlap with, so it runs to its end when
    called and offers no asynchronous launch."""

    launches_async = False

    def __init__(self, runner, params, thresholds):
        self.runner, self.params, self.thresholds = runner, params, thresholds
        self.launches: dict = {}

    def replay(self, images, split=obs.NO_SPLIT):
        """Run the full bucket of host images; its outputs, all rows."""
        split.to("launch")
        return self.runner(self.params, self.thresholds,
                           torch.from_numpy(images))

    def __call__(self, images, n_valid: int, split=obs.NO_SPLIT):
        split.open("shard", card=0)
        split.to("launch")
        out = engine.slice_valid(*self.replay(images), n_valid)
        split.close()
        return out


class GraphPlan:
    """A bucket's plan on the card: one captured CUDA graph.

    The engine's batched call runs once eagerly on a side stream first (it
    builds the kernels, sets their shared-memory opt-ins and lets cuDNN pick
    its algorithms), then once under capture into ``pool``. ``launches``
    holds the kernel launches the capture recorded (``ops.launch_counts``
    moved by the wrappers during capture): every replay runs exactly these.
    A capture that fails raises; nothing falls back to eager execution.

    Two :class:`_Slot` are used in turn, a replay each (``slot`` is the
    last one's): the host's copy into a slot's pinned staging never races
    the host-to-device copy of the replay before, which may still read the
    other slot. Work is enqueued on ``stream``, the stream current on the
    plan's device when it was built, which serving replays on, in stream
    order: the next input copy and replay run after this replay's
    valid-prefix copies, so the static outputs need no copy on the device.
    A slot's ``ev_start`` is recorded just before the input's
    host-to-device copy when the replay is timed for a split
    (``split.device`` not None), and its ``ev_end`` (:meth:`mark_end`)
    after the last work the plan enqueues there (the valid-prefix copies;
    in a :class:`ShardedPlan`, the shard's replay, and on the first card
    the gather and its copies). The span between them counts any gap
    inside it as busy, so it bounds the card's busy time from above.
    """

    launches_async = True

    def __init__(self, runner, params, thresholds, shape, device, pool):
        # the graph reads these tensors' memory: the plan keeps them alive
        self.params, self.thresholds = params, thresholds
        self.images = torch.zeros(shape, dtype=torch.float32, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            runner(params, thresholds, self.images)
        torch.cuda.current_stream(device).wait_stream(side)
        before = dict(ops.launch_counts)
        self.graph = torch.cuda.CUDAGraph()
        # captured on the side stream of this plan's device: the default
        # capture stream lives on the first device the process captured on,
        # and ops on another card's tensors would run outside the capture
        with torch.cuda.graph(self.graph, pool=pool, stream=side):
            self.logits, self.stats = runner(params, thresholds, self.images)
        self.launches = {k: ops.launch_counts[k] - before[k] for k in before}
        self.stream = torch.cuda.current_stream(device)
        self._slots = [_Slot(shape, self.logits, self.stats)
                       for _ in range(2)]
        self.slot = self._slots[1]

    def replay(self, images, split=obs.NO_SPLIT):
        """Copy host images in through the next slot and replay; the
        static outputs, all rows (a later replay overwrites them)."""
        split.to("copy_in")
        self.slot = slot = self._slots[self._slots[0] is self.slot]
        # host images go to the static input through pinned memory
        slot.staging.copy_(torch.from_numpy(images))
        if split.device is not None:
            slot.ev_start.record(self.stream)
        self.images.copy_(slot.staging, non_blocking=True)
        split.to("launch")
        self.graph.replay()
        return self.logits, self.stats

    def mark_end(self) -> None:
        """Record the last slot's ``ev_end`` after the work enqueued on
        this card so far."""
        self.slot.ev_end.record(self.stream)

    def launch(self, images, n_valid: int, split=obs.NO_SPLIT) -> Flight:
        """Replay a bucket and enqueue its valid prefix's copies to the
        slot's pinned outputs; returns without waiting for the card."""
        split.open("shard", card=0)
        logits, stats = self.replay(images, split)
        slot = self.slot
        slot.out.pull(logits, stats, n_valid)
        self.mark_end()
        split.close()
        return Flight(self, self.images.device, slot.ev_end, slot.out,
                      n_valid, (slot,), split.device is not None)


class ShardedPlan:
    """A bucket's plan over a data mesh: one plan per shard, in shard order.

    Shard ``i`` holds rows ``[i*k, (i+1)*k)`` of the bucket (``k`` = bucket
    / mesh size) and runs on its own device; the shards run in turn and
    their outputs are gathered to ``device`` (the mesh's first) in batch
    order, so the result equals the unsharded plan's bit for bit (the
    engine's mask contract). The gathered tensors are new, so the valid
    prefix needs no copy. Card ``i`` is the shard's position in the mesh
    (on ``data_mesh(n)``, the card's index).

    Over graph shards it launches asynchronously, as a :class:`GraphPlan`
    does: the valid prefix is copied from the gathered tensors on the first
    card into two sets of pinned host buffers of its own, used in turn, and
    the first card's end event, recorded after those copies, marks the
    bucket done. Over eager shards (the CPU) it runs to its end when called.

    The gather runs each copy on its source card's stream after that
    stream waited for the first card's, and the first card's stream waits
    for each copy. So the other cards' end events are recorded before the
    gather (their spans leave the wait out), the first card's after it,
    and the first card's end event done finds every card's events done.
    """

    def __init__(self, shards, device):
        self.shards, self.device = shards, device
        self.launches = {}
        for plan in shards:
            for name, n in plan.launches.items():
                self.launches[name] = self.launches.get(name, 0) + n
        self.launches_async = all(p.launches_async for p in shards)
        if self.launches_async:
            first = shards[0]
            rows = first.images.shape[0] * len(shards)
            self._outs = [_HostOut(first.logits, first.stats, rows)
                          for _ in range(2)]

    def _replay(self, images, split):
        """Every shard's replay, in shard order; their outputs."""
        k = images.shape[0] // len(self.shards)
        outs = []
        for i, plan in enumerate(self.shards):
            split.open("shard", card=i)
            outs.append(plan.replay(images[i * k:(i + 1) * k], split))
            split.close()
        split.to("launch")
        return outs

    def __call__(self, images, n_valid: int, split=obs.NO_SPLIT):
        outs = self._replay(images, split)
        return engine.slice_valid(*gather(outs, self.device), n_valid)

    def launch(self, images, n_valid: int, split=obs.NO_SPLIT) -> Flight:
        outs = self._replay(images, split)
        for plan in self.shards[1:]:
            plan.mark_end()
        logits, stats = gather(outs, self.device)
        self._outs.reverse()
        out = self._outs[0]
        out.pull(logits, stats, n_valid)
        first = self.shards[0]
        first.mark_end()
        return Flight(self, self.device, first.slot.ev_end, out, n_valid,
                      tuple(p.slot for p in self.shards),
                      split.device is not None)


class ModelHandle:
    """One servable model: artifacts on its device + per-bucket plans."""

    def __init__(self, name: str, params, thresholds, cfg, *,
                 backend: str = "queue_pallas", vmem_resident: bool = True,
                 plan_cache_size: int = 8, device=None, mesh=None):
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
        self.mesh = mesh                     # data mesh for divisible buckets
        # shard device -> the graph pool of this handle's plans there
        self._pools: dict = {}
        # bucket B -> plan, insertion-ordered for LRU
        self._plans: collections.OrderedDict = collections.OrderedDict()
        # plans built (cache misses in plan_for): the observable the warmup
        # recompilation guard asserts stays flat
        self.compile_count = 0
        # per bucket: the kernel launches its graph records (captures of
        # this handle), and how often a plan of it has run
        self.plan_launches: dict[int, dict] = {}
        self.replay_count: collections.Counter = collections.Counter()

    def set_mesh(self, mesh) -> None:
        """(Re)point this handle at a data mesh; drops its plans if the
        mesh changes. A plan is bound to its placement, so the next
        ``plan_for`` builds against the new one; results stay bit-equal
        either way (the mask contract)."""
        if mesh != self.mesh:
            self.mesh = mesh
            self._plans.clear()
            self._pools.clear()

    def _bucket_sharded(self, bucket: int) -> bool:
        """Sharded plan iff a mesh of more than one device is set and the
        bucket divides it; a small bucket that does not (B=1 on a 2-way
        mesh) stays on the single-device plan."""
        n = mesh_size(self.mesh)
        return n > 1 and bucket % n == 0

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
        call; with a mesh that the bucket divides, a :class:`ShardedPlan` of
        such plans, one per shard."""
        if self._bucket_sharded(bucket):
            plan = self._sharded_plan(bucket)
        else:
            plan = self._device_plan(self.params, self.thresholds,
                                     self._shape(bucket), self.device,
                                     self._pool)
        if self.device.type == "cuda":
            self.plan_launches[bucket] = plan.launches
        return plan

    def _device_plan(self, params, thresholds, shape, device, pool):
        if device.type == "cuda":
            return GraphPlan(self._runner, params, thresholds, shape, device,
                             pool)
        return EagerPlan(self._runner, params, thresholds)

    def _sharded_plan(self, bucket: int) -> ShardedPlan:
        n = len(self.mesh.devices)
        shape = (bucket // n,) + self._shape(bucket)[1:]
        shards = []
        for d in map(resolve_device, self.mesh.devices):
            p, th = replicate(self.params, self.thresholds, d, self.mesh)
            if d.type != "cuda":
                pool = None
            elif th[0] is self.thresholds[0]:   # the handle's device
                pool = self._pool
            else:
                if d not in self._pools:
                    self._pools[d] = torch.cuda.graph_pool_handle()
                pool = self._pools[d]
            with on_device(d):
                shards.append(self._device_plan(p, th, shape, d, pool))
        return ShardedPlan(shards, resolve_device(self.mesh.devices[0]))

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
                      backend=self.backend, bucket=bucket,
                      sharded=self._bucket_sharded(bucket)):
            plan = self.build_plan(bucket)
        self.compile_count += 1
        self._plans[bucket] = plan
        self._evict()
        return plan

    def cached_buckets(self) -> tuple:
        return tuple(self._plans)

    def adopt_plan(self, bucket: int, plan) -> None:
        """Install a ready plan for ``bucket`` — ``plan(images, n_valid,
        split) -> (logits, stats)`` of the valid prefix, for a (B, H, W, C)
        float32 numpy bucket, as :class:`EagerPlan` is; or, with
        ``launches_async`` true, ``plan.launch(images, n_valid, split)``
        returning a flight whose ``wait(split)`` gives that prefix and
        whose ``device`` is the plan's, as :class:`GraphPlan` is
        (``build_plan`` makes one). It
        enters the same LRU but does **not** bump ``compile_count``: an
        adopted plan is a cache hit by construction, so the warmup guard
        keeps working (``serve/persist.py`` restores a checkpoint's plans
        through here)."""
        self._plans.pop(bucket, None)
        self._plans[bucket] = plan
        obs.counter("serve.plan_adopt")
        self._evict()

    def launches_async(self, bucket: int) -> bool:
        """Whether a bucket of this size launches without waiting for the
        device (:meth:`launch_bucket`): its cached plan says so
        (``launches_async``); a plan not built yet would be a CUDA graph
        on the card, the eager call on the CPU."""
        plan = self._plans.get(bucket)
        if plan is None:
            return self.device.type == "cuda"
        return getattr(plan, "launches_async", False)

    def launch_bucket(self, images, n_valid: int, split=obs.NO_SPLIT):
        """Launch one padded (B, H, W, C) bucket of host images through a
        plan that launches asynchronously (:meth:`launches_async`), and
        return its :class:`Flight` without waiting for the device.

        ``split`` (an ``obs.Split``, the runtime's step) is cut into two
        phases, each summed over shards: ``copy_in`` (the plan lookup, the
        contiguous copy, the pinned staging copy and the host-to-device
        enqueue) and ``launch`` (the graph replay, on a mesh the gather,
        and the valid prefix's device-to-host enqueue); each plan's replay
        is a ``shard`` region with its ``card``.
        """
        split.to("copy_in")
        images = np.ascontiguousarray(images, np.float32)
        bucket = images.shape[0]
        flight = self.plan_for(bucket).launch(images, n_valid, split)
        self.replay_count[bucket] += 1
        return flight

    def finish_bucket(self, flight, split=obs.NO_SPLIT):
        """Wait for a launched bucket (``sync_wait``, left running for the
        caller to end: the wait on its own completion event, then the
        device-event reads) and return its valid prefix, as host tensors
        in its plan's pinned buffers, which a later launch of the plan
        reuses. On the card, ``split.device[card]`` gains each replay's
        seconds between its timing events when the launch was split."""
        split.to("sync_wait")
        return flight.wait(split)

    def run_bucket(self, images, n_valid: int, split=obs.NO_SPLIT):
        """Execute one padded (B, H, W, C) bucket of host images; return the
        valid prefix (see the engine's mask contract) as tensors on the
        plan's device that no later bucket overwrites.

        Waits for the bucket before returning, so the caller's clock read
        after it covers the bucket's execution: :meth:`launch_bucket` then
        :meth:`finish_bucket`, whose phases it cuts ``split`` into, where
        the plan launches asynchronously; else the plan's call
        (``copy_in`` the lookup and copy, ``launch`` the run) and an empty
        ``sync_wait`` (a full device sync on the card).
        """
        if self.launches_async(np.shape(images)[0]):
            flight = self.launch_bucket(images, n_valid, split)
            logits, stats = self.finish_bucket(flight, split)
            return (logits.to(flight.device, copy=True),
                    engine.SNNStats(*(a.to(flight.device, copy=True)
                                      for a in stats)))
        split.to("copy_in")
        images = np.ascontiguousarray(images, np.float32)
        bucket = images.shape[0]
        out = self.plan_for(bucket)(images, n_valid, split)
        self.replay_count[bucket] += 1
        split.to("sync_wait")
        if self.device.type == "cuda":
            # audit: allow[host-sync] serve block-until-ready: a plan that
            # cannot launch asynchronously is waited for with the device
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
                 device=None, mesh=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if plan_cache_size < 1:
            raise ValueError(
                f"plan_cache_size must be >= 1, got {plan_cache_size}")
        self.capacity = capacity
        self.plan_cache_size = plan_cache_size
        self.device = resolve_device(device)
        self.mesh = mesh
        self._models: collections.OrderedDict = collections.OrderedDict()

    def set_mesh(self, mesh) -> None:
        """Point the registry and every registered handle at ``mesh``:
        later registrations inherit it, existing handles drop their plans
        and rebuild them lazily (:meth:`ModelHandle.set_mesh`)."""
        self.mesh = mesh
        for handle in self._models.values():
            handle.set_mesh(mesh)

    def register(self, name: str, params, thresholds, cfg, *,
                 backend: str = "queue_pallas",
                 vmem_resident: bool = True) -> ModelHandle:
        """Register artifacts under ``name`` (replaces any old one)."""
        handle = ModelHandle(name, params, thresholds, cfg, backend=backend,
                             vmem_resident=vmem_resident,
                             plan_cache_size=self.plan_cache_size,
                             device=self.device, mesh=self.mesh)
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
