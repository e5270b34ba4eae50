"""The serving loop: admission queue -> dynamic batcher -> per-request meters.

Port of ``repro.serve.runtime``, traced under the reference's names
(``repro_torch.obs``): the ``serve.execute`` and ``serve.price`` spans,
``serve.bucket_occupancy`` and ``serve.pad_fraction`` histograms,
``serve.batches`` and ``serve.requests`` counters, and one
``serve.request`` event a response whose waterfall segments telescope to
its ``latency_s``, beside ``serve.request_latency_s``. Every clock read
goes through ``ServeRuntime.clock`` (wall time by default); a load
generator on a virtual clock passes its own arrival times and batch launch
times (``submit(arrival_s=)``, ``step(now=)``).

Each step is cut into seven phases (:data:`PHASES`: ``batch_form``,
``copy_in``, ``launch``, ``sync_wait``, ``pull``, ``price``,
``respond``) at shared reads of that clock, through an ``obs.Split`` the
step hands to ``ModelHandle.run_bucket``. The phases telescope to the
step; ``stats_summary()`` sums them per bucket (``phase_s``), with each
card's device time between a replay's timing events (``device_s``),
always on. With tracing on they are the ``serve.step`` span tree
(:data:`STEP_SPANS`), and while a ``torch.profiler`` session records,
``record_function`` ranges of the same names
(``docs/OBSERVABILITY_TORCH.md``).

Each :meth:`ServeRuntime.step` forms ONE batch: it picks the next model
(the oldest request of a model other than the one just served, so one
model's stream cannot starve the rest), gathers up to ``max_bucket`` of its
waiting requests, pads to the policy's bucket, runs the handle on the
device and slices the valid prefix (the engine's mask contract keeps padded
slots inert). Each request's (1, L) stats row is priced through
``study.price_record`` into its response's ``energy_j`` /
``model_latency_s``; the batch is priced in one call, which equals pricing
each row alone because pricing is elementwise per sample.
"""
from __future__ import annotations

import collections
import time

import numpy as np

from .. import obs
from ..study.artifacts import StatsRecord
from ..study.stages import price_record
from .api import InferRequest, InferResponse, ServeError
from .batching import BucketPolicy
from .registry import ModelRegistry

#: A served step's phases, in order; they telescope to ``step_total_s``.
#: ``copy_in + launch + sync_wait`` is ``service_s`` and ``pull + price +
#: respond`` is ``price_s``.
PHASES = ("batch_form", "copy_in", "launch", "sync_wait", "pull", "price",
          "respond")
#: The spans of a traced step (``obs``) and the profiler ranges it mirrors:
#: ``serve.step`` holds ``serve.batch_form``, ``serve.execute`` (which
#: holds ``serve.copy_in``, one ``serve.shard`` a card, each holding its
#: ``serve.copy_in`` and ``serve.launch``, then, on a mesh, the gather's
#: ``serve.launch``, and ``serve.sync_wait``), ``serve.pull``,
#: ``serve.price`` and ``serve.respond``.
STEP_SPANS = ("serve.step", "serve.batch_form", "serve.execute",
              "serve.copy_in", "serve.shard", "serve.launch",
              "serve.sync_wait", "serve.pull", "serve.price",
              "serve.respond")


class ServeRuntime:
    """Admission queue + dynamic bucketed batcher over registered models."""

    def __init__(self, registry: ModelRegistry,
                 policy: BucketPolicy | None = None, *,
                 clock=time.perf_counter, mesh=None):
        self.registry = registry
        self.policy = policy or BucketPolicy()
        if mesh is not None:
            # data-parallel serving: the registered models rebuild their
            # buckets that divide the mesh as sharded plans (see
            # ModelHandle.build_plan); bit-exact, so responses and energy
            # metering equal single-device serving
            registry.set_mesh(mesh)
        self.clock = clock
        self.queue: collections.deque[InferRequest] = collections.deque()
        self._next_rid = 0
        self._last_model: str | None = None   # batcher rotation (fairness)
        self._pending: collections.Counter = collections.Counter()  # by model
        # service counters (see stats_summary)
        self.n_batches = 0
        self.n_served = 0
        self.n_padded_slots = 0
        self.bucket_histogram: collections.Counter = collections.Counter()
        self.phase_s: dict = {}      # bucket -> {phase: seconds}
        self.device_s: dict = {}     # bucket -> {card: device seconds}

    # -- admission ---------------------------------------------------------

    def submit(self, image, model: str | None = None, *,
               arrival_s: float | None = None) -> int:
        """Admit one (H, W, C) image for ``model``; returns the request id.

        ``model`` may be omitted only when exactly one model is registered.
        ``arrival_s`` overrides the admission timestamp (virtual-clock load
        generators pass their own time base; default is ``self.clock()``).
        """
        if model is None:
            names = self.registry.names()
            if len(names) != 1:
                raise ServeError(
                    "model= is required when the registry holds "
                    f"{len(names)} models ({sorted(names)})")
            model = names[0]
        handle = self.registry.get(model)
        image = np.asarray(image, np.float32)
        want = (handle.cfg.input_hw, handle.cfg.input_hw, handle.cfg.input_c)
        if image.shape != want:
            raise ServeError(
                f"model {model!r} expects image shape {want}, "
                f"got {image.shape}")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(InferRequest(
            rid=rid, model=model, image=image,
            arrival_s=self.clock() if arrival_s is None else arrival_s))
        self._pending[model] += 1
        return rid

    def pending(self) -> int:
        return len(self.queue)

    # -- the batcher -------------------------------------------------------

    def _next_model(self) -> str:
        """The model the next batch serves: rotate away from the last one.

        Plain head-of-line would let a sustained stream for one model
        starve the others (its round-down tail and fresh arrivals keep it
        at the head forever), so the batcher prefers the oldest request of
        a *different* model than it just served; only when every queued
        request belongs to the last-served model does it stay on it. This
        guarantees progress for every model — each batch drains requests
        ahead of it, so a request's wait is bounded by the backlog queued
        in front of it, never unbounded.
        """
        backlogged = [m for m, c in self._pending.items() if c > 0]
        if len(backlogged) == 1:
            return backlogged[0]     # the common case, without an O(queue)
                                     # scan per step (single-model drains
                                     # would otherwise go quadratic)
        for req in self.queue:
            if req.model != self._last_model:
                return req.model
        return self.queue[0].model

    def _take_batch(self, model: str) -> list[InferRequest]:
        """Up to ``max_bucket`` oldest queued requests for ``model``.

        Skipped requests (other models) are put back at the front in
        their original order; requests beyond the bucket cap are never
        popped at all, so batch formation costs O(taken + skipped), not
        O(queue).
        """
        taken, skipped = [], []
        while self.queue and len(taken) < self.policy.max_bucket:
            req = self.queue.popleft()
            (taken if req.model == model else skipped).append(req)
        self.queue.extendleft(reversed(skipped))
        return taken

    def step(self, now: float | None = None) -> list[InferResponse]:
        """Form, execute, and meter one batch; [] when the queue is empty.

        ``now`` is the batch launch time for queue-wait accounting; leave
        it None to read ``self.clock()`` (virtual-clock benches pass their
        simulated time instead).
        """
        if not self.queue:
            return []
        split = obs.split(self.clock, PHASES, "serve.")
        try:
            return self._step(split, now)
        except BaseException:
            split.abort()
            raise

    def _step(self, split, now: float | None) -> list[InferResponse]:
        # the step is cut into PHASES at shared clock reads (obs.Split):
        # [t_step0, t_exec0) batch_form; [t_exec0, t_exec1) execute,
        # whose copy_in, launch and sync_wait run_bucket cuts; [t_exec1,
        # t_done) pull, price and respond. The phases telescope to the
        # step total, and the three response fields to it too (pinned by
        # tests/test_torch_obs.py and tests/test_torch_serve_phases.py)
        t_step0 = split.t
        split.open("step")
        split.to("batch_form")
        model = self._next_model()
        try:
            handle = self.registry.get(model)
        except ServeError:
            # the model was LRU-evicted since submit. Reject ITS queued
            # requests loudly (the error names every dropped rid) but keep
            # the rest of the queue intact — one dead model must neither
            # silently lose work nor wedge serving for the healthy ones
            dead = [r.rid for r in self.queue if r.model == model]
            self.queue = collections.deque(
                r for r in self.queue if r.model != model)
            self._pending.pop(model, None)
            raise ServeError(
                f"model {model!r} is no longer registered; rejected its "
                f"queued request(s) rid={dead} (other models' requests "
                "remain queued)") from None
        taken = self._take_batch(model)
        self._last_model = model
        bucket = self.policy.select(len(taken))
        if bucket < len(taken):
            # the policy rounded down (serve a full bucket now rather than
            # pad past half): requeue the tail at the front, order intact
            self.queue.extendleft(reversed(taken[bucket:]))
            taken = taken[:bucket]
        padded = self.policy.pad(np.stack([r.image for r in taken]), bucket)

        t_exec0 = split.to(None)
        launch = t_exec0 if now is None else now
        split.open("execute", model=model, bucket=bucket, valid=len(taken))
        # synchronizes the device before it returns
        logits, stats = handle.run_bucket(padded, len(taken), split)
        t_exec1 = split.to(None)
        split.close()
        service_s = t_exec1 - t_exec0
        batch_form_s = t_exec0 - t_step0
        pad_fraction = (bucket - len(taken)) / bucket

        split.to("pull")
        self._pending[model] -= len(taken)
        self.n_batches += 1
        self.n_served += len(taken)
        self.n_padded_slots += bucket - len(taken)
        self.bucket_histogram[bucket] += 1
        if obs.enabled():
            obs.observe("serve.bucket_occupancy", len(taken) / bucket)
            obs.observe("serve.pad_fraction", pad_fraction)
            obs.counter("serve.batches")
            obs.counter("serve.requests", len(taken))

        # audit: allow[host-sync] the responses leave the device: the
        # bucket's logits and stats (run_bucket has synchronized already)
        logits = logits.cpu().numpy()
        ev, sp, ao, ovf, qw = (
            # audit: allow[host-sync] the same pull, one stats field each
            getattr(stats, f).cpu().numpy()
            for f in ("events_in", "spikes_out", "add_ops", "overflow",
                      "queue_words"))

        # price the whole batch in ONE price_record call (repricing is
        # elementwise per sample, so row i of a batch pricing bit-equals
        # pricing row i alone)
        split.to("price", model=model, valid=len(taken))
        batch_record = StatsRecord(events_in=ev, spikes_out=sp, add_ops=ao,
                                   queue_words=qw, overflow=ovf)
        e = price_record(batch_record, input_hw=handle.cfg.input_hw,
                         compressed=handle.cfg.compressed,
                         vmem_resident=handle.vmem_resident)
        # audit: allow[host-sync] pricing ran on the host copies above:
        # these are CPU tensors, no device is waited for
        energy_j = e.total_j.numpy()
        model_latency_s = e.latency_s.numpy()  # audit: allow[host-sync]

        split.to("respond")
        responses = []
        for i, req in enumerate(taken):
            row = StatsRecord(
                events_in=ev[i : i + 1], spikes_out=sp[i : i + 1],
                add_ops=ao[i : i + 1], queue_words=qw[i : i + 1],
                overflow=ovf[i : i + 1])
            responses.append(InferResponse(
                rid=req.rid, model=req.model, logits=logits[i],
                pred=int(np.argmax(logits[i])), stats=row,
                energy_j=float(energy_j[i]),
                model_latency_s=float(model_latency_s[i]),
                bucket=bucket, batch_valid=len(taken),
                queue_wait_s=max(0.0, launch - req.arrival_s),
                service_s=service_s, batch_form_s=batch_form_s,
                pad_fraction=pad_fraction))
        # the price window closes only after responses exist, so these two
        # fields are assigned post-construction (the dataclass is mutable)
        t_done = split.to(None)
        split.close(model=model, bucket=bucket, valid=len(taken))
        price_s = t_done - t_exec1
        step_total_s = t_done - t_step0
        self._add_phases(bucket, split)
        for resp in responses:
            resp.price_s = price_s
            resp.step_total_s = step_total_s
        if obs.enabled():
            for resp in responses:
                # waterfall segments must not overlap: queue_wait_s
                # (admission -> launch) already contains the batch-form
                # window, so the event's queue segment stops at t_step0
                wf_queue = max(0.0, resp.queue_wait_s - batch_form_s)
                obs.event(
                    "serve.request", rid=resp.rid, model=resp.model,
                    bucket=resp.bucket, pad_fraction=resp.pad_fraction,
                    queue_wait_s=wf_queue, batch_form_s=batch_form_s,
                    execute_s=service_s, price_s=price_s,
                    latency_s=wf_queue + batch_form_s + service_s + price_s)
                obs.observe("serve.request_latency_s", resp.latency_s)
        return responses

    def _add_phases(self, bucket: int, split) -> None:
        """Add a finished step's phase and device seconds to the bucket's
        running sums (``stats_summary``)."""
        acc = self.phase_s.get(bucket)
        if acc is None:
            acc = self.phase_s[bucket] = dict.fromkeys(PHASES, 0.0)
        for k, v in split.seconds.items():
            acc[k] += v
        if split.device:
            dev = self.device_s.setdefault(bucket, {})
            for card, v in split.device.items():
                dev[card] = dev.get(card, 0.0) + v

    def run_until_drained(self, max_steps: int = 100_000):
        """Step until the queue is empty; responses in completion order.

        If a step fails (e.g. a model evicted since submit), the raised
        :class:`ServeError` carries the responses already served on its
        ``completed`` attribute — work done for healthy requests is never
        lost to a later failure.
        """
        done: list[InferResponse] = []
        for _ in range(max_steps):
            if not self.queue:
                return done
            try:
                done.extend(self.step())
            except ServeError as e:
                e.completed = done
                raise
        err = ServeError(
            f"queue not drained after {max_steps} steps "
            f"({len(self.queue)} requests still pending)")
        err.completed = done
        raise err

    # -- service counters ----------------------------------------------------

    def stats_summary(self) -> dict:
        """Service counters, cumulative since the runtime was built:
        batches, padding overhead, bucket usage (``bucket_histogram``:
        steps by bucket), and where the steps' time went:

        - ``phase_s``: ``{bucket: {phase: seconds}}``, the seven
          :data:`PHASES` of every step of that bucket, on the runtime's
          clock; a step's seven sum to its ``step_total_s``;
        - ``device_s``: ``{bucket: {card: seconds}}``, each card's device
          time between a replay's timing events (from its input copy to
          its last work, gaps inside counted busy: an upper bound), on
          the card only (empty on the CPU).

        Every value is a fresh copy, so a snapshot taken earlier never
        changes as more steps run; two snapshots' difference is what ran
        between them (the benchmark's readers diff one taken before a
        window against one taken after it)."""
        slots = self.n_served + self.n_padded_slots
        return {
            "batches": self.n_batches,
            "served": self.n_served,
            "padded_slot_fraction":
                (self.n_padded_slots / slots) if slots else 0.0,
            "bucket_histogram": dict(sorted(self.bucket_histogram.items())),
            "phase_s": {b: dict(v) for b, v in sorted(self.phase_s.items())},
            "device_s": {b: dict(sorted(v.items()))
                         for b, v in sorted(self.device_s.items())},
        }
