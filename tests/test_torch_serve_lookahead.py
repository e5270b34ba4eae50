"""The served step's look-ahead of one full bucket, on the CPU.

On the card a bucket's plan launches without waiting (``GraphPlan.launch``)
and the runtime launches the next full ``max_bucket`` before it waits for
the batch it answers. Here a deferred plan, installed through
``ModelHandle.adopt_plan``, stands in for the graph: its launch keeps the
images, its flight's ``wait`` runs the eager call into one of two host
buffers used in turn (as a ``GraphPlan``'s pinned slots are), so the
runtime's card path runs on the CPU. The eager plans (``EagerPlan``)
launch nothing ahead. On the card: tests/test_torch_cuda.py -k lookahead.
"""
import copy
import gc

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch import serve as tserve
from repro_torch.core import engine, snn_model
from repro_torch.serve.runtime import PHASES

SPEC = "6C3-P2-4C3-8"
HW, C = 10, 1
BUCKETS = (1, 4, 8)
FULL = BUCKETS[-1]


@pytest.fixture(autouse=True)
def _obs_clean():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


class FakeClock:
    """Advances one second a read: every sum of phases is exact."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


class DeferredFlight:
    device = torch.device("cpu")

    def __init__(self, plan, images, n_valid, out):
        self.plan, self.images, self.n_valid, self.out = (plan, images,
                                                          n_valid, out)
        self.waited = 0

    def wait(self, split=obs.NO_SPLIT):
        logits, stats = self.plan.eager(self.images, self.n_valid)
        self.out[0][:self.n_valid] = logits
        for dst, src in zip(self.out[1], stats):
            dst[:self.n_valid] = src
        self.waited += 1
        return self.out[0][:self.n_valid], engine.SNNStats(
            *(a[:self.n_valid] for a in self.out[1]))


class DeferredPlan:
    """Launches by keeping a copy of the images; the flight's wait runs
    the eager call into the next of two reused host buffers."""

    launches_async = True

    def __init__(self, eager):
        self.eager, self.launches = eager, {}
        self._outs, self.flights = [], []

    def launch(self, images, n_valid, split=obs.NO_SPLIT):
        split.open("shard", card=0)
        split.to("copy_in")
        kept = images.copy()
        split.to("launch")
        if len(self._outs) < 2:
            logits, stats = self.eager(kept, len(kept))
            self._outs.append((torch.empty_like(logits),
                               engine.SNNStats(*map(torch.empty_like,
                                                    stats))))
        self._outs.reverse()
        split.close()
        flight = DeferredFlight(self, kept, n_valid, self._outs[0])
        self.flights.append(flight)
        return flight


def _registry(names=("toy",)):
    params = snn_model.init_params(torch.Generator().manual_seed(7), SPEC,
                                   HW, C, device="cpu")
    th = [torch.tensor(0.5)] * len(engine.parse_spec(SPEC))
    registry = tserve.ModelRegistry(device="cpu")
    cfg = engine.SNNConfig(spec=SPEC, input_hw=HW, input_c=C, T=3, depth=16,
                           mode="mttfs_cont")
    for name in names:
        registry.register(name, params, th, cfg,
                          backend="queue_pallas").warmup(BUCKETS)
    return registry


def _runtime(deferred=True, clock=None, names=("toy",)):
    registry = _registry(names)
    plans = {}
    if deferred:
        for name in names:
            h = registry.get(name)
            plans[name] = DeferredPlan(h.plan_for(FULL))
            h.adopt_plan(FULL, plans[name])
    kw = {} if clock is None else dict(clock=clock)
    return tserve.ServeRuntime(registry, tserve.BucketPolicy(BUCKETS),
                               **kw), plans


def _images(n, seed=3):
    return np.random.default_rng(seed).random((n, HW, HW, C)).astype(
        np.float32)


def _submit(rt, imgs, model="toy"):
    return [rt.submit(im, model) for im in imgs]


def _assert_same(got, want):
    assert [r.rid for r in got] == [r.rid for r in want]
    for a, b in zip(got, want):
        assert (a.model, a.pred, a.bucket) == (b.model, b.pred, b.bucket)
        np.testing.assert_array_equal(a.logits, b.logits)
        for f in ("events_in", "spikes_out", "add_ops", "queue_words",
                  "overflow"):
            np.testing.assert_array_equal(getattr(a.stats, f),
                                          getattr(b.stats, f))
        assert a.energy_j == b.energy_j
        assert a.model_latency_s == b.model_latency_s


def _by_rid(responses):
    return sorted(responses, key=lambda r: r.rid)


def test_lookahead_answers_equal_a_serial_run():
    """Six full buckets and a tail of five: the same responses, rid by
    rid, as the eager runtime's, and every full bucket but the first is
    launched ahead."""
    imgs = _images(6 * FULL + 5)
    rt, plans = _runtime()
    serial, _ = _runtime(deferred=False)
    _submit(rt, imgs)
    _submit(serial, imgs)
    got = rt.run_until_drained()
    want = serial.run_until_drained()
    _assert_same(_by_rid(got), _by_rid(want))
    assert [r.rid for r in got] == list(range(len(imgs)))  # in order
    assert rt.stats_summary()["launched_ahead"] == {FULL: 5}
    assert serial.stats_summary()["launched_ahead"] == {}
    assert rt.stats_summary()["bucket_histogram"] == {FULL: 7}
    assert all(f.waited == 1 for f in plans["toy"].flights)
    assert len(plans["toy"].flights) == 7


def test_pending_counts_the_batch_in_flight():
    rt, _ = _runtime()
    _submit(rt, _images(3 * FULL))
    first = rt.step()
    assert len(first) == FULL
    assert rt.pending() == 2 * FULL and len(rt.queue) == FULL
    assert rt.step() and rt.pending() == FULL and len(rt.queue) == 0
    # an empty queue: the step still answers the batch in flight
    last = rt.step()
    assert [r.rid for r in last] == list(range(2 * FULL, 3 * FULL))
    assert rt.pending() == 0 and rt.step() == []
    # a warm-up loop leaves nothing in flight
    _submit(rt, _images(2 * FULL + 3, seed=4))
    done = []
    while rt.pending():
        done += rt.step()
    assert len(done) == 2 * FULL + 3 and rt._in_flight == []
    assert rt.run_until_drained() == []


def test_run_until_drained_finishes_the_batch_in_flight():
    rt, _ = _runtime()
    _submit(rt, _images(2 * FULL))
    assert len(rt.step()) == FULL and rt.pending() == FULL
    rest = rt.run_until_drained()
    assert [r.rid for r in rest] == list(range(FULL, 2 * FULL))


def _delta(after, before, bucket):
    b = before["phase_s"].get(bucket, dict.fromkeys(PHASES, 0.0))
    return {k: v - b[k] for k, v in after["phase_s"][bucket].items()}


def test_phases_telescope_with_a_batch_in_flight():
    """Each call's seven phases sum exactly to its wall time and to the
    response fields, whether it launched two batches, one ahead, or none
    (answering the last batch in flight); the latency runs from arrival
    to the end of the call's execute."""
    clock = FakeClock()
    rt, _ = _runtime(clock=clock)
    rids = _submit(rt, _images(3 * FULL))
    arrival = {rid: float(i + 1) for i, rid in enumerate(rids)}
    obs.enable()
    for launched in (2, 1, 0):
        before = rt.stats_summary()
        responses = rt.step()
        after = rt.stats_summary()
        d = _delta(after, before, FULL)
        r = responses[0]
        assert all(v > 0 for k, v in d.items() if launched or k not in (
            "batch_form", "copy_in", "launch")), d
        if not launched:
            assert d["batch_form"] == d["copy_in"] == d["launch"] == 0.0
        assert sum(d.values()) == r.step_total_s
        assert d["batch_form"] == r.batch_form_s
        assert d["copy_in"] + d["launch"] + d["sync_wait"] == r.service_s
        assert d["pull"] + d["price"] + d["respond"] == r.price_s
        assert r.batch_form_s + r.service_s + r.price_s == r.step_total_s
        t_exec1 = clock.t - 3       # then price, respond and done: 3 reads
        for resp in responses:
            # arrival -> end of this call's execute (sync_wait's end)
            assert resp.latency_s == resp.queue_wait_s + resp.service_s
            assert arrival[resp.rid] + resp.latency_s == t_exec1
    # the waterfall's segments telescope to the same end
    events = [e for e in obs.events() if e.name == "serve.request"]
    assert len(events) == 3 * FULL
    for e in events:
        a = e.attrs
        assert a["latency_s"] == (a["queue_wait_s"] + a["batch_form_s"]
                                  + a["execute_s"] + a["price_s"])


def test_launched_ahead_only_on_full_buckets_of_an_async_plan():
    """A trickle of partial buckets launches nothing ahead, nor does the
    eager plan on full buckets; the counter also reaches obs."""
    rt, _ = _runtime()
    for i in range(4):
        _submit(rt, _images(3, seed=i))
        assert len(rt.step()) == 3
        assert rt.pending() == 0
    assert rt.stats_summary()["launched_ahead"] == {}
    eager, _ = _runtime(deferred=False)
    _submit(eager, _images(4 * FULL))
    while eager.pending():
        assert len(eager.step()) == FULL
        assert eager._in_flight == []
    assert eager.stats_summary()["launched_ahead"] == {}
    obs.enable()
    _submit(rt, _images(3 * FULL))
    rt.run_until_drained()
    assert rt.stats_summary()["launched_ahead"] == {FULL: 2}
    assert obs._metrics.counter_value("serve.launched_ahead") == 2


def test_two_models_both_progress():
    """Full buckets of two models: each step answers the other model's
    batch from the last one, and both answer as the eager runtime does."""
    names = ("a", "b")
    rt, _ = _runtime(names=names)
    serial, _ = _runtime(deferred=False, names=names)
    imgs = _images(4 * FULL)
    for r in (rt, serial):
        _submit(r, imgs[:3 * FULL], "a")
        _submit(r, imgs[3 * FULL:], "b")
    order = []
    got = []
    while rt.pending():
        step = rt.step()
        order.append(step[0].model)
        got += step
    assert order[:3] == ["a", "b", "a"]
    assert sorted(order) == ["a", "a", "a", "b"]
    _assert_same(_by_rid(got), _by_rid(serial.run_until_drained()))


def test_response_arrays_do_not_change_when_later_steps_run():
    rt, _ = _runtime()
    _submit(rt, _images(5 * FULL, seed=5))
    first = rt.step()
    kept = copy.deepcopy(first)
    rt.run_until_drained()
    _submit(rt, _images(3 * FULL, seed=6))
    rt.run_until_drained()
    _assert_same(first, kept)


def test_run_bucket_on_an_async_plan_returns_copies_of_its_own():
    rt, _ = _runtime()
    h = rt.registry.get("toy")
    imgs = _images(FULL, seed=8)
    first, stats = h.run_bucket(imgs, 5)
    kept = first.clone()
    h.run_bucket(_images(FULL, seed=9), FULL)
    h.run_bucket(_images(FULL, seed=10), FULL)
    assert torch.equal(first, kept) and first.shape[0] == 5
    eager, _ = _runtime(deferred=False)
    lr, sr = eager.registry.get("toy").run_bucket(imgs, 5)
    assert torch.equal(first, lr)
    assert all(torch.equal(a, b) for a, b in zip(stats, sr))


def test_a_dropped_runtime_waits_for_its_batch_in_flight():
    rt, plans = _runtime()
    _submit(rt, _images(2 * FULL))
    rt.step()
    (pending,) = [f for f in plans["toy"].flights if not f.waited]
    del rt
    gc.collect()
    assert pending.waited == 1
