"""The served step split from inside the runtime (``serve.runtime.PHASES``):
the seven phases telescope exactly to the step on an injected clock, sum to
the response's ``service_s`` and ``price_s``, accumulate per bucket in
``stats_summary()`` as fresh copies, become the ``serve.step`` span tree
with tracing on, and ``torch.profiler`` ranges of the same names while a
profiler records, tracing on or off. On the CPU, ``device_s`` stays empty
(the card's event times: tests/test_torch_cuda.py)."""
import copy

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs
from repro_torch import serve as tserve
from repro_torch.core import engine, snn_model
from repro_torch.parallel import DataMesh
from repro_torch.serve.runtime import PHASES, STEP_SPANS

SPEC = "6C3-P2-4C3-8"
HW, C = 10, 1


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


def _runtime(clock=None, *, cards=1):
    params = snn_model.init_params(torch.Generator().manual_seed(7), SPEC,
                                   HW, C, device="cpu")
    th = [torch.tensor(0.5)] * len(engine.parse_spec(SPEC))
    registry = tserve.ModelRegistry(device="cpu")
    handle = registry.register(
        "toy", params, th, engine.SNNConfig(spec=SPEC, input_hw=HW,
                                            input_c=C, T=3, depth=16,
                                            mode="mttfs_cont"),
        backend="queue_pallas")
    mesh = DataMesh(("cpu",) * cards) if cards > 1 else None
    kw = {} if clock is None else dict(clock=clock)
    rt = tserve.ServeRuntime(registry, tserve.BucketPolicy((1, 4)),
                             mesh=mesh, **kw)
    handle.warmup((1, 4))
    return rt


def _images(n, seed=3):
    return np.random.default_rng(seed).random((n, HW, HW, C)).astype(
        np.float32)


def _step(rt, n):
    for im in _images(n):
        rt.submit(im, "toy")
    return rt.step()


def _delta(after, before, bucket):
    b = before["phase_s"].get(bucket, dict.fromkeys(PHASES, 0.0))
    return {k: v - b[k] for k, v in after["phase_s"][bucket].items()}


@pytest.mark.parametrize("cards", [1, 4])
def test_phases_telescope_exactly_on_an_injected_clock(cards):
    rt = _runtime(FakeClock(), cards=cards)
    for n, bucket in ((4, 4), (1, 1), (3, 4), (4, 4)):
        before = rt.stats_summary()
        responses = _step(rt, n)
        after = rt.stats_summary()
        d = _delta(after, before, bucket)
        r = responses[0]
        assert list(d) == list(PHASES)
        assert all(v > 0 for v in d.values()), d
        assert sum(d.values()) == r.step_total_s
        assert d["batch_form"] == r.batch_form_s
        assert d["copy_in"] + d["launch"] + d["sync_wait"] == r.service_s
        assert d["pull"] + d["price"] + d["respond"] == r.price_s
        assert after["device_s"] == {}       # no card: nothing timed


def test_phases_sum_to_the_response_fields_on_the_wall_clock():
    rt = _runtime()
    before = rt.stats_summary()
    r = _step(rt, 4)[0]
    d = _delta(rt.stats_summary(), before, 4)
    assert sum(d.values()) == pytest.approx(r.step_total_s, rel=1e-9)
    assert d["copy_in"] + d["launch"] + d["sync_wait"] == pytest.approx(
        r.service_s, rel=1e-9)
    assert d["pull"] + d["price"] + d["respond"] == pytest.approx(
        r.price_s, rel=1e-9)


def test_stats_summary_accumulates_per_bucket_in_fresh_copies():
    rt = _runtime(FakeClock())
    first = rt.stats_summary()
    _step(rt, 4)
    _step(rt, 1)
    snap = rt.stats_summary()
    kept = copy.deepcopy(snap)
    assert sorted(snap["phase_s"]) == [1, 4]
    assert snap["bucket_histogram"] == {1: 1, 4: 1}
    _step(rt, 4)
    _step(rt, 4)
    later = rt.stats_summary()
    assert snap == kept                      # no aliasing of earlier ones
    assert first["phase_s"] == {} and first["device_s"] == {}
    grown = _delta(later, snap, 4)
    assert all(v > 0 for v in grown.values())
    assert later["phase_s"][1] == snap["phase_s"][1]
    later["phase_s"][4]["launch"] = -1.0     # a copy: the runtime's stays
    assert rt.stats_summary()["phase_s"][4]["launch"] > 0


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.sid),
                  key=lambda s: (s.t0, s.sid))


@pytest.mark.parametrize("cards", [1, 4])
def test_traced_step_is_the_span_tree_of_its_phases(cards):
    rt = _runtime(FakeClock(), cards=cards)
    obs.enable()
    before = rt.stats_summary()
    r = _step(rt, 4)[0]
    d = _delta(rt.stats_summary(), before, 4)
    spans = [s for s in obs.spans() if s.name in STEP_SPANS]
    assert {s.name for s in spans} == set(STEP_SPANS)
    (step,) = [s for s in spans if s.name == "serve.step"]
    assert step.parent == -1 and step.dur == r.step_total_s
    assert step.attrs == dict(model="toy", bucket=4, valid=4)
    top = _children(spans, step)
    assert [s.name for s in top] == [
        "serve.batch_form", "serve.execute", "serve.pull", "serve.price",
        "serve.respond"]
    execute = top[1]
    assert execute.attrs == dict(model="toy", bucket=4, valid=4)
    assert execute.dur == r.service_s
    assert top[3].attrs == dict(model="toy", valid=4)
    inner = _children(spans, execute)
    shards = [s for s in inner if s.name == "serve.shard"]
    want = (["serve.copy_in"] + ["serve.shard"] * cards
            + (["serve.launch"] if cards > 1 else []) + ["serve.sync_wait"])
    assert [s.name for s in inner] == want
    assert [s.attrs["card"] for s in shards] == list(range(cards))
    for sh in shards:
        # on the CPU the input is a view of the host array: no copy-in
        assert [s.name for s in _children(spans, sh)] == ["serve.launch"]
        assert sh.depth == 2
    # each phase's spans last exactly what its counter gained
    for phase in PHASES:
        dur = sum(s.dur for s in spans if s.name == "serve." + phase)
        assert dur == d[phase], phase
    # the group spans bound their children without a gap
    for g in [step, execute] + shards:
        kids = _children(spans, g)
        assert kids[0].t0 == g.t0 and kids[-1].t1 == g.t1
        assert all(a.t1 == b.t0 for a, b in zip(kids, kids[1:]))


def test_a_failed_step_leaves_no_span_open():
    rt = _runtime()
    obs.enable()
    rt.submit(_images(1)[0], "toy")
    rt.registry._models.clear()                # the model was evicted
    with pytest.raises(tserve.ServeError, match="no longer registered"):
        rt.step()
    assert obs._tracer._stack() == []
    names = [s.name for s in obs.spans()]
    assert "serve.step" in names and "serve.execute" not in names
    assert rt.stats_summary()["phase_s"] == {}


def _ranges(prof):
    """(name, start_ns, end_ns) of the trace's CPU ranges, by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU
           and (e.name().startswith("serve.") or e.name() == "bench.step")]
    return sorted(out, key=lambda r: (r[1], -r[2]))


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cards", [1, 4])
def test_profiler_ranges_mirror_the_phases(traced, cards):
    rt = _runtime(cards=cards)
    if traced:
        obs.enable()
    for im in _images(4):
        rt.submit(im, "toy")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.step"):
            responses = rt.step()
    assert len(responses) == 4
    ranges = _ranges(prof)
    (bench,) = [r for r in ranges if r[0] == "bench.step"]
    serve = [r for r in ranges if r[0] != "bench.step"]
    assert {r[0] for r in serve} == set(STEP_SPANS)
    assert all(bench[1] <= r[1] <= r[2] <= bench[2] for r in serve)
    (step,) = [r for r in serve if r[0] == "serve.step"]
    assert all(step[1] <= r[1] <= r[2] <= step[2] for r in serve)
    # the seven phases, first met in their order, and never overlapping
    leaves = [r for r in serve if r[0][len("serve."):] in PHASES]
    first = []
    for name, _, _ in leaves:
        if name not in first:
            first.append(name)
    assert first == ["serve." + p for p in PHASES]
    assert all(a[2] <= b[1] for a, b in zip(leaves, leaves[1:]))
    assert sum(r[0] == "serve.shard" for r in serve) == cards
    assert (len(obs.spans()) > 0) == traced


def test_spans_are_profiler_ranges_only_while_a_profiler_records():
    assert obs.span("x") is obs.NOOP_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = obs.span("region.off", a=1)
        assert isinstance(s, obs.Span)
        with s:
            s.set(b=2)
        obs.enable()
        with obs.span("region.on"):
            pass
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"region.off", "region.on"} <= names
    assert [s.name for s in obs.spans()] == ["region.on"]
    obs.disable()
    assert obs.span("x") is obs.NOOP_SPAN


def test_split_telescopes_and_records_from_the_same_reads():
    clock = FakeClock()
    obs.enable()
    sp = obs.split(clock, ("a", "b"), "t.")
    assert sp.t == 1.0
    sp.open("outer", k=1)
    sp.to("a")
    assert sp.to("b", tag="x") == 2.0
    sp.open("inner")                         # ends b at 3
    sp.to("a")
    sp.close(done=True)                      # ends a at 4
    sp.close()
    assert sp.seconds == {"a": 2.0, "b": 1.0}
    recs = {s.name + str(s.t0): s for s in obs.spans()}
    outer, inner = recs["t.outer1.0"], recs["t.inner3.0"]
    assert (outer.t1, outer.attrs, inner.t1) == (4.0, {"k": 1}, 4.0)
    assert inner.parent == outer.sid and inner.attrs == {"done": True}
    assert recs["t.b2.0"].attrs == {"tag": "x"}
    assert recs["t.a3.0"].parent == inner.sid
    assert obs._tracer._stack() == []
    # with neither tracing nor a profiler, only the seconds are kept
    obs.disable()
    quiet = obs.split(clock, ("a",))
    quiet.to("a")
    quiet.to(None)
    assert quiet.seconds == {"a": 1.0}
    assert obs.NO_SPLIT.to("a") == 0.0 and obs.NO_SPLIT.device is None


def test_tracer_record_nests_under_the_open_span():
    tracer = obs.Tracer(clock=FakeClock())
    with tracer.span("outer"):
        rec = tracer.record("held", 0.25, 0.75, k=2)
    outer = [s for s in tracer.spans() if s.name == "outer"][0]
    assert rec.parent == outer.sid and rec.depth == 1
    assert (rec.t0, rec.dur, rec.attrs) == (0.25, 0.5, {"k": 2})
    assert tracer.record("root", 2.0, 3.0).parent == -1
