"""repro_torch.obs: the reference's tracing + metrics contracts, in the port.

Carried over from ``tests/test_obs.py`` (span mechanics, percentiles
against numpy, the JSONL and Chrome-trace exporters, the shared no-op span
and its overhead bound, fake-clock determinism, serving neutrality and the
telescoping breakdown, the summarizer), plus what is the port's own: the
span, event, counter and histogram names of one traced serve run equal the
reference's for the same run, the dispatch counters name the reference's
realizations, the engine, study and compile-cache instrumentation, the
CLI, and ``REPRO_TORCH_TRACE`` (not the reference's ``REPRO_TRACE``).
"""
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import serve as jserve
from repro.core import engine as jengine
from repro.kernels import ops as jops
from repro_torch import obs
from repro_torch import serve as tserve
from repro_torch.core import engine, snn_model
from repro_torch.kernels import ops as tops

from _torch_nets import dyadic_net

SPEC = "6C3-P2-4C3-8"
HW, C = 10, 1
N_LAYERS = len(engine.parse_spec(SPEC))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test starts disabled and empty, and restores the real clock
    (in both packages: the name-parity test traces the reference too)."""
    for o in (obs, jobs):
        o.disable()
        o.reset()
    yield
    for o in (obs, jobs):
        o.disable()
        o.reset()
        o._tracer.clock = time.perf_counter


class FakeClock:
    """Deterministic clock: advances ``step`` seconds per read."""

    def __init__(self, step=1.0):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


# ---------------------------------------------------------------------------
# Span mechanics
# ---------------------------------------------------------------------------

def test_span_nesting_parent_depth_and_attrs():
    obs.enable(clock=FakeClock())
    with obs.span("outer", model="toy"):
        with obs.span("inner", bucket=4) as inner:
            inner.set(valid=3)
    spans = {s.name: s for s in obs.spans()}
    assert set(spans) == {"outer", "inner"}
    o, i = spans["outer"], spans["inner"]
    assert o.parent == -1 and o.depth == 0
    assert i.parent == o.sid and i.depth == 1
    assert o.attrs == {"model": "toy"}
    assert i.attrs == {"bucket": 4, "valid": 3}
    assert i.dur == 1.0 and o.dur == 3.0


def test_span_records_survive_exceptions():
    obs.enable(clock=FakeClock())
    with pytest.raises(RuntimeError):
        with obs.span("doomed"):
            raise RuntimeError("boom")
    (s,) = obs.spans()
    assert s.name == "doomed" and s.dur == 1.0


def test_span_stacks_are_thread_local():
    import threading

    obs.enable()
    barrier = threading.Barrier(2)

    def work(tag):
        with obs.span(f"outer.{tag}"):
            barrier.wait(timeout=10)   # both outers open at once
            with obs.span(f"inner.{tag}"):
                pass

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    spans = {s.name: s for s in obs.spans()}
    for tag in "ab":
        assert spans[f"inner.{tag}"].parent == spans[f"outer.{tag}"].sid
        assert spans[f"outer.{tag}"].depth == 0


def test_events_and_metrics_record_when_enabled():
    obs.enable(clock=FakeClock())
    obs.event("cache.evict", key="k")
    obs.counter("hits")
    obs.counter("hits", 2)
    obs.gauge("depth", 7)
    obs.observe("lat", 0.5)
    (e,) = obs.events()
    assert e.name == "cache.evict" and e.attrs == {"key": "k"} and e.ts == 1.0
    snap = obs.metrics_snapshot()
    assert snap["counters"] == {"hits": 3}
    assert snap["gauges"] == {"depth": 7.0}
    assert snap["histograms"]["lat"]["count"] == 1


# ---------------------------------------------------------------------------
# Percentiles vs numpy (and the reference's estimator)
# ---------------------------------------------------------------------------

def test_histogram_percentiles_match_numpy_on_random_data():
    rng = np.random.default_rng(42)
    samples = rng.exponential(1e-3, 500)
    hist = obs.Histogram()
    ref_hist = jobs.Histogram()
    for s in samples:
        hist.observe(s)
        ref_hist.observe(s)
    ref = samples.astype(np.float32)
    summ = hist.summary()
    assert summ == ref_hist.summary()
    assert summ["count"] == 500
    expect = np.percentile(ref, [50.0, 95.0, 99.0])
    for i, key in enumerate(("p50", "p95", "p99")):
        assert summ[key] == float(expect[i]), key
    assert summ["mean"] == float(ref.mean())
    assert summ["min"] == float(ref.min())
    assert summ["max"] == float(ref.max())


def test_percentiles_helper_handles_empty_and_singleton():
    empty = obs.percentiles([])
    assert set(empty) == {50.0, 95.0, 99.0}
    assert all(np.isnan(v) for v in empty.values())
    one = obs.percentiles([2.5])
    assert all(v == 2.5 for v in one.values())


def test_bench_reports_obs_percentiles():
    from repro_torch.serve import bench

    assert bench.percentiles is obs.percentiles


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def _tiny_trace():
    obs.enable(clock=FakeClock(0.001))
    with obs.span("a", k=1):
        with obs.span("b"):
            pass
    obs.event("mark", why="test")
    obs.counter("n")
    obs.observe("h", 3.0)


def test_jsonl_roundtrip(tmp_path):
    _tiny_trace()
    p = tmp_path / "trace.jsonl"
    obs.save_jsonl(str(p))
    data = obs.export.read_jsonl(str(p))
    assert [s["name"] for s in data["spans"]] == ["b", "a"]  # finish order
    assert data["spans"][1]["depth"] == 0
    assert data["events"][0]["name"] == "mark"
    assert data["metrics"]["counters"] == {"n": 1}
    for line in p.read_text().splitlines():
        json.loads(line)
    # the reference's reader parses the port's trace into the same records
    assert jobs.export.read_jsonl(str(p)) == data


def test_chrome_trace_is_valid_trace_event_json(tmp_path):
    _tiny_trace()
    p = tmp_path / "trace.json"
    obs.save_chrome_trace(str(p))
    doc = json.loads(p.read_text())
    assert isinstance(doc["traceEvents"], list)
    complete = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    instants = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert {e["name"] for e in complete} == {"a", "b"}
    assert instants and instants[0]["name"] == "mark"
    for e in complete:
        assert e["dur"] > 0 and "ts" in e and "pid" in e and "tid" in e
        assert e.get("args", {}) == ({"k": 1} if e["name"] == "a" else {})
    # the reference's exporter writes the same document for the same records
    assert doc == jobs.export.chrome_trace(obs.spans(), obs.events())


# ---------------------------------------------------------------------------
# Zero-cost when disabled
# ---------------------------------------------------------------------------

def test_disabled_calls_are_noops_and_share_one_span():
    assert not obs.enabled()
    s1 = obs.span("x", a=1)
    s2 = obs.span("y")
    assert s1 is s2 is obs.NOOP_SPAN
    with s1:
        s1.set(b=2)
    obs.counter("c")
    obs.gauge("g", 1)
    obs.observe("h", 1)
    obs.event("e")
    assert obs.spans() == [] and obs.events() == []
    snap = obs.metrics_snapshot()
    assert snap["counters"] == {} and snap["histograms"] == {}


def test_disabled_span_overhead_below_pinned_bound():
    """Disabled instrumentation costs < 5µs/span (min-of-5 over 20k span
    cycles, as the reference's bound)."""
    N = 20_000

    def cycle():
        t0 = time.perf_counter()
        for _ in range(N):
            with obs.span("hot", bucket=16):
                pass
            obs.counter("hot.calls")
        return time.perf_counter() - t0

    best = min(cycle() for _ in range(5))
    per_span = best / N
    assert per_span < 5e-6, f"disabled span overhead {per_span * 1e9:.0f}ns"


# ---------------------------------------------------------------------------
# Injectable-clock determinism
# ---------------------------------------------------------------------------

def test_same_fake_clock_gives_identical_records():
    def run():
        obs.reset()
        obs.enable(clock=FakeClock(0.5))
        with obs.span("stage", i=0):
            obs.event("tick")
            with obs.span("sub"):
                pass
        return ([s.to_dict() for s in obs.spans()],
                [e.to_dict() for e in obs.events()])

    first, second = run(), run()
    assert first == second
    assert first[0][0]["ts"] == 1.5 and first[0][0]["dur"] == 0.5
    assert first[0][1]["ts"] == 0.5 and first[0][1]["dur"] == 2.0
    assert first[1][0]["ts"] == 1.0


# ---------------------------------------------------------------------------
# Serving: tracing is bit-exactness-neutral and the breakdown telescopes
# ---------------------------------------------------------------------------

def _cfg_kw():
    return dict(spec=SPEC, input_hw=HW, input_c=C, T=3, depth=16,
                mode="mttfs_cont")


def _serve_batch(imgs, *, traced):
    obs.reset()
    if traced:
        obs.enable()
    else:
        obs.disable()
    params = snn_model.init_params(torch.Generator().manual_seed(7), SPEC,
                                   HW, C, device="cpu")
    th = [torch.tensor(0.5)] * N_LAYERS
    registry = tserve.ModelRegistry(device="cpu")
    registry.register("toy", params, th, engine.SNNConfig(**_cfg_kw()),
                      backend="queue_pallas")
    runtime = tserve.ServeRuntime(registry, tserve.BucketPolicy((1, 4)))
    for img in imgs:
        runtime.submit(img, "toy")
    return runtime.run_until_drained()


def test_tracing_is_bit_exact_neutral_on_serve_responses():
    imgs = np.random.default_rng(11).random((5, HW, HW, C)).astype(np.float32)
    off = sorted(_serve_batch(imgs, traced=False), key=lambda r: r.rid)
    on = sorted(_serve_batch(imgs, traced=True), key=lambda r: r.rid)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.logits, b.logits)
        assert a.pred == b.pred
        for f_a, f_b in zip(a.stats, b.stats):
            np.testing.assert_array_equal(f_a, f_b)
        assert np.float32(a.energy_j) == np.float32(b.energy_j)
    names = {s.name for s in obs.spans()}
    assert {"serve.execute", "serve.price", "serve.aot_compile"} <= names
    counters = obs.metrics_snapshot()["counters"]
    assert counters["serve.requests"] == 5 and counters["serve.batches"] == 2
    assert [e.name for e in obs.events()].count("serve.request") == 5


def test_breakdown_telescopes_to_step_total_and_event_latency():
    imgs = np.random.default_rng(3).random((5, HW, HW, C)).astype(np.float32)
    responses = _serve_batch(imgs, traced=True)
    assert len(responses) == 5
    for r in responses:
        b = r.breakdown
        parts = b["batch_form_s"] + b["execute_s"] + b["price_s"]
        assert r.step_total_s > 0
        assert parts == pytest.approx(r.step_total_s, rel=1e-9, abs=1e-9)
        assert 0.0 <= r.pad_fraction < 1.0
    reqs = [e for e in obs.events() if e.name == "serve.request"]
    assert len(reqs) == 5
    for e in reqs:
        a = e.attrs
        total = (a["queue_wait_s"] + a["batch_form_s"] + a["execute_s"]
                 + a["price_s"])
        assert total == pytest.approx(a["latency_s"], rel=1e-9, abs=1e-9)


def test_summarize_renders_breakdown_from_trace(tmp_path):
    from repro_torch.obs import summarize

    imgs = np.random.default_rng(5).random((3, HW, HW, C)).astype(np.float32)
    _serve_batch(imgs, traced=True)
    p = tmp_path / "serve.jsonl"
    obs.save_jsonl(str(p))
    report = summarize.summarize(str(p))
    assert "serve.execute" in report
    assert "serve.request" in report or "waterfall" in report.lower()
    for col in ("queue-wait", "batch-form", "execute", "price"):
        assert col in report, col
    # one summarizer reads either package's trace: the same report
    from repro.obs import summarize as jsummarize

    assert jsummarize.summarize(str(p)) == report


def test_summarize_cli_writes_report_and_chrome(tmp_path):
    from repro_torch.obs.__main__ import main

    _tiny_trace()
    p, chrome, md = (tmp_path / "t.jsonl", tmp_path / "t.json",
                     tmp_path / "summary.md")
    obs.save_jsonl(str(p))
    assert main(["summarize", str(p), "--chrome", str(chrome),
                 "--summary", str(md)]) == 0
    assert "Time by span" in md.read_text()
    doc = json.loads(chrome.read_text())
    assert doc == obs.export.chrome_trace(obs.spans(), obs.events())


# ---------------------------------------------------------------------------
# The port's names are the reference's
# ---------------------------------------------------------------------------

def _names(o):
    snap = o.metrics_snapshot()
    return dict(spans={s.name for s in o.spans()},
                events={e.name for e in o.events()},
                counters=set(snap["counters"]),
                histograms=set(snap["histograms"])), snap["counters"]


def test_traced_serve_run_names_equal_the_reference():
    """The same small serve run (5 images, buckets (1, 4)) traced in both
    packages records the same event, counter and histogram names, and the
    same request and batch counts; the port's span names hold the
    reference's, and beyond them exactly the served step's own phase spans
    (``serve.runtime.STEP_SPANS`` less the reference's ``serve.execute``
    and ``serve.price``)."""
    params_np, th = dyadic_net(SPEC, HW, C)
    imgs = np.random.default_rng(11).random((5, HW, HW, C)).astype(np.float32)
    # a config of this test's own, traced afresh: the reference counts its
    # dispatches while tracing, which a cached trace would skip
    kw = dict(_cfg_kw(), depth=12)
    jax.clear_caches()

    jobs.enable()
    jreg = jserve.ModelRegistry()
    jreg.register("toy", [{k: jnp.asarray(v) for k, v in p.items()}
                          for p in params_np],
                  [jnp.asarray(t) for t in th], jengine.SNNConfig(**kw),
                  backend="queue_pallas")
    jrt = jserve.ServeRuntime(jreg, jserve.BucketPolicy((1, 4)))
    for img in imgs:
        jrt.submit(img, "toy")
    jresp = jrt.run_until_drained()

    obs.enable()
    treg = tserve.ModelRegistry(device="cpu")
    treg.register("toy", params_np, th, engine.SNNConfig(**kw),
                  backend="queue_pallas")
    trt = tserve.ServeRuntime(treg, tserve.BucketPolicy((1, 4)))
    for img in imgs:
        trt.submit(img, "toy")
    tresp = trt.run_until_drained()

    assert len(tresp) == len(jresp) == 5
    (tn, tc), (jn, jc) = _names(obs), _names(jobs)
    tspans, jspans = tn.pop("spans"), jn.pop("spans")
    assert tn == jn
    assert jspans <= tspans
    from repro_torch.serve.runtime import STEP_SPANS

    assert tspans - jspans == set(STEP_SPANS) - {"serve.execute",
                                                  "serve.price"}
    assert "kernels.dispatch.fused:xla" in tc
    for key in ("serve.requests", "serve.batches"):
        assert tc[key] == jc[key]


def test_dispatch_counter_names_match_the_reference():
    """Each realization's dispatch counter carries the reference's name for
    the same call on the CPU."""
    from repro.core import aeq as jaeq
    from repro.core import encoding as jenc

    hw, K, depth = 9, 3, 16
    fmt = jenc.make_format(hw, K)
    raster = (np.random.default_rng(0).random((2, hw, hw, 2)) < 0.3)
    occ = np.array(jaeq.phase_occupancy(fmt, jnp.asarray(
        raster.astype(np.float32))))
    w = np.random.default_rng(1).normal(size=(K, K, 2, 4)).astype(np.float32)
    kw = dict(K=K, n_win=fmt.n_win, depth=depth, H=hw, W=hw,
              bits=fmt.bits_coord)
    a = np.ones((4, 8), np.int8)
    one = np.float32(1.0)

    jobs.enable()
    for impl, extra in ((None, {}), ("sparse", {"e_cap": 512}),
                        ("ref", {})):
        jops.fused_spike_accum(jnp.asarray(occ), jnp.asarray(w), impl=impl,
                               invalid=fmt.invalid_word, **extra, **kw)
    jops.quant_matmul(jnp.asarray(a), jnp.asarray(a.T), one, one)

    obs.enable()
    for impl, extra in ((None, {}), ("sparse", {"e_cap": 512}),
                        ("ref", {})):
        tops.fused_spike_accum(torch.from_numpy(occ), torch.from_numpy(w),
                               impl=impl, **extra, **kw)
    tops.quant_matmul(torch.from_numpy(a), torch.from_numpy(a.T.copy()),
                      torch.tensor(one), torch.tensor(one))

    want = {"kernels.dispatch.fused:xla", "kernels.dispatch.fused:sparse",
            "kernels.dispatch.fused:ref", "kernels.dispatch.quant_matmul:ref"}
    assert set(obs.metrics_snapshot()["counters"]) == want
    assert set(jobs.metrics_snapshot()["counters"]) == want


# ---------------------------------------------------------------------------
# Engine, study, registry instrumentation
# ---------------------------------------------------------------------------

def test_engine_counts_first_call_of_a_key_as_a_miss():
    params_np, th = dyadic_net(SPEC, HW, C)
    cfg = engine.SNNConfig(**dict(_cfg_kw(), depth=11))   # a key of its own
    imgs = np.random.default_rng(2).random((3, HW, HW, C)).astype(np.float32)
    obs.enable()
    first = engine.infer_batch(params_np, th, cfg, imgs, device="cpu")
    again = engine.infer_batch(params_np, th, cfg, imgs, device="cpu")
    engine.infer_batch(params_np, th, cfg, imgs[:2], device="cpu")  # new B
    engine.infer(params_np, th, cfg, imgs[0], device="cpu")  # infer's key
    counters = obs.metrics_snapshot()["counters"]
    assert counters["engine.jit_miss"] == 3
    assert counters["engine.jit_hit"] == 1
    compiles = [s for s in obs.spans() if s.name == "engine.jit_compile"]
    assert [s.attrs["B"] for s in compiles] == [3, 2, 0]
    assert all(s.attrs["backend"] == "dense" for s in compiles)
    assert torch.equal(first[0], again[0])


def _registry_change_counts(pkg, change):
    """``engine.jit_miss`` / ``jit_hit`` over two ``dense`` calls of one
    key, ``change(engine, neuron)``, and one more call, in the reference
    (``pkg="ref"``) or the port."""
    if pkg == "ref":
        from repro.core import neuron as neu

        eng, o = jengine, jobs
    else:
        from repro_torch.core import neuron as neu

        eng, o = engine, obs
    params, th = dyadic_net(SPEC, HW, C)
    imgs = np.random.default_rng(2).random((3, HW, HW, C)).astype(np.float32)
    cfg = eng.SNNConfig(**_cfg_kw())
    if pkg == "ref":
        params = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
        th, imgs = [jnp.asarray(t) for t in th], jnp.asarray(imgs)

    def call():
        if pkg == "ref":
            eng.infer_batch(params, th, cfg, imgs, backend="dense")
        else:
            eng.infer_batch(params, th, cfg, imgs, backend="dense",
                            device="cpu")

    eng._jit_seen.clear()
    o.enable()
    try:
        call()
        call()
        change(eng, neu)
        call()
        counters = o.metrics_snapshot()["counters"]
    finally:
        o.disable()
        o.reset()
        eng._BACKENDS.pop("probe_x", None)
        neu.unregister_neuron_model("probe_c5")
    return counters.get("engine.jit_miss", 0), counters.get("engine.jit_hit", 0)


def _new_backend(eng, neu):
    eng.register_backend("probe_x", eng.get_backend("dense"), overwrite=True)


def _same_mode_again(eng, neu):
    m = neu.get_neuron_model("mttfs_cont")
    neu.register_neuron_model("mttfs_cont", m.fire,
                              pool_latch_once=m.pool_latch_once,
                              overwrite=True)


def _probe_mode_removed(eng, neu):
    neu.register_neuron_model("probe_c5", neu.get_neuron_model("mttfs").fire)
    neu.unregister_neuron_model("probe_c5")


def _absent_mode_removed(eng, neu):
    neu.unregister_neuron_model("probe_c5_absent")   # no-op: no hooks


@pytest.mark.parametrize("change,want", [
    (_new_backend, (2, 1)), (_same_mode_again, (2, 1)),
    (_probe_mode_removed, (2, 1)), (_absent_mode_removed, (1, 2))],
    ids=["register_backend", "register_neuron_model",
         "unregister_neuron_model", "unregister_absent"])
def test_registry_change_restarts_first_call_tracking(change, want):
    """A registry change (a backend registered over, a neuron mode
    re-registered, a mode removed) makes the next call of a key a first
    call again, in both packages alike; removing an absent mode changes
    nothing."""
    assert _registry_change_counts("ref", change) == want
    assert _registry_change_counts("port", change) == want


def test_study_cache_counts_tiers_and_spans_builds(tmp_path):
    from repro_torch.study import StudyCache

    obs.enable()
    built = []
    cache = StudyCache(dir=str(tmp_path))
    for _ in range(2):
        cache.get_or_build("train", "k1", lambda: built.append(1) or [1.0],
                           tag="t")
    StudyCache(dir=str(tmp_path)).get_or_build(
        "train", "k1", lambda: built.append(1) or [1.0], tag="t")
    assert len(built) == 1
    counters = obs.metrics_snapshot()["counters"]
    assert counters == {"study.cache.train.miss": 1,
                        "study.cache.train.mem_hit": 1,
                        "study.cache.train.disk_hit": 1}
    (s,) = obs.spans()
    assert s.name == "study.train" and s.attrs == {"key": "k1", "tag": "t"}


def test_study_run_traces_its_stages():
    from repro_torch import study

    spec = study.StudySpec(dataset="mnist", net="6C3-P2-8", input_hw=28,
                           input_c=1, n_train=64, epochs=1, n_eval=16,
                           n_calib=16, T=3, depth=64)
    obs.enable()
    study.run(spec, cache=study.StudyCache(), device="cpu")
    names = {s.name for s in obs.spans()}
    assert {"study.train", "study.convert", "study.collect",
            "study.price"} <= names
    counters = obs.metrics_snapshot()["counters"]
    assert counters["study.stage.price"] == 1
    assert counters["study.cache.train.miss"] == 1


def test_registry_evictions_are_traced():
    params_np, th = dyadic_net(SPEC, HW, C)
    cfg = engine.SNNConfig(**_cfg_kw())
    obs.enable()
    reg = tserve.ModelRegistry(capacity=1, plan_cache_size=1, device="cpu")
    h = reg.register("a", params_np, th, cfg)
    for b in (1, 4, 4):
        h.plan_for(b)
    h.adopt_plan(1, h.build_plan(1))
    reg.register("b", params_np, th, cfg)
    counters = obs.metrics_snapshot()["counters"]
    assert counters["serve.plan_compile"] == 2
    assert counters["serve.plan_hit"] == 1
    assert counters["serve.plan_adopt"] == 1
    assert counters["serve.plan_evictions"] == 2
    assert counters["serve.model_evictions"] == 1
    assert [(e.name, e.attrs) for e in obs.events()] == [
        ("serve.plan_evict", {"model": "a", "bucket": 1}),
        ("serve.plan_evict", {"model": "a", "bucket": 4}),
        ("serve.model_evict", {"model": "a"})]
    assert h.compile_count == 2


# ---------------------------------------------------------------------------
# The environment switch
# ---------------------------------------------------------------------------

def test_env_trace_writes_at_exit_and_is_not_the_references(tmp_path):
    """REPRO_TORCH_TRACE enables the port's tracing and writes its trace
    at exit; the reference's REPRO_TRACE does not switch the port on, so a
    process importing both packages has one writer per variable."""
    mine, theirs = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    code = ("from repro_torch import obs; from repro import obs as jobs; "
            "obs.counter('port.c'); jobs.counter('ref.c')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TORCH_TRACE=str(mine))
    env.pop("REPRO_TRACE", None)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
    lines = [json.loads(x) for x in mine.read_text().splitlines()]
    assert lines[-1]["type"] == "metrics"
    assert lines[-1]["counters"] == {"port.c": 1}

    env = dict(env, REPRO_TRACE=str(theirs))
    del env["REPRO_TORCH_TRACE"]
    mine.unlink()
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
    assert not mine.exists()
    ref_lines = [json.loads(x) for x in theirs.read_text().splitlines()]
    assert ref_lines[-1]["counters"] == {"ref.c": 1}
