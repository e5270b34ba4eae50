"""The port's plan cache, virtual clock and load generator against the JAX
package's, on the CPU.

Same numpy weights (the dyadic nets of ``_torch_nets``, where both packages
compute bit-identical logits) and the same numpy images on both sides. On
the CPU a plan is the eager bucket-shaped call (on the card it is a
captured CUDA graph, held by ``tests/test_torch_cuda.py``), so the cache
logic, the clock and the load generator are testable here.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest

from repro import serve as jserve
from repro.core import engine as jengine
from repro.obs import metrics as jmetrics
from repro.serve import bench as jbench
from repro.study import price_record as jprice_record
from repro_torch import serve as tserve
from repro_torch.core import engine as tengine
from repro_torch.core import snn_model as tmodel
from repro_torch.serve import bench as tbench
from repro_torch.study import StatsRecord, price_record

from _torch_nets import dyadic_net, images

SPEC, HW, C = "6C3-P2-8C3-P3-10", 12, 2
BUCKETS = (1, 4, 16)


def _cfg_kw(weight_bits=None):
    return dict(spec=SPEC, input_hw=HW, input_c=C, T=3, depth=4,
                mode="mttfs_cont", input_mode="binary",
                weight_bits=weight_bits)


def _handle(**kw):
    params, th = dyadic_net(SPEC, HW, C)
    return tserve.ModelHandle("h", params, th,
                              tengine.SNNConfig(**_cfg_kw()),
                              backend="dense", device="cpu", **kw)


def _registries(weight_bits=None, vmem_resident=True, *, clocks=None):
    """The same net registered as "m" in both packages' runtimes."""
    params_np, th = dyadic_net(SPEC, HW, C)
    jreg = jserve.ModelRegistry()
    jreg.register("m", [{k: jnp.asarray(v) for k, v in p.items()}
                        for p in params_np],
                  [jnp.asarray(t) for t in th],
                  jengine.SNNConfig(**_cfg_kw(weight_bits)),
                  backend="queue_pallas", vmem_resident=vmem_resident)
    params, ths = tmodel.params_from_numpy(params_np, th, device="cpu")
    treg = tserve.ModelRegistry(device="cpu")
    treg.register("m", params, ths, tengine.SNNConfig(**_cfg_kw(weight_bits)),
                  backend="queue_pallas", vmem_resident=vmem_resident)
    kw = [{}, {}] if clocks is None else [dict(clock=c) for c in clocks]
    return (jserve.ServeRuntime(jreg, jserve.BucketPolicy(BUCKETS), **kw[0]),
            tserve.ServeRuntime(treg, tserve.BucketPolicy(BUCKETS), **kw[1]))


def _assert_same_responses(t_resp, j_resp):
    assert len(t_resp) == len(j_resp)
    for t, j in zip(t_resp, j_resp):
        assert (t.rid, t.pred, t.bucket, t.batch_valid) == (
            j.rid, j.pred, j.bucket, j.batch_valid)
        np.testing.assert_array_equal(t.logits, np.asarray(j.logits))
        for f in StatsRecord._fields:
            np.testing.assert_array_equal(getattr(t.stats, f),
                                          np.asarray(getattr(j.stats, f)))
        assert np.float32(t.energy_j) == np.float32(j.energy_j)


# --- the plan cache (tests/test_serving.py's plan-cache tests) --------------

def test_plan_cache_size_must_be_positive():
    with pytest.raises(ValueError, match="plan_cache_size"):
        tserve.ModelRegistry(plan_cache_size=0, device="cpu")
    with pytest.raises(ValueError, match="plan_cache_size"):
        _handle(plan_cache_size=0)


def test_warmup_compiles_once_per_bucket():
    """Two passes over the ladder, one plan per unique bucket: the cache
    keys on bucket size alone."""
    h = _handle()
    h.warmup((1, 2, 2, 1))
    assert h.compile_count == 2
    assert h.replay_count == {1: 4, 2: 4}


def test_warmup_guard_catches_unstable_plan_cache():
    """If plans stop being cache hits on identical buckets, warmup fails
    loudly instead of serving slowly."""
    h = _handle()
    orig = h.plan_for

    def evicting_plan_for(bucket):  # a cache not keyed on bucket
        h._plans.clear()
        return orig(bucket)

    h.plan_for = evicting_plan_for
    with pytest.raises(tserve.ServeError, match="second pass recompiled"):
        h.warmup((1, 2))


def test_warmup_guard_skips_when_ladder_exceeds_plan_cache():
    """LRU eviction on a ladder longer than the plan cache makes second-pass
    rebuilds legitimate: the guard must not fire there."""
    h = _handle(plan_cache_size=1)
    h.warmup((1, 2))
    assert h.compile_count == 2


def test_plan_cache_lru_bounds_cached_buckets():
    params, th = dyadic_net(SPEC, HW, C)
    reg = tserve.ModelRegistry(plan_cache_size=2, device="cpu")
    h = reg.register("toy", params, th, tengine.SNNConfig(**_cfg_kw()),
                     backend="dense")
    assert h.plan_cache_size == 2
    assert h.plan_for(1) is h.plan_for(1)            # cache hit
    h.plan_for(2)
    h.plan_for(1)                                    # touch: 2 is LRU
    h.plan_for(4)                                    # evicts bucket 2
    assert h.cached_buckets() == (1, 4)
    assert h.compile_count == 3


def test_adopt_plan_is_a_cache_hit():
    """An adopted plan serves its bucket without counting a compilation, so
    the warmup guard holds on a handle whose plans came from elsewhere."""
    h, donor = _handle(), _handle()
    h.adopt_plan(4, donor.plan_for(4))
    assert h.compile_count == 0 and h.cached_buckets() == (4,)
    h.warmup((4,))
    assert h.compile_count == 0
    imgs = images(4, HW, C, seed=2)
    lh, sh = h.run_bucket(imgs, 3)
    ld, sd = donor.run_bucket(imgs, 3)
    np.testing.assert_array_equal(lh.numpy(), ld.numpy())


def test_registration_refuses_backends_that_cannot_be_captured():
    """On the card every served backend is captured in a CUDA graph:
    queue_ref (its oracles size tensors on the host) is refused at
    registration there, with the reason; on the CPU it serves eagerly.
    queue_sparse (host dispatch) is refused everywhere."""
    params, th = dyadic_net(SPEC, HW, C)
    cfg = tengine.SNNConfig(**_cfg_kw())
    with pytest.raises(ValueError, match="cannot be captured in a CUDA "
                                         "graph: its scatter oracles"):
        tserve.ModelHandle("r", params, th, cfg, backend="queue_ref",
                           device="cuda")
    tserve.ModelHandle("r", params, th, cfg, backend="queue_ref",
                       device="cpu")
    with pytest.raises(ValueError, match="host-side occupancy"):
        tserve.ModelHandle("s", params, th, cfg, backend="queue_sparse",
                           device="cpu")
    for name in ("dense", "dense_unrolled", "queue", "queue_pallas"):
        assert tengine.get_backend(name).capture_refusal is None


# --- the runtime's clock and the response breakdown -------------------------

def test_breakdown_telescopes_to_step_total():
    """tests/test_obs.py's telescoping: batch_form + execute + price ==
    step_total, in the reference's waterfall order and keys."""
    _, rt = _registries()
    for im in images(5, HW, C, seed=3):
        rt.submit(im, "m")
    responses = rt.run_until_drained()
    assert len(responses) == 5
    for r in responses:
        b = r.breakdown
        assert list(b) == ["queue_wait_s", "batch_form_s", "execute_s",
                           "price_s"]
        parts = b["batch_form_s"] + b["execute_s"] + b["price_s"]
        assert r.step_total_s > 0
        assert parts == pytest.approx(r.step_total_s, rel=1e-9, abs=1e-9)
        assert 0.0 <= r.pad_fraction < 1.0


def test_virtual_clock_arrivals_and_launch_time():
    """submit(arrival_s=) and step(now=) set the queue wait; every other
    time comes from the injected clock."""
    ticks = iter(range(100, 200))
    _, rt = _registries(clocks=[None, lambda: float(next(ticks))])
    imgs = images(4, HW, C, seed=4)
    rt.submit(imgs[0], "m", arrival_s=1.5)
    rt.submit(imgs[1], "m")                      # arrival: clock() = 100
    rt.submit(imgs[2], "m", arrival_s=50.0)
    resp = sorted(rt.step(now=102.5), key=lambda r: r.rid)
    assert [r.queue_wait_s for r in resp] == [101.0, 2.5, 52.5]
    # four clock reads a step: 101 step start, 102 launch, 103 executed,
    # 104 priced
    assert resp[0].batch_form_s == 1.0 and resp[0].service_s == 1.0
    assert resp[0].price_s == 1.0 and resp[0].step_total_s == 3.0
    rt.submit(imgs[3], "m", arrival_s=104.0)
    (r,) = rt.step()                             # launch at clock() = 106
    assert r.queue_wait_s == 2.0


# --- the load generator against the reference's -----------------------------

def test_percentiles_equal_the_reference_estimator():
    v = np.random.default_rng(0).exponential(3.0, 257)
    assert tbench.percentiles(v) == jmetrics.percentiles(v)
    assert all(np.isnan(x) for x in tbench.percentiles([]).values())


@pytest.mark.parametrize("weight_bits", [None, 8])
def test_closed_loop_matches_reference(weight_bits):
    """Both closed loops on the same images: equal request counts, bucket
    histograms, per-request logits, stats and energies, and energy sums."""
    jrt, trt = _registries(weight_bits)
    imgs = images(23, HW, C, seed=5)     # buckets 16, 4 (7 round down), 4
    j = jbench.closed_loop(jrt, "m", imgs)
    t = tbench.closed_loop(trt, "m", imgs)
    assert t.mode == j.mode == "closed"
    assert t.n_requests == j.n_requests == 23
    assert t.bucket_histogram == j.bucket_histogram == {4: 2, 16: 1}
    _assert_same_responses(t.responses, j.responses)
    assert np.float32(t.energy_sum_j) == np.float32(j.energy_sum_j)
    np.testing.assert_array_equal(tbench.energy_array(t.responses),
                                  jbench.energy_array(j.responses))
    assert set(vars(t)) == set(vars(j))


def _counter(step=1e-3):
    state = {"t": 0.0}

    def clock():
        state["t"] += step
        return state["t"]
    return clock


@pytest.mark.parametrize("rate", [200.0, 2000.0])
def test_open_loop_matches_reference_on_an_injected_clock(monkeypatch, rate):
    """Both open loops with the same counter clock (a fixed step per read)
    in the runtime and in place of the bench modules' perf_counter: the
    same Poisson arrivals meet the same service times, so the bucket
    histograms, the virtual wall and every latency agree exactly."""
    jclock, tclock = _counter(), _counter()
    monkeypatch.setattr(jbench, "time",
                        types.SimpleNamespace(perf_counter=jclock))
    monkeypatch.setattr(tbench, "time",
                        types.SimpleNamespace(perf_counter=tclock))
    jrt, trt = _registries(clocks=[jclock, tclock])
    imgs = images(40, HW, C, seed=6)
    j = jbench.open_loop(jrt, "m", imgs, rate_rps=rate, seed=3)
    t = tbench.open_loop(trt, "m", imgs, rate_rps=rate, seed=3)
    assert t.mode == j.mode == "open"
    assert t.bucket_histogram == j.bucket_histogram
    assert len(t.bucket_histogram) > 1 or rate < 1000
    assert t.wall_s == j.wall_s
    assert (t.latency_p50_s, t.latency_p95_s, t.latency_p99_s) == (
        j.latency_p50_s, j.latency_p95_s, j.latency_p99_s)
    _assert_same_responses(t.responses, j.responses)
    assert [r.latency_s for r in t.responses] == [
        r.latency_s for r in j.responses]


def test_vmem_resident_false_prices_as_the_reference():
    """register(vmem_resident=False) reaches the runtime's pricing: the
    served energies equal the reference's under the same option, the
    one-shot pricing agrees, and they differ from resident pricing."""
    jrt, trt = _registries(vmem_resident=False)
    imgs = images(9, HW, C, seed=7)
    j = jbench.closed_loop(jrt, "m", imgs)
    t = tbench.closed_loop(trt, "m", imgs)
    _assert_same_responses(t.responses, j.responses)
    assert not trt.registry.get("m").vmem_resident
    record = StatsRecord(*(np.concatenate([getattr(r.stats, f)
                                           for r in t.responses])
                           for f in StatsRecord._fields))
    streamed = price_record(record, input_hw=HW, vmem_resident=False)
    np.testing.assert_array_equal(
        streamed.total_j.numpy(),
        np.asarray(jprice_record(record, input_hw=HW,
                                 vmem_resident=False).total_j))
    np.testing.assert_array_equal(tbench.energy_array(t.responses),
                                  streamed.total_j.numpy())
    resident = price_record(record, input_hw=HW).total_j.numpy()
    assert not np.array_equal(resident, streamed.total_j.numpy())
    parity = tbench.verify_energy_parity(trt, "m", imgs, t.responses)
    assert parity["elementwise_bitexact"] and parity["sum_bitexact"]


def test_build_runtime_serves_the_paper_net():
    """build_runtime takes the dataset's net from the port's PAPER_SPECS,
    untrained weights and unit thresholds, warms every bucket, and its
    responses price as a one-shot infer_batch + price_record."""
    cfg = tbench.serve_config("mnist")
    assert cfg.spec == "32C3-32C3-P3-10C3-10" and cfg.depth == 64
    rt, name = tbench.build_runtime(cfg, (1, 4), device="cpu")
    h = rt.registry.get(name)
    assert h.compile_count == 2 and h.cached_buckets() == (1, 4)
    imgs = tbench.request_images("mnist", 6)
    assert imgs.shape == (6, 28, 28, 1)
    res = tbench.closed_loop(rt, name, imgs)
    assert res.bucket_histogram == {4: 1, 1: 2}
    parity = tbench.verify_energy_parity(rt, name, imgs, res.responses)
    assert parity["elementwise_bitexact"] and parity["sum_bitexact"]


def test_bench_cli_runs_on_the_cpu(capsys):
    """``python -m repro_torch.serve.bench --quick --verify --mode both
    --device cpu``: closed loop, energy parity, the B=1 baseline and the
    open loop, with the reference's LoadResult fields in each line."""
    tbench.main(["--quick", "--verify", "--mode", "both", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "'elementwise_bitexact': True, 'sum_bitexact': True" in out
    for tag in ("[      closed]", "[  closed B=1]", "open @"):
        assert tag in out
    assert "device=cpu" in out and "latency p50/p95/p99" in out
