"""The port's occupancy-gated sparse slice against the JAX package.

Mirrors ``tests/test_sparse.py`` with the same numpy-seeded inputs on both
sides. The JAX side runs as XLA on the CPU: the event-list realization
``fused_spike_accum_sparse`` (impl ``"sparse"``), the quantized scatter
oracle, and the engine backends ``queue_sparse`` / ``queue_ref``. On the CPU
the port's ``kernels.ops`` runs the plain event list; the CUDA kernel is
held against it on the card by ``tests/test_torch_cuda.py``.

Tolerances: the plain event list adds into each output in the oracle's
order, as the JAX one does, and ``index_add_`` on the CPU adds in index
order, so every comparison here is bit-exact, on Gaussian weights too.
The engine comparisons use the dyadic nets of ``_torch_nets`` (every fp32
sum exact in any order, a power-of-two int8 head scale).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aeq as jaeq
from repro.core import encoding as jenc
from repro.core import engine as jengine
from repro.core import neuron as jneuron
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import spike_sparse as jss
from repro_torch import serve as tserve
from repro_torch.core import engine as tengine
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import spike_sparse as tss

from _torch_nets import dyadic_net, images

SPEC, HW, C = "6C3-P2-4C3-8", 10, 1
STAT_FIELDS = ("events_in", "spikes_out", "add_ops", "overflow",
               "queue_words")
SHAPES = [(9, 1, 8, 16), (12, 3, 16, 4), (28, 4, 32, 64), (10, 2, 8, 2)]
QUANT_SHAPES = [(9, 1, 8, 16), (12, 3, 16, 4), (10, 2, 8, 2)]


def _occupancy(hw, c_in, n, seed, p_fire=0.25):
    """Random (N, C, K2, P) occupancy via the reference's phase split."""
    rng = np.random.default_rng(seed)
    raster = (rng.random((n, hw, hw, c_in)) < p_fire).astype(np.float32)
    fmt = jenc.make_format(hw, 3)
    return fmt, np.array(jaeq.phase_occupancy(fmt, jnp.asarray(raster)))


def _weights(c_in, c_out, dyadic, seed=1):
    rng = np.random.default_rng(seed)
    if dyadic:
        w = rng.integers(-128, 128, (3, 3, c_in, c_out)) / 256.0
    else:
        w = rng.normal(size=(3, 3, c_in, c_out))
    return w.astype(np.float32)


def _kw(fmt, hw, depth):
    return dict(K=3, n_win=fmt.n_win, depth=depth, H=hw, W=hw)


def _gate(occ, depth):
    """The dispatcher's occupancy gate, computed by the port."""
    t_occ = torch.from_numpy(occ)
    return tss.event_bucket(int(tss.kept_event_count(t_occ, depth=depth)),
                            tss.max_kept_events(occ.shape, depth))


def _both_sparse(occ, w, fmt, hw, depth, e_cap, weight_bits=None):
    kw = _kw(fmt, hw, depth)
    want = np.asarray(jops.fused_spike_accum(
        jnp.asarray(occ), jnp.asarray(w), impl="sparse", e_cap=e_cap,
        weight_bits=weight_bits, bits=fmt.bits_coord,
        invalid=fmt.invalid_word, **kw))
    got = tops.fused_spike_accum(
        torch.from_numpy(occ), torch.from_numpy(w), impl="sparse",
        e_cap=e_cap, weight_bits=weight_bits, bits=fmt.bits_coord, **kw)
    return got.numpy(), want


# ---------------------------------------------------------------------------
# The occupancy-gate helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,cap", [(0, 4096), (1, 4096), (3, 4096),
                                   (129, 4096), (10**9, 4096), (5, 0)])
def test_event_bucket_matches_reference(n, cap):
    assert tss.event_bucket(n, cap) == jss.event_bucket(n, cap)


def test_max_kept_and_kept_event_count_match_reference():
    for shape, depth in [((2, 3, 9, 16), 4), ((2, 3, 9, 16), 64)]:
        assert (tss.max_kept_events(shape, depth)
                == jss.max_kept_events(shape, depth))
    for depth in (1, 2, 16, 64):
        _, occ = _occupancy(12, 2, 3, seed=depth)
        got = tss.kept_event_count(torch.from_numpy(occ), depth=depth)
        assert got.dtype == torch.int32
        assert int(got) == int(jss.kept_event_count(jnp.asarray(occ),
                                                    depth=depth))


# ---------------------------------------------------------------------------
# The plain event list against the JAX event list and the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,c_in,c_out,depth", SHAPES)
@pytest.mark.parametrize("dyadic", [True, False])
def test_sparse_plain_matches_reference(hw, c_in, c_out, depth, dyadic):
    """Bit-exact against JAX ``fused_spike_accum_sparse`` and the torch
    scatter oracle, on dyadic and Gaussian weights; covers depth < P drops
    and the uncompressed hw=10 word format."""
    fmt, occ = _occupancy(hw, c_in, 3, seed=hw * depth)
    w = _weights(c_in, c_out, dyadic)
    got, want = _both_sparse(occ, w, fmt, hw, depth, _gate(occ, depth))
    np.testing.assert_array_equal(got, want)
    oracle = tref.fused_spike_accum_ref(torch.from_numpy(occ),
                                        torch.from_numpy(w),
                                        **_kw(fmt, hw, depth))
    np.testing.assert_array_equal(got, oracle.numpy())


@pytest.mark.parametrize("rate", [0.0, 1.0])
@pytest.mark.parametrize("depth", [3, 64])
def test_sparse_plain_edge_rates(rate, depth):
    """All-zero occupancy (e_cap 1, exact zeros) and saturated occupancy
    (every queue full; depth 3 drops on every segment)."""
    hw, c_in, c_out = 9, 2, 8
    fmt, occ = _occupancy(hw, c_in, 2, seed=7, p_fire=rate)
    e_cap = _gate(occ, depth)
    assert e_cap == (1 if rate == 0.0
                     else tss.max_kept_events(occ.shape, depth))
    got, want = _both_sparse(occ, _weights(c_in, c_out, False), fmt, hw,
                             depth, e_cap)
    np.testing.assert_array_equal(got, want)
    if rate == 0.0:
        assert not got.any()


def test_sparse_plain_exact_e_cap_and_bucketing_equivalent():
    """Any e_cap >= the kept count gives the same answer: the exact
    (non-power-of-two) budget, the bucketed one and the worst case."""
    fmt, occ = _occupancy(12, 2, 2, seed=5)
    w = _weights(2, 8, False)
    kept = int(tss.kept_event_count(torch.from_numpy(occ), depth=16))
    assert kept > 0 and kept & (kept - 1) != 0
    outs = []
    for cap in (kept, _gate(occ, 16), tss.max_kept_events(occ.shape, 16)):
        got, want = _both_sparse(occ, w, fmt, 12, 16, cap)
        np.testing.assert_array_equal(got, want)
        outs.append(got)
    for other in outs[1:]:
        np.testing.assert_array_equal(outs[0], other)


@pytest.mark.parametrize("hw,c_in,c_out,depth", QUANT_SHAPES)
def test_sparse_plain_quant_matches_quant_ref(hw, c_in, c_out, depth):
    """weight_bits=8: the plain event list and the torch quant oracle equal
    JAX ``fused_spike_accum_quant_ref`` bit for bit, and differ from the
    fp32 result (the quantization ran)."""
    fmt, occ = _occupancy(hw, c_in, 2, seed=hw + depth)
    w = _weights(c_in, c_out, False)
    kw = _kw(fmt, hw, depth)
    want = np.asarray(jref.fused_spike_accum_quant_ref(
        jnp.asarray(occ), jnp.asarray(w), weight_bits=8, **kw))
    got, _ = _both_sparse(occ, w, fmt, hw, depth, _gate(occ, depth),
                          weight_bits=8)
    np.testing.assert_array_equal(got, want)
    oracle = tops.fused_spike_accum(torch.from_numpy(occ),
                                    torch.from_numpy(w), impl="ref",
                                    weight_bits=8, bits=fmt.bits_coord, **kw)
    np.testing.assert_array_equal(oracle.numpy(), want)
    fp32 = tref.fused_spike_accum_ref(torch.from_numpy(occ),
                                      torch.from_numpy(w), **kw)
    assert not np.array_equal(got, fp32.numpy())


def test_dispatch_errors():
    """The sparse route needs e_cap on the CPU; the fused route has no
    int-quantized accumulate; unknown impls and CPU tensors handed to the
    kernel wrapper raise."""
    fmt, occ = _occupancy(9, 1, 1, seed=0)
    t_occ, t_w = torch.from_numpy(occ), torch.from_numpy(_weights(1, 4, True))
    kw = dict(bits=fmt.bits_coord, **_kw(fmt, 9, 16))
    with pytest.raises(ValueError, match="e_cap"):
        tops.fused_spike_accum(t_occ, t_w, impl="sparse", **kw)
    with pytest.raises(ValueError, match="int-quantized"):
        tops.fused_spike_accum(t_occ, t_w, weight_bits=8, **kw)
    with pytest.raises(ValueError, match="impl"):
        tops.fused_spike_accum(t_occ, t_w, impl="sparse_pallas", **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tss.fused_spike_accum_sparse_cuda(t_occ, t_w, **kw)


# ---------------------------------------------------------------------------
# Engine level: queue_sparse and queue_ref against the JAX backends
# ---------------------------------------------------------------------------

def _run_both(backend, cfg_kw, imgs, params=None, th=None):
    if params is None:
        params, th = dyadic_net(SPEC, HW, C)
    lj, sj = jengine.infer_batch(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        [jnp.asarray(t) for t in th], jengine.SNNConfig(**cfg_kw),
        jnp.asarray(imgs), backend=backend)
    lt, st = tengine.infer_batch(params, th, tengine.SNNConfig(**cfg_kw),
                                 imgs, backend=backend, device="cpu")
    return (np.asarray(lj), sj), (lt.numpy(), st)


def _assert_same(j, t):
    (lj, sj), (lt, st) = j, t
    np.testing.assert_array_equal(lt, lj)
    for f in STAT_FIELDS:
        got = getattr(st, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(sj, f)),
                                      err_msg=f)


def _cfg(**kw):
    base = dict(spec=SPEC, input_hw=HW, input_c=C, T=3, mode="mttfs_cont",
                depth=64, input_mode="binary")
    return {**base, **kw}


@pytest.mark.parametrize("backend", ["queue_sparse", "queue_ref"])
@pytest.mark.parametrize("input_mode", ["analog", "binary"])
@pytest.mark.parametrize("mode", jneuron.MODES)
def test_engine_backend_matches_reference_all_modes(backend, mode,
                                                    input_mode):
    _assert_same(*_run_both(backend, _cfg(mode=mode, input_mode=input_mode),
                            images(3, HW, C)))


@pytest.mark.parametrize("backend", ["queue_sparse", "queue_ref"])
@pytest.mark.parametrize("B", [1, 3, 16])
def test_engine_backend_matches_reference_batch_sizes(backend, B):
    _assert_same(*_run_both(backend, _cfg(), images(B, HW, C, seed=4)))


@pytest.mark.parametrize("backend", ["queue_sparse", "queue_ref"])
def test_engine_backend_matches_reference_overflow_regime(backend):
    """depth=2 forces drops; both packages drop the same events."""
    j, t = _run_both(backend, _cfg(depth=2), images(3, HW, C, seed=5))
    assert int(t[1].overflow.sum()) > 0
    _assert_same(j, t)


@pytest.mark.parametrize("backend", ["queue_sparse", "queue_ref"])
@pytest.mark.parametrize("input_mode", ["analog", "binary"])
def test_engine_backend_matches_reference_weight_bits(backend, input_mode):
    """weight_bits=8 runs in the conv stages and the head, exactly as in
    the reference, and changes the logits against fp32."""
    params, th = dyadic_net(SPEC, HW, C, seed=2)
    imgs = images(3, HW, C, seed=6)
    cfg = _cfg(input_mode=input_mode, weight_bits=8)
    j, t = _run_both(backend, cfg, imgs, params, th)
    _assert_same(j, t)
    lf, _ = tengine.infer_batch(params, th,
                                tengine.SNNConfig(**_cfg(input_mode=input_mode)),
                                imgs, backend=backend, device="cpu")
    assert not np.array_equal(t[0], lf.numpy())


def test_queue_sparse_equals_queue_ref_and_queue_pallas():
    """In the port itself: queue_sparse == queue_ref (fp32 and w8) and, on
    fp32, == queue_pallas on a dyadic net."""
    params, th = dyadic_net(SPEC, HW, C, seed=3)
    imgs = images(5, HW, C, seed=8)
    for wb in (None, 8):
        cfg = tengine.SNNConfig(**_cfg(weight_bits=wb, depth=4))
        runs = {be: tengine.infer_batch(params, th, cfg, imgs, backend=be,
                                        device="cpu")
                for be in ("queue_sparse", "queue_ref", "queue_pallas")}
        anchors = ("queue_ref", "queue_pallas") if wb is None else \
            ("queue_ref",)
        ls, ss_ = runs["queue_sparse"]
        for be in anchors:
            lr, sr = runs[be]
            assert torch.equal(ls, lr), be
            assert all(torch.equal(a, b) for a, b in zip(ss_, sr)), be


def test_queue_sparse_mask_contract_3_vs_8():
    """Padding the batch changes the gates but not the valid rows."""
    params, th = dyadic_net(SPEC, HW, C)
    cfg = tengine.SNNConfig(**_cfg())
    imgs = images(8, HW, C, seed=9)
    l3, s3 = tengine.infer_batch(params, th, cfg, imgs[:3],
                                 backend="queue_sparse", device="cpu")
    l8, s8 = tengine.infer_batch_masked(params, th, cfg, imgs, 3,
                                        backend="queue_sparse", device="cpu")
    assert torch.equal(l3, l8)
    for f in STAT_FIELDS:
        assert torch.equal(getattr(s3, f), getattr(s8, f)), f


def test_backends_registered_and_flagged():
    assert tengine.available_backends() == ("queue_pallas", "queue_ref",
                                            "queue_sparse")
    assert tengine.get_backend("queue_sparse").host_dispatch is True
    for name in ("queue_pallas", "queue_ref"):
        assert not getattr(tengine.get_backend(name), "host_dispatch", False)
    with pytest.raises(ValueError, match="accum"):
        tengine.QueueBackend(accum="jax")


def test_serve_refuses_host_dispatch_backend():
    """Mirrors the reference: serving stays on queue_pallas."""
    params, th = dyadic_net(SPEC, HW, C)
    cfg = tengine.SNNConfig(**_cfg(T=2))
    reg = tserve.ModelRegistry(device="cpu")
    with pytest.raises(ValueError, match="AOT"):
        reg.register("m", params, th, cfg, backend="queue_sparse")
    assert "m" not in reg
