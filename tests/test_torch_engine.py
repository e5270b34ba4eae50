"""The port's ``infer_batch`` (queue_pallas) against the JAX engine's.

Dyadic weights, biases, thresholds and images (multiples of 2^-8 / 2^-4)
make every fp32 sum exact in any order, so logits and all five stats must
match the reference EXACTLY — across every neuron mode, both input
encodings, B in {1, 3, 16}, fp32 and the int8 head, and an overflowing
depth. The int8 head's dense weights are chosen with max |w| = 127 * 2^-8,
so the quantization scale is a power of two too and the dequantized logits
are exact. A Gaussian-weight case holds per-layer charges to 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import neuron as jneuron
from repro.kernels import ops as jops
from repro_torch.core import engine as tengine
from repro_torch.core import snn_model as tmodel
from repro_torch.kernels import ops as tops

from _torch_nets import dyadic_net, images

NETS = {  # spec, hw, c
    "pool2": ("6C3-P2-8C3-P3-10", 12, 2),
    "plain": ("4C3-8C3-P2-6", 8, 1),
}
STAT_FIELDS = ("events_in", "spikes_out", "add_ops", "overflow",
               "queue_words")


def run_both(params, th, cfg_kw, imgs):
    jcfg = jengine.SNNConfig(**cfg_kw)
    lj, sj = jengine.infer_batch(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        [jnp.asarray(t) for t in th], jcfg, jnp.asarray(imgs),
        backend="queue_pallas")
    lt, st = tengine.infer_batch(params, th, tengine.SNNConfig(**cfg_kw),
                                 imgs, device="cpu")
    return (np.asarray(lj), sj), (lt.numpy(), st)


def assert_stats_equal(st, sj):
    for f in STAT_FIELDS:
        got = getattr(st, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(sj, f)),
                                      err_msg=f)


@pytest.mark.parametrize("weight_bits", [None, 8])
@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("input_mode", ["analog", "binary"])
@pytest.mark.parametrize("mode", jneuron.MODES)
def test_infer_batch_exact_on_dyadic_net(mode, input_mode, B, weight_bits):
    spec, hw, c = NETS["pool2"]
    params, th = dyadic_net(spec, hw, c)
    cfg_kw = dict(spec=spec, input_hw=hw, input_c=c, T=3, mode=mode,
                  depth=2, input_mode=input_mode, weight_bits=weight_bits)
    (lj, sj), (lt, st) = run_both(params, th, cfg_kw, images(B, hw, c))
    np.testing.assert_array_equal(lt, lj)
    assert_stats_equal(st, sj)
    assert int(np.asarray(sj.overflow).sum()) > 0   # depth 2 overflows


@pytest.mark.parametrize("depth", [1, 64])
@pytest.mark.parametrize("input_mode", ["analog", "binary"])
def test_infer_batch_exact_unpooled_net(depth, input_mode):
    spec, hw, c = NETS["plain"]
    params, th = dyadic_net(spec, hw, c, seed=3)
    cfg_kw = dict(spec=spec, input_hw=hw, input_c=c, T=3, mode="mttfs",
                  depth=depth, input_mode=input_mode)
    (lj, sj), (lt, st) = run_both(params, th, cfg_kw, images(5, hw, c, 4))
    np.testing.assert_array_equal(lt, lj)
    assert_stats_equal(st, sj)


def test_gaussian_weights_charges_within_tolerance():
    """Gaussian weights: given the same input raster, each layer's fused
    charge matches the reference to 1e-4 (summation order differs)."""
    spec, hw, c = NETS["pool2"]
    rng = np.random.default_rng(9)
    plan = jengine.compile_plan(spec, hw, c)
    for cp in plan.convs:
        raster = (rng.random((4, 3, cp.in_hw, cp.in_hw, cp.in_c))
                  < 0.3).astype(np.float32)
        w = rng.normal(size=(3, 3, cp.in_c, cp.out_c)).astype(np.float32)
        occ_j = jengine.phase_occupancy(cp.fmt, jnp.asarray(raster))
        occ_t = tengine.phase_occupancy(cp.fmt, torch.from_numpy(raster))
        np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
        kw = dict(K=3, n_win=cp.fmt.n_win, bits=cp.fmt.bits_coord, depth=4,
                  H=cp.in_hw, W=cp.in_hw)
        want = jops.fused_spike_accum(occ_j.reshape(12, cp.in_c, 9, -1),
                                      jnp.asarray(w), impl="xla", **kw)
        got = tops.fused_spike_accum(occ_t.reshape(12, cp.in_c, 9, -1),
                                     torch.from_numpy(w), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def test_gaussian_net_stats_and_logits():
    """Gaussian init: the integer stats still match exactly and the logits
    to 1e-4 (spikes away from the threshold are order-independent)."""
    spec, hw, c = NETS["pool2"]
    rng = np.random.default_rng(5)
    plan = jengine.compile_plan(spec, hw, c)
    params = [{} for _ in range(plan.n_layers)]
    for cp in plan.convs:
        params[cp.index] = {
            "w": rng.normal(0, 0.5, (3, 3, cp.in_c, cp.out_c)),
            "b": np.full(cp.out_c, 0.05)}
    params[plan.out.index] = {"w": rng.normal(size=(plan.out.n_in, 10)),
                              "b": np.zeros(10)}
    params = [{k: v.astype(np.float32) for k, v in p.items()} for p in params]
    th = [np.float32(1.0)] * plan.n_layers
    cfg_kw = dict(spec=spec, input_hw=hw, input_c=c, T=3, mode="mttfs_cont",
                  depth=8, input_mode="binary")
    (lj, sj), (lt, st) = run_both(params, th, cfg_kw,
                                  rng.random((4, hw, hw, c)).astype(np.float32))
    assert_stats_equal(st, sj)
    np.testing.assert_allclose(lt, lj, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n_valid", [1, 3, 4])
def test_mask_contract_padded_equals_unpadded(n_valid):
    spec, hw, c = NETS["pool2"]
    params, th = dyadic_net(spec, hw, c)
    cfg = tengine.SNNConfig(spec=spec, input_hw=hw, input_c=c, T=3,
                            mode="mttfs", depth=4, input_mode="binary",
                            weight_bits=8)
    imgs = images(4, hw, c, seed=2)
    padded = imgs.copy()
    padded[n_valid:] = images(4, hw, c, seed=7)[n_valid:]   # junk padding
    lp, sp = tengine.infer_batch_masked(params, th, cfg, padded, n_valid,
                                        device="cpu")
    lu, su = tengine.infer_batch(params, th, cfg, imgs[:n_valid],
                                 device="cpu")
    assert torch.equal(lp, lu)
    for f in STAT_FIELDS:
        assert torch.equal(getattr(sp, f), getattr(su, f)), f


def test_slice_valid_rejects_bad_prefix():
    logits = torch.zeros((4, 10))
    stats = tengine.SNNStats(*(torch.zeros((4, 2), dtype=torch.int32),) * 5)
    for bad in (0, 5, 2.0):
        with pytest.raises(ValueError, match="n_valid"):
            tengine.slice_valid(logits, stats, bad)


def test_entry_points_refuse_cpu_without_request(monkeypatch):
    """With no GPU, an entry point called without device='cpu' raises
    instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, hw, c = NETS["plain"]
    params, th = dyadic_net(spec, hw, c)
    cfg = tengine.SNNConfig(spec=spec, input_hw=hw, input_c=c, T=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.infer_batch(params, th, cfg, images(1, hw, c))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.init_params(torch.Generator().manual_seed(0), spec, hw, c)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.params_from_numpy(params, th)


def test_init_params_layout_and_bridge():
    spec, hw, c = "32C3-32C3-P3-64C3-64C3-P3-128C3-128C3-128C3-10", 32, 3
    p1 = tmodel.init_params(torch.Generator().manual_seed(0), spec, hw, c,
                            device="cpu")
    p2 = tmodel.init_params(torch.Generator().manual_seed(0), spec, hw, c,
                            device="cpu")
    assert tmodel.count_params(p1) == 446122     # paper Table 6
    assert all(torch.equal(a[k], b[k]) for a, b in zip(p1, p2) for k in a)
    assert p1[0]["w"].shape == (3, 3, 3, 32) and p1[-1]["w"].shape == (1152, 10)
    params_np = [{k: v.numpy() for k, v in layer.items()} for layer in p1]
    bridged, ths = tmodel.params_from_numpy(params_np, [1.0] * len(p1),
                                            device="cpu")
    assert all(torch.equal(a[k], b[k]) for a, b in zip(p1, bridged) for k in a)
    assert all(t.dtype == torch.float32 and t.dim() == 0 for t in ths)


def test_unknown_backend_and_mode_list_registered():
    with pytest.raises(ValueError, match="queue_pallas"):
        tengine.get_backend("dense")
    spec, hw, c = NETS["plain"]
    params, th = dyadic_net(spec, hw, c)
    cfg = tengine.SNNConfig(spec=spec, input_hw=hw, input_c=c, mode="nope")
    with pytest.raises(ValueError, match="mttfs"):
        tengine.infer_batch(params, th, cfg, images(1, hw, c), device="cpu")


def test_quant_head_differs_from_reference_fma_by_at_most_one_ulp():
    """With an int8 scale that is not a power of two, XLA contracts the
    reference head's dequant and bias add into one FMA; the port rounds
    twice (as ``quant_matmul_ref`` does). Stats stay exact; the logits
    differ, by at most 1 ulp of the batch's largest |logit| (ROADMAP C)."""
    spec, hw, c = NETS["pool2"]
    params, th = dyadic_net(spec, hw, c)
    params[-1]["w"] = params[-1]["w"] * np.float32(0.7)
    cfg_kw = dict(spec=spec, input_hw=hw, input_c=c, T=3, mode="mttfs",
                  depth=2, input_mode="binary", weight_bits=8)
    (lj, sj), (lt, st) = run_both(params, th, cfg_kw, images(16, hw, c))
    assert_stats_equal(st, sj)
    diff = np.abs(lt - lj)
    assert diff.max() > 0                       # the divergence is real here
    assert diff.max() <= np.spacing(np.abs(lj).max())


def test_fp32_head_rows_independent_of_batch():
    """The fp32 head multiplies fixed 256-row tiles, so row i's logits are
    the same bits whether it comes in a batch of 1, 33 or 64 (Gaussian
    weights at the CIFAR-10 head's shape, F=1152, N=10, T=4)."""
    rng = np.random.default_rng(12)
    raster = torch.from_numpy(
        (rng.random((64, 4, 3, 3, 128)) < 0.3).astype(np.float32))
    params_out = {"w": torch.from_numpy(
                      rng.normal(size=(1152, 10)).astype(np.float32)),
                  "b": torch.from_numpy(
                      rng.normal(size=10).astype(np.float32))}
    full, _ = tengine._output_layer_batch(params_out, 4, raster)
    for B in (1, 33):
        part, _ = tengine._output_layer_batch(params_out, 4, raster[:B])
        assert torch.equal(part, full[:B]), B
    # the same product per time step, then the sum over T
    want = (raster.reshape(64, 4, -1) @ params_out["w"]).sum(1) \
        + params_out["b"] * 4
    torch.testing.assert_close(full, want, atol=1e-4, rtol=1e-5)
