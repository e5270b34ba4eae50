"""The port's dense backends and its default backend against the JAX package.

``dense`` (one conv over all B*T frames) and ``dense_unrolled`` (one conv
per step) keep the reference's stat semantics, which differ from the queue
backends': events_in is every spike, queue_words the uncapped segment
occupancy, add_ops every spike's in-bounds offsets x C_out, and nothing is
dropped — so in the overflow regime (depth 2 here) their logits and stats
differ from ``queue_pallas``'s. The port's ``infer``, ``infer_batch`` and
``infer_batch_masked`` default to ``dense``, as the reference's do.

Dyadic nets (``_torch_nets``): every fp32 sum is exact in any order, so
logits and stats are held bit-exactly; a Gaussian net holds stats exactly
and logits to 1e-4 (the convs sum in another order than XLA's).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import engine as jengine
from repro.core import neuron as jneuron
from repro_torch.core import encoding as tenc
from repro_torch.core import engine as tengine

from _torch_nets import dyadic_net, images

NETS = {  # spec, hw, c: tests/test_torch_engine.py
    "pool2": ("6C3-P2-8C3-P3-10", 12, 2),
    "plain": ("4C3-8C3-P2-6", 8, 1),
}
STAT_FIELDS = ("events_in", "spikes_out", "add_ops", "overflow",
               "queue_words")


def _jax(params, th):
    return ([{k: jnp.asarray(v) for k, v in p.items()} for p in params],
            [jnp.asarray(t) for t in th])


@functools.lru_cache(maxsize=None)
def _reference(net, backend, mode, input_mode, depth, B=16):
    """The JAX engine at B=16; a smaller batch is its prefix (the
    reference's rows are independent)."""
    spec, hw, c = NETS[net]
    params, th = dyadic_net(spec, hw, c)
    cfg = jengine.SNNConfig(spec=spec, input_hw=hw, input_c=c, T=3,
                            mode=mode, depth=depth, input_mode=input_mode)
    lj, sj = jengine.infer_batch(*_jax(params, th), cfg,
                                 jnp.asarray(images(B, hw, c)),
                                 backend=backend)
    return np.asarray(lj), {f: np.asarray(getattr(sj, f))
                            for f in STAT_FIELDS}


def _assert_rows(lt, st, lj, sj, B):
    np.testing.assert_array_equal(lt.numpy(), lj[:B])
    for f in STAT_FIELDS:
        got = getattr(st, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), sj[f][:B], err_msg=f)


@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("input_mode", ["analog", "binary"])
@pytest.mark.parametrize("mode", jneuron.MODES)
@pytest.mark.parametrize("backend", ["dense", "dense_unrolled"])
def test_dense_backends_exact_on_dyadic_net(backend, mode, input_mode, B):
    """Logits and all five stats at depth 2, where overflow is counted but
    nothing is dropped."""
    spec, hw, c = NETS["pool2"]
    params, th = dyadic_net(spec, hw, c)
    cfg = tengine.SNNConfig(spec=spec, input_hw=hw, input_c=c, T=3, mode=mode,
                            depth=2, input_mode=input_mode)
    lt, st = tengine.infer_batch(params, th, cfg, images(16, hw, c)[:B],
                                 backend=backend, device="cpu")
    lj, sj = _reference("pool2", backend, mode, input_mode, 2)
    _assert_rows(lt, st, lj, sj, B)
    assert int(sj["overflow"][:B].sum()) > 0


@pytest.mark.parametrize("depth", [1, 64])
@pytest.mark.parametrize("input_mode", ["analog", "binary"])
def test_dense_exact_unpooled_net(depth, input_mode):
    spec, hw, c = NETS["plain"]
    params, th = dyadic_net(spec, hw, c)
    cfg = tengine.SNNConfig(spec=spec, input_hw=hw, input_c=c, T=3,
                            mode="mttfs", depth=depth, input_mode=input_mode)
    lt, st = tengine.infer_batch(params, th, cfg, images(5, hw, c),
                                 device="cpu")
    lj, sj = _reference("plain", "dense", "mttfs", input_mode, depth, B=5)
    _assert_rows(lt, st, lj, sj, 5)


def test_dense_gaussian_net_stats_and_logits():
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
    imgs = rng.random((4, hw, hw, c)).astype(np.float32)
    for input_mode in ("analog", "binary"):
        kw = dict(spec=spec, input_hw=hw, input_c=c, T=3, mode="mttfs_cont",
                  depth=8, input_mode=input_mode)
        lj, sj = jengine.infer_batch(*_jax(params, th),
                                     jengine.SNNConfig(**kw),
                                     jnp.asarray(imgs), backend="dense")
        lt, st = tengine.infer_batch(params, th, tengine.SNNConfig(**kw),
                                     imgs, device="cpu")
        for f in STAT_FIELDS:
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(sj, f)))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("hw,K", [(12, 3), (10, 3), (9, 3), (8, 5), (7, 1)])
def test_dense_stat_helpers_match_reference(hw, K):
    np.testing.assert_array_equal(
        tengine._valid_offsets_map(hw, K).numpy(),
        np.asarray(jengine._valid_offsets_map(hw, K)).astype(np.int32))
    rng = np.random.default_rng(hw)
    raster = (rng.random((3, hw, hw, 4)) < 0.3).astype(np.float32)
    fj, ft = jenc.make_format(hw, K), tenc.make_format(hw, K)
    np.testing.assert_array_equal(
        tengine._segment_occupancy(ft, torch.from_numpy(raster)).numpy(),
        np.asarray(jengine._segment_occupancy(fj, jnp.asarray(raster))))


def test_default_backend_agrees_with_reference_in_overflow():
    """The repaired fault: both packages' default ``infer_batch`` at depth 2
    (binary input, B=4) give equal stats and logits. With the old default
    (queue_pallas) the port dropped events the reference only counts."""
    spec, hw, c = NETS["pool2"]
    params, th = dyadic_net(spec, hw, c)
    imgs = (np.random.default_rng(0).random((4, hw, hw, c))
            < 0.5).astype(np.float32)
    kw = dict(spec=spec, input_hw=hw, input_c=c, T=3, depth=2,
              input_mode="binary")
    lj, sj = jengine.infer_batch(*_jax(params, th), jengine.SNNConfig(**kw),
                                 jnp.asarray(imgs))
    lt, st = tengine.infer_batch(params, th, tengine.SNNConfig(**kw), imgs,
                                 device="cpu")
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    _, sq = tengine.infer_batch(params, th, tengine.SNNConfig(**kw), imgs,
                                backend="queue_pallas", device="cpu")
    assert (sq.overflow < st.overflow).all()    # queue_pallas drops


def test_default_infer_and_masked_are_dense():
    spec, hw, c = NETS["pool2"]
    params, th = dyadic_net(spec, hw, c)
    cfg = tengine.SNNConfig(spec=spec, input_hw=hw, input_c=c, T=3, depth=2,
                            input_mode="binary")
    imgs = images(4, hw, c, seed=3)
    want = tengine.infer_batch(params, th, cfg, imgs, backend="dense",
                               device="cpu")
    masked = tengine.infer_batch_masked(params, th, cfg, imgs, 4,
                                        device="cpu")
    assert torch.equal(masked[0], want[0])
    one = tengine.infer(params, th, cfg, imgs[1], device="cpu")
    assert torch.equal(one[0], want[0][1])
    for a, b, c1 in zip(masked[1], want[1], one[1]):
        assert torch.equal(a, b) and torch.equal(c1, b[1])


@pytest.mark.parametrize("backend", ["dense", "dense_unrolled"])
@pytest.mark.parametrize("n_valid", [1, 3])
def test_dense_mask_contract_padded_equals_unpadded(backend, n_valid):
    spec, hw, c = NETS["pool2"]
    params, th = dyadic_net(spec, hw, c)
    cfg = tengine.SNNConfig(spec=spec, input_hw=hw, input_c=c, T=3,
                            mode="mttfs", depth=4, input_mode="binary",
                            weight_bits=8)
    imgs = images(4, hw, c, seed=2)
    padded = imgs.copy()
    padded[n_valid:] = images(4, hw, c, seed=7)[n_valid:]
    lp, sp = tengine.infer_batch_masked(params, th, cfg, padded, n_valid,
                                        backend=backend, device="cpu")
    lu, su = tengine.infer_batch(params, th, cfg, imgs[:n_valid],
                                 backend=backend, device="cpu")
    assert torch.equal(lp, lu)
    for f in STAT_FIELDS:
        assert torch.equal(getattr(sp, f), getattr(su, f)), f
