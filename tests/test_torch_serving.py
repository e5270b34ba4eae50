"""The port's ServeRuntime against the JAX one, on the same requests/weights.

Weights travel through the weight bridge (``snn_model.params_from_numpy``).
Both runtimes bucket identically, so every response must carry the same
prediction, logits, stats row and bucket; per-request energies must be
equal as float32 (pricing is plain elementwise float32 arithmetic in both).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core import engine as jengine
from repro.study import price_record as jprice_record
from repro_torch import serve as tserve
from repro_torch.core import engine as tengine
from repro_torch.core import snn_model as tmodel
from repro_torch.kernels import ops as tops
from repro_torch.study import StatsRecord, price_record

from _torch_nets import dyadic_net, images

SPEC, HW, C = "6C3-P2-8C3-P3-10", 12, 2
BUCKETS = (1, 4, 16)


def _cfg_kw(weight_bits):
    return dict(spec=SPEC, input_hw=HW, input_c=C, T=3, depth=4,
                mode="mttfs_cont", input_mode="binary",
                weight_bits=weight_bits)


def _serve(serve_mod, registry, imgs):
    rt = serve_mod.ServeRuntime(registry, serve_mod.BucketPolicy(BUCKETS))
    for im in imgs:
        rt.submit(im, "m")
    return sorted(rt.run_until_drained(), key=lambda r: r.rid), rt


@pytest.mark.parametrize("weight_bits", [None, 8])
def test_serve_runtime_matches_reference(weight_bits):
    params_np, th = dyadic_net(SPEC, HW, C)
    imgs = images(23, HW, C, seed=3)        # buckets 16, 4 (7 round down), 4

    jreg = jserve.ModelRegistry()
    jreg.register("m", [{k: jnp.asarray(v) for k, v in p.items()}
                        for p in params_np],
                  [jnp.asarray(t) for t in th],
                  jengine.SNNConfig(**_cfg_kw(weight_bits)),
                  backend="queue_pallas")
    params, ths = tmodel.params_from_numpy(params_np, th, device="cpu")
    treg = tserve.ModelRegistry(device="cpu")
    treg.register("m", params, ths, tengine.SNNConfig(**_cfg_kw(weight_bits)),
                  backend="queue_pallas")

    tops.reset_launch_counts()
    jresp, _ = _serve(jserve, jreg, imgs)
    tresp, trt = _serve(tserve, treg, imgs)
    assert tops.launch_counts == {"fused_spike_accum": 0, "quant_matmul": 0,
                                  "fused_spike_accum_sparse": 0}

    assert len(tresp) == len(jresp) == len(imgs)
    for t, j in zip(tresp, jresp):
        assert (t.rid, t.pred, t.bucket, t.batch_valid) == (
            j.rid, j.pred, j.bucket, j.batch_valid)
        np.testing.assert_array_equal(t.logits, np.asarray(j.logits))
        for f in StatsRecord._fields:
            np.testing.assert_array_equal(getattr(t.stats, f),
                                          np.asarray(getattr(j.stats, f)))
        assert np.float32(t.energy_j) == np.float32(j.energy_j)
        assert np.float32(t.model_latency_s) == np.float32(j.model_latency_s)
    assert trt.stats_summary()["bucket_histogram"] == {4: 2, 16: 1}


def test_per_request_energy_sums_to_one_shot_pricing():
    params_np, th = dyadic_net(SPEC, HW, C)
    imgs = images(9, HW, C, seed=4)
    cfg = tengine.SNNConfig(**_cfg_kw(8))
    reg = tserve.ModelRegistry(device="cpu")
    reg.register("m", params_np, th, cfg)
    resp, _ = _serve(tserve, reg, imgs)

    _, stats = tengine.infer_batch(params_np, th, cfg, imgs, device="cpu")
    record = StatsRecord(*(getattr(stats, f).numpy()
                           for f in StatsRecord._fields))
    one_shot = price_record(record, input_hw=HW).total_j.numpy()
    served = np.array([r.energy_j for r in resp], np.float32)
    np.testing.assert_array_equal(served, one_shot)
    assert served.sum() == one_shot.sum()
    ref = np.asarray(jprice_record(record, input_hw=HW).total_j)
    np.testing.assert_array_equal(one_shot, ref)


@pytest.mark.parametrize("bucket,n_valid", [(4, 1), (4, 3), (16, 9)])
def test_padded_bucket_equals_unpadded(bucket, n_valid):
    params_np, th = dyadic_net(SPEC, HW, C)
    reg = tserve.ModelRegistry(device="cpu")
    handle = reg.register("m", params_np, th,
                          tengine.SNNConfig(**_cfg_kw(8)))
    imgs = images(n_valid, HW, C, seed=6)
    padded = tserve.BucketPolicy(BUCKETS).pad(imgs, bucket)
    lp, sp = handle.run_bucket(padded, n_valid)
    lu, su = handle.run_bucket(imgs, n_valid)
    assert torch.equal(lp, lu)
    for a, b in zip(sp, su):
        assert torch.equal(a, b)


def test_registry_requires_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.ModelRegistry()


def test_submit_validates_shape_and_model():
    params_np, th = dyadic_net(SPEC, HW, C)
    reg = tserve.ModelRegistry(device="cpu")
    reg.register("m", params_np, th, tengine.SNNConfig(**_cfg_kw(None)))
    rt = tserve.ServeRuntime(reg)
    with pytest.raises(tserve.ServeError, match="expects image shape"):
        rt.submit(np.zeros((HW, HW, C + 1), np.float32), "m")
    with pytest.raises(tserve.ServeError, match="unknown model"):
        rt.submit(np.zeros((HW, HW, C), np.float32), "other")
