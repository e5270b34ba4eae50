"""The port's parameters-in slice against the JAX package, on the CPU:
quantization, the CNN baseline (forward, costs, a training step, AdamW),
CNN and static SNN pricing, the FPGA model, and ANN->SNN conversion.

Inputs are numpy arrays made from seeds and the reference's own trained
params (its ``study.train`` of the small nets below); the JAX side runs
with ``JAX_PLATFORMS=cpu`` through its XLA paths. Tolerances are stated
per test. One recorded difference: on the CPU, XLA's conv of a 1-channel
input and its dense product round differently from ``F.conv2d`` / a torch
matmul (a few ulps), so conversion's percentiles are held bit-equal on
equal activations, and the end-to-end lambdas bit-equal where the two
packages' activations are equal and to the forward's tolerance elsewhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import study as jstudy
from repro.configs import PAPER_SPECS
from repro.core import cnn_baseline as jcnn
from repro.core import conversion as jconv
from repro.core import energy as jenergy
from repro.core import engine as jengine
from repro.core import fpga_model as jfm
from repro.core import quantization as jq
from repro.core import snn_model as jmodel
from repro.data import pipeline as jpipe
from repro.training import optimizer as jopt
from repro_torch.core import cnn_baseline as tcnn
from repro_torch.core import conversion as tconv
from repro_torch.core import energy as tenergy
from repro_torch.core import engine as tengine
from repro_torch.core import fpga_model as tfm
from repro_torch.core import quantization as tq
from repro_torch.core import snn_model as tmodel
from repro_torch.data import pipeline as tpipe
from repro_torch.training import optimizer as topt

# np.asarray of a jax array is read-only; torch warns once when it wraps one
pytestmark = pytest.mark.filterwarnings(
    "ignore:The given NumPy array is not writable")

# the reference's SMALL study net (tests/test_study.py), a two-conv net
# with pools, and a 3-channel two-conv net
NETS = {
    "small": ("mnist", "6C3-P2-8", 28, 1),
    "two_conv": ("mnist", "6C3-P2-8C3-P2-10", 28, 1),
    "rgb": ("cifar10", "8C3-8C3-P2-10", 32, 3),
}


def _np(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _t(params):
    return tmodel.params_from_numpy(params, [], device="cpu")[0]


@pytest.fixture(scope="module", params=sorted(NETS))
def trained(request):
    """The reference's trained params for a net, its calibration images
    (the first 64 training images) and the net's geometry."""
    ds, net, hw, c = NETS[request.param]
    spec = jstudy.StudySpec(dataset=ds, net=net, input_hw=hw, input_c=c,
                            n_train=256, epochs=2, n_calib=64, T=3, depth=64)
    art = jstudy.train(spec, cache=jstudy.StudyCache())
    calib = np.asarray(art.train_images[:64], np.float32)
    return dict(name=request.param, net=net, hw=hw, c=c,
                params=_np(art.params), calib=calib,
                labels=np.asarray(art.train_labels[:64]))


# ---------------------------------------------------------------------------
# quantization: bit-equal, gradients pass through
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 6, 8, 16])
def test_fake_quant_bit_equal_and_straight_through(bits):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((5, 7, 3)) * 0.7).astype(np.float32)
    np.testing.assert_array_equal(
        tq.fake_quant(torch.from_numpy(x), bits).numpy(),
        np.asarray(jq.fake_quant(jnp.asarray(x), bits)))
    relu = np.maximum(x, 0)
    np.testing.assert_array_equal(
        tq.fake_quant_unsigned(torch.from_numpy(relu), bits).numpy(),
        np.asarray(jq.fake_quant_unsigned(jnp.asarray(relu), bits)))
    for fn in (tq.fake_quant, tq.fake_quant_unsigned):
        xt = torch.from_numpy(relu).requires_grad_(True)
        g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
        (fn(xt, bits) * g).sum().backward()
        assert torch.equal(xt.grad, g)


def test_quantize_params_bit_equal(trained):
    got = tq.quantize_params(_t(trained["params"]), 6)
    want = jq.quantize_params(trained["params"], 6)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


# ---------------------------------------------------------------------------
# cnn_forward: logits and activations within rtol 1e-5 / atol 1e-6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [{}, dict(weight_bits=8, act_bits=8),
                                   dict(weight_bits=6, act_bits=4)])
def test_cnn_forward_matches_reference(trained, quant):
    imgs = trained["calib"][:16]
    lt, at = tcnn.cnn_forward(_t(trained["params"]), trained["net"],
                              torch.from_numpy(imgs), return_acts=True,
                              **quant)
    lj, aj = jcnn.cnn_forward(trained["params"], trained["net"],
                              jnp.asarray(imgs), return_acts=True, **quant)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-6)
    assert len(at) == len(aj)
    for a, b in zip(at, aj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
    # one sample without a batch axis (its own per-tensor scales)
    one = tcnn.cnn_forward(_t(trained["params"]), trained["net"],
                           torch.from_numpy(imgs[3]), **quant)
    one_j = jcnn.cnn_forward(trained["params"], trained["net"],
                             jnp.asarray(imgs[3]), **quant)
    assert one.shape == one_j.shape
    np.testing.assert_allclose(one.numpy(), np.asarray(one_j), rtol=1e-5,
                               atol=1e-6)


def test_cnn_accuracy_matches_reference(trained):
    imgs, labels = trained["calib"], trained["labels"]
    got = tcnn.accuracy(_t(trained["params"]), trained["net"],
                        torch.from_numpy(imgs), torch.from_numpy(labels))
    want = jcnn.accuracy(trained["params"], trained["net"],
                         jnp.asarray(imgs), jnp.asarray(labels))
    assert got.dtype == torch.float32 and got.item() == float(want)


# ---------------------------------------------------------------------------
# static costs and energies: equal, energies float32 bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset", sorted(PAPER_SPECS))
@pytest.mark.parametrize("bits", [4, 6, 8, 16])
def test_cnn_costs_and_energy_equal(dataset, bits):
    meta = PAPER_SPECS[dataset]
    ct = tcnn.cnn_costs(None, meta["spec"], meta["hw"], meta["c"], bits, bits)
    cj = jcnn.cnn_costs(None, meta["spec"], meta["hw"], meta["c"], bits, bits)
    assert isinstance(ct.macs, int) and ct.macs == int(cj.macs)
    assert (ct.weight_bytes, ct.act_bytes) == (cj.weight_bytes, cj.act_bytes)
    et = tenergy.cnn_energy(ct, bits=bits)
    ej = jenergy.cnn_energy(cj, bits=bits)
    for f in ("compute_pj", "hbm_pj", "vmem_pj", "total_pj", "latency_s"):
        a, b = getattr(et, f), np.asarray(getattr(ej, f))
        assert a.dtype == torch.float32 and b.dtype == np.float32
        assert a.numpy().tobytes() == b.tobytes(), f
    assert et.total_j.numpy().tobytes() == np.asarray(ej.total_j).tobytes()
    assert float(et.fps_per_w()) == float(ej.fps_per_w())


@pytest.mark.parametrize("dataset", sorted(PAPER_SPECS))
@pytest.mark.parametrize("T,depth,word", [(4, 256, 1), (2, 64, 2)])
def test_snn_static_costs_equal(dataset, T, depth, word):
    meta = PAPER_SPECS[dataset]
    pt = tengine.compile_plan(meta["spec"], meta["hw"], meta["c"])
    pj = jengine.compile_plan(meta["spec"], meta["hw"], meta["c"])
    assert (tenergy.snn_static_costs(pt, T=T, depth=depth, word_bytes=word)
            == jenergy.snn_static_costs(pj, T=T, depth=depth,
                                        word_bytes=word))


def test_pricing_constants_are_the_reference_model_inputs():
    for name in ("E_FP32_ADD", "E_BF16_MAC", "E_INT8_MAC", "E_HBM_BYTE",
                 "E_VMEM_BYTE", "PEAK_BF16_FLOPS", "PEAK_INT8_OPS", "HBM_BW",
                 "CLOCK_HZ", "STATIC_POWER_W"):
        assert getattr(tenergy, name) == getattr(jenergy, name), name


# ---------------------------------------------------------------------------
# the FPGA model: every Table 5 case of tests/test_fpga_model.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 8, 10, 16, 18, 19, 36])
def test_fpga_bram_words_equal(w):
    assert tfm.bram_words(w) == jfm.bram_words(w)


@pytest.mark.parametrize("w", [0, 9, 37])
def test_fpga_bram_words_refuse_the_same_widths(w):
    with pytest.raises(ValueError, match="word width"):
        jfm.bram_words(w)
    with pytest.raises(ValueError, match="word width"):
        tfm.bram_words(w)


@pytest.mark.parametrize("P,D,w,expected_aeq,D_m,w_m,expected_mem", [
    (1, 6100, 10, 27, 256, 16, 9),    # SNN1_BRAM (w=16)
    (4, 2048, 10, 36, 256, 8, 36),    # SNN4_BRAM
    (8, 750, 10, 36, 256, 8, 72),     # SNN8_BRAM
])
def test_fpga_table5_rows(P, D, w, expected_aeq, D_m, w_m, expected_mem):
    assert tfm.n_bram(P, 9, D, w) == jfm.n_bram(P, 9, D, w) == expected_aeq
    assert 2 * tfm.n_bram(P, 9, D_m, w_m) == expected_mem
    assert tfm.snn_memory_plan(P=P, D_aeq=D, w_aeq=w) == \
        jfm.snn_memory_plan(P=P, D_aeq=D, w_aeq=w)


def test_fpga_compression_occupancy_and_plan_totals():
    assert tfm.n_bram(1, 9, 4096, 8) == tfm.n_bram(1, 9, 4096, 10) / 2
    assert tfm.bram_occupancy(256, 8) == jfm.bram_occupancy(256, 8)
    plan = tfm.snn_memory_plan(P=8, D_aeq=750, w_aeq=10)
    assert tuple(plan) == (36, 72, 20.0, 128)
    with pytest.raises(ValueError, match="word width"):
        tfm.bram_words(0)


# ---------------------------------------------------------------------------
# training: one step, AdamW, the batches
# ---------------------------------------------------------------------------

def _jgrad(params_np, net, batch_np, quant):
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}

    def loss(p):
        return jcnn.cross_entropy(
            jcnn.cnn_forward(p, net, jb["image"], **quant), jb["label"])

    return jax.value_and_grad(loss)(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params_np])


def _tgrad(params_np, net, batch_np, quant):
    leaves = [{k: v.requires_grad_(True) for k, v in p.items()}
              for p in _t(params_np)]
    loss = tcnn.cross_entropy(
        tcnn.cnn_forward(leaves, net, torch.from_numpy(batch_np["image"]),
                         **quant), torch.from_numpy(batch_np["label"]))
    loss.backward()
    return loss, [{k: v.grad for k, v in p.items()} for p in leaves]


QUANTS = [dict(weight_bits=None, act_bits=None),
          dict(weight_bits=8, act_bits=8)]


@pytest.mark.parametrize("quant", QUANTS)
def test_train_step_exact_sums_loss_and_gradients(quant):
    """A dyadic net and dyadic images (every conv and dense sum exact in
    any order, so both packages see the same activations): the loss
    within rtol 1e-5 and every gradient within rtol 1e-4 / atol 1e-7, float
    and fake-quant; then one AdamW step of each package's own trainer."""
    from _torch_nets import dyadic_net, images

    net, hw, c = "6C3-P2-8C3-P3-10", 12, 2
    params, _ = dyadic_net(net, hw, c, seed=2)
    rng = np.random.default_rng(2)
    batch = {"image": images(32, hw, c, seed=3),
             "label": rng.integers(0, 10, 32).astype(np.int32)}
    lj, gj = _jgrad(params, net, batch, quant)
    lt, gt = _tgrad(params, net, batch, quant)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    for a, b in zip(gt, gj):
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=1e-4, atol=1e-7)

    init_j, step_j = jcnn.make_train_step(net, lr=2e-3, **quant)
    init_t, step_t = tcnn.make_train_step(net, lr=2e-3, **quant)
    pj = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    pj, _, loss_j = step_j(pj, init_j(pj),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    pt, opt_t, loss_t = step_t(_t(params), init_t(_t(params)),
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    assert int(opt_t.step) == 1
    for a, b in zip(pt, pj):
        for k in a:
            assert not a[k].requires_grad
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("quant", QUANTS)
def test_train_step_trained_nets_loss_and_gradients(trained, quant):
    """The reference's trained nets on their own training images: the
    convs round a few ulps apart (a 1-channel input, the dense product),
    and such an ulp can flip a discrete choice — a max-pool tie, a ReLU at
    0, a fake-quant rounding boundary — that moves one gradient entry or
    the loss by more than rounding. Held: the loss within rtol 1e-5 float
    (1e-4 fake-quant), every gradient tensor within 1e-4 of its norm, and
    all but 0.1% of its entries within rtol 1e-4 / atol 1e-7. The small
    net has 8 outputs for 10 classes: labels 8 and 9 make both losses NaN
    and add nothing to the gradients."""
    batch = {"image": trained["calib"][:32],
             "label": trained["labels"][:32].astype(np.int32)}
    lj, gj = _jgrad(trained["params"], trained["net"], batch, quant)
    lt, gt = _tgrad(trained["params"], trained["net"], batch, quant)
    assert np.isnan(float(lj)) == (trained["name"] == "small")
    np.testing.assert_allclose(lt.item(), float(lj),
                               rtol=1e-4 if quant["act_bits"] else 1e-5)
    for a, b in zip(gt, gj):
        for k in a:
            got, want = a[k].numpy(), np.asarray(b[k])
            assert (np.linalg.norm(got - want)
                    <= 1e-4 * np.linalg.norm(want) + 1e-7)
            off = ~np.isclose(got, want, rtol=1e-4, atol=1e-7)
            assert off.mean() <= 1e-3, (k, int(off.sum()), off.size)


@pytest.mark.parametrize("grad_clip,weight_decay", [(1.0, 0.0), (0.05, 0.0),
                                                    (1.0, 1e-2), (None, 0.0)])
def test_adamw_update_within_one_ulp(grad_clip, weight_decay):
    """Fed identical numpy gradients (large enough that the clip at 1.0
    and 0.05 is active), 3 steps of params agree within 1 ulp. The moments
    are held within 1 ulp without the clip; with it, within 1e-6 of their
    largest entry: the clip scale divides by the global norm, whose sums
    XLA and torch reduce in different orders, and a 1-ulp scale grows to
    many ulps where ``b1 * m + (1 - b1) * g`` cancels."""
    rng = np.random.default_rng(3)
    shapes = [{"w": (3, 3, 1, 6), "b": (6,)}, {}, {"w": (24, 8), "b": (8,)}]
    params = [{k: rng.standard_normal(s).astype(np.float32)
               for k, s in layer.items()} for layer in shapes]
    pj = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    pt = _t(params)
    sj, st = jopt.adamw_init(pj), topt.adamw_init(pt)
    kw = dict(lr=2e-3, grad_clip=grad_clip, weight_decay=weight_decay)
    for _ in range(3):
        grads = [{k: (rng.standard_normal(s) * 3).astype(np.float32)
                  for k, s in layer.items()} for layer in shapes]
        if grad_clip is not None:
            assert float(jopt.global_norm(grads)) > grad_clip
        pj, sj = jopt.adamw_update(
            pj, [{k: jnp.asarray(v) for k, v in g.items()} for g in grads],
            sj, **kw)
        pt, st = topt.adamw_update(pt, _t(grads), st, **kw)
        for a, b in zip(pt, pj):
            for k in a:
                np.testing.assert_array_max_ulp(a[k].numpy(),
                                                np.asarray(b[k]), maxulp=1)
        for mom_t, mom_j in ((st.mu, sj.mu), (st.nu, sj.nu)):
            for a, b in zip(mom_t, mom_j):
                for k in a:
                    got, want = a[k].numpy(), np.asarray(b[k])
                    if grad_clip is None:
                        np.testing.assert_array_max_ulp(got, want, maxulp=1)
                    else:
                        np.testing.assert_allclose(
                            got, want, rtol=0,
                            atol=1e-6 * np.abs(want).max())
    assert int(st.step) == int(sj.step) == 3
    np.testing.assert_array_max_ulp(
        topt.global_norm(pt).numpy(), np.asarray(jopt.global_norm(pj)),
        maxulp=2)


def test_cosine_schedule_matches_reference():
    for s in (0, 5, 10, 57, 100, 140):
        a = topt.cosine_schedule(s, base_lr=1e-3, warmup=10, total=100)
        b = jopt.cosine_schedule(s, base_lr=1e-3, warmup=10, total=100)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_image_batches_are_the_reference_arrays():
    got = list(tpipe.image_batches("svhn", 40, 16, seed=4, device="cpu"))
    want = list(jpipe.image_batches("svhn", 40, 16, seed=4))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for k in ("image", "label"):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_percentile_bit_equal_to_jnp(seed):
    """The port's percentile == ``jnp.percentile`` bit for bit, over sizes
    from 1 to past 2^18, every q the study uses and the edges, with and
    without NaN."""
    rng = np.random.default_rng(seed)
    for n in (1, 2, 7, 1000, int(rng.integers(3, 300_000)), 301_056):
        a = (rng.standard_normal(n) * rng.choice([1e-3, 1, 40])).astype(
            np.float32)
        if seed % 2:
            a = np.maximum(a, 0)
        for q in (0.0, 1.0, 37.3, 50.0, 90.0, 99.0, 99.9, 99.99, 100.0):
            got = tconv.percentile_f32(torch.from_numpy(a), q)
            want = np.asarray(jnp.percentile(jnp.asarray(a), q))
            assert got.dtype == torch.float32 and got.shape == ()
            assert got.numpy().tobytes() == want.tobytes(), (n, q)
    a = rng.standard_normal(50).astype(np.float32)
    a[17] = np.nan
    assert torch.isnan(tconv.percentile_f32(torch.from_numpy(a), 99.0))


def test_percentile_of_reference_activations_bit_equal(trained):
    """On the reference's own calibration activations (every conv and the
    logits), the port's percentile gives the reference's lambdas."""
    _, acts = jcnn.cnn_forward(trained["params"], trained["net"],
                               jnp.asarray(trained["calib"]),
                               return_acts=True)
    lams = jconv.calibrate_lambdas(trained["params"], trained["net"],
                                   jnp.asarray(trained["calib"]))
    got = [tconv.percentile_f32(torch.from_numpy(trained["calib"]), 99.0)]
    got += [torch.clamp(tconv.percentile_f32(torch.from_numpy(np.asarray(a)),
                                             99.0), min=1e-6) for a in acts]
    for a, b in zip(got, lams):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_calibrate_lambdas_end_to_end(trained):
    """The port's lambdas from the same params and images: lambda_0 (the
    images) bit-equal; each layer's bit-equal wherever the two packages'
    activations are equal, and within the forward's rtol 1e-5 elsewhere."""
    imgs = trained["calib"]
    pt = _t(trained["params"])
    got = tconv.calibrate_lambdas(pt, trained["net"], torch.from_numpy(imgs))
    want = jconv.calibrate_lambdas(trained["params"], trained["net"],
                                   jnp.asarray(imgs))
    _, at = tcnn.cnn_forward(pt, trained["net"], torch.from_numpy(imgs),
                             return_acts=True)
    _, aj = jcnn.cnn_forward(trained["params"], trained["net"],
                             jnp.asarray(imgs), return_acts=True)
    assert len(got) == len(want) == len(at) + 1
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    for lam_t, lam_j, a, b in zip(got[1:], want[1:], at, aj):
        if np.array_equal(a.numpy(), np.asarray(b)):
            assert lam_t.numpy().tobytes() == np.asarray(lam_j).tobytes()
        else:
            np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j),
                                       rtol=1e-5)


def test_convert_bit_equal_given_the_lambdas(trained, monkeypatch):
    """convert's weight normalization from the reference's lambdas (the
    port's calibration swapped for them): converted params bit-equal, unit
    float32 thresholds in every slot."""
    imgs = trained["calib"]
    lams = jconv.calibrate_lambdas(trained["params"], trained["net"],
                                   jnp.asarray(imgs))
    monkeypatch.setattr(
        tconv, "calibrate_lambdas",
        lambda *a, **k: [torch.from_numpy(np.asarray(x)) for x in lams])
    st, tht = tconv.convert(_t(trained["params"]), trained["net"],
                            torch.from_numpy(imgs))
    sj, thj = jconv.convert(trained["params"], trained["net"],
                            jnp.asarray(imgs))
    assert len(st) == len(sj) and len(tht) == len(thj)
    for a, b in zip(st, sj):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].numpy().tobytes() == np.asarray(b[k]).tobytes()
    for a, b in zip(tht, thj):
        assert a.dtype == torch.float32 and a.item() == float(b) == 1.0


def test_balance_thresholds_equal_reference(trained):
    """Greedy balancing from the port's own conversion picks the
    reference's scales, layer for layer."""
    net, hw, c = trained["net"], trained["hw"], trained["c"]
    imgs = trained["calib"]
    pt = _t(trained["params"])
    st, tht = tconv.convert(pt, net, torch.from_numpy(imgs))
    sj, thj = jconv.convert(trained["params"], net, jnp.asarray(imgs))
    kw = dict(spec=net, input_hw=hw, input_c=c, T=3, mode="mttfs_cont",
              depth=64)
    bt = tconv.balance_thresholds(st, tht, tengine.SNNConfig(**kw), pt,
                                  torch.from_numpy(imgs))
    bj = jconv.balance_thresholds(sj, thj, jengine.SNNConfig(**kw),
                                  trained["params"], jnp.asarray(imgs))
    assert [a.item() for a in bt] == [float(b) for b in bj]
    assert tconv.conversion_gap(0.9, 0.85) == jconv.conversion_gap(0.9, 0.85)


def test_snn_model_wrappers_pick_their_backends(trained):
    """snn_infer / snn_dense_infer (and their batch forms) are the queue
    and dense engine calls, as in the reference."""
    net, hw, c = trained["net"], trained["hw"], trained["c"]
    pt = _t(trained["params"])
    th = [1.0] * len(pt)
    cfg = tengine.SNNConfig(spec=net, input_hw=hw, input_c=c, T=2, depth=16)
    x = torch.from_numpy(trained["calib"][:3])
    for wrap, wrap_b, backend in (
            (tmodel.snn_infer, tmodel.snn_infer_batch, "queue"),
            (tmodel.snn_dense_infer, tmodel.snn_dense_infer_batch, "dense")):
        lb, sb = wrap_b(pt, th, cfg, x, device="cpu")
        le, se = tengine.infer_batch(pt, th, cfg, x, backend=backend,
                                     device="cpu")
        assert torch.equal(lb, le)
        l1, s1 = wrap(pt, th, cfg, x[1], device="cpu")
        assert torch.equal(l1, lb[1])
        assert all(torch.equal(a, b[1]) for a, b in zip(s1, sb))


def test_params_to_numpy_round_trips(trained):
    pt, _ = tmodel.params_from_numpy(trained["params"], [], device="cpu")
    back = tmodel.params_to_numpy(pt)
    for a, b in zip(back, trained["params"]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
    # the reference's own init for the same shapes is accepted unchanged
    jp = jmodel.init_params(jax.random.PRNGKey(1), trained["net"],
                            trained["hw"], trained["c"])
    assert tmodel.count_params(_t(_np(jp))) == jmodel.count_params(jp)
