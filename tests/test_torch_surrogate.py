"""Direct surrogate-gradient training in the port against the JAX package.

On the same numpy inputs made from a seed:

- the straight-through spike, every surrogate fire and the straight-through
  max-pool: forward bit-equal to the hard dynamics, gradients equal to
  ``jax.grad`` of the reference's;
- ``engine.train_forward``: ``step_logits`` and ``rates`` bit-equal, the
  loss and every parameter's gradient within 1e-5 of that gradient's norm.
  Weights, biases, thresholds and images are dyadic (multiples of 2^-8 /
  2^-4), so every forward sum is exact in any order and XLA's and torch's
  CPU convs give the same spikes (ROADMAP C4); the backward sums are not
  exact, hence the tolerance;
- ``make_snn_train_step`` and ``fit_snn`` from the reference's init (its
  params carried across with ``params_from_numpy``), ``fit_snn``'s
  determinism and its bit-exact resume;
- ``study.train_snn``'s key and cache payloads, in both directions, and
  ``export_artifact`` / ``load_artifact`` across the two packages;
- the input encoders ``encode_constant_current`` and ``encode_rate``.
"""
import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import study as jstudy
from repro.core import encoding as jencoding
from repro.core import engine as jengine
from repro.core import neuron as jneuron
from repro.core import snn_layers as jlayers
from repro.core.snn_model import init_params as jinit_params
from repro.study import stages as jstages
from repro.training import surrogate as jsurrogate
from repro.training.optimizer import adamw_init as jadamw_init
from repro_torch import study as tstudy
from repro_torch.core import encoding as tencoding
from repro_torch.core import engine as tengine
from repro_torch.core import neuron as tneuron
from repro_torch.core import snn_layers as tlayers
from repro_torch.core import snn_model as tmodel
from repro_torch.training import surrogate as tsurrogate
from repro_torch.training.optimizer import adamw_init as tadamw_init

from _torch_nets import dyadic_net, images

pytestmark = pytest.mark.filterwarnings(
    "ignore:The given NumPy array is not writable")

MODES = ("if_reset", "mttfs", "mttfs_cont")
SURROGATES = ("triangle", "superspike", "sigmoid")
BETAS = (1.0, 10.0)
GRAD_TOL = 1e-5          # of each gradient's norm


def _np_params(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _assert_params_equal(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        assert sorted(la) == sorted(lb)
        for k in la:
            va = la[k].cpu().numpy() if isinstance(la[k], torch.Tensor) \
                else np.asarray(la[k])
            vb = lb[k].cpu().numpy() if isinstance(lb[k], torch.Tensor) \
                else np.asarray(lb[k])
            np.testing.assert_array_equal(va, vb)


def _t_grad(fn, x):
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt)
    g, = torch.autograd.grad(y.sum(), xt)
    return y.detach().numpy(), g.numpy()


# ---------------------------------------------------------------------------
# the straight-through spike, fire and pool
# ---------------------------------------------------------------------------

def _spike_grid(beta):
    """A grid over [-3, 3] with x = ±0, the triangle's clamp edges ±1/beta
    and the 100 floats each side of them, where its inner quadratic rounds
    to the clip's bounds (the clip's gradient ties)."""
    edge = np.float32(1.0 / beta)
    near = [np.nextafter(np.float32(e), np.float32(0)) * (1 + np.arange(
        -50, 50, dtype=np.float32) * np.float32(1e-7)) for e in (edge, -edge)]
    return np.concatenate([np.linspace(-3, 3, 2001, dtype=np.float32),
                           np.array([0.0, -0.0, edge, -edge], np.float32),
                           *near]).astype(np.float32)


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("name", SURROGATES)
def test_spike_fn_forward_and_grad_match_reference(name, beta):
    """Forward: bit-equal to ``(x > 0)``. Gradient: equal to ``jax.grad``
    of the reference's spike to 1e-6 relative, or within 2^-19 * beta
    (under 1e-5 of each surrogate's peak) where the two round apart:
    autodiff of the triangle's quadratic cancels near its clamp edge (the
    two packages add its terms in another order), XLA's tanh rounds to
    exactly 1 in the sigmoid's tails where torch's is 1 - 2^-24, and the
    two CPU tanh implementations have put the sigmoid's gradient up to
    9.7e-7 apart at beta = 1 (in some processes only)."""
    x = _spike_grid(beta)
    jspike = jneuron.spike_fn(name, beta)
    want_y = np.asarray(jspike(jnp.asarray(x)))
    want_g = np.asarray(jax.vmap(jax.grad(jspike))(jnp.asarray(x)))
    y, g = _t_grad(tneuron.spike_fn(name, beta), x)
    np.testing.assert_array_equal(y, (x > 0).astype(np.float32))
    np.testing.assert_array_equal(y, want_y)
    err = np.abs(g - want_g)
    assert np.all((err <= 1e-6 * np.abs(want_g)) | (err <= 2.0 ** -19 * beta))
    if name == "triangle":   # exact zeros outside the window, as there
        outside = np.abs(beta * x) >= 1
        assert not g[outside].any() and not want_g[outside].any()
    # away from the triangle's kinks (where the clip's ties halve it, in
    # both packages), the registered analytic derivative
    sg = tneuron.get_surrogate(name)
    keep = np.abs(np.abs(x) - 1 / beta) > 1e-3
    np.testing.assert_allclose(
        g[keep], sg.grad(torch.tensor(x[keep]), beta).numpy(), rtol=1e-5,
        atol=1e-5)


def _fire_inputs(seed=0):
    rng = np.random.default_rng(seed)
    v = (rng.integers(-48, 48, (6, 6, 3)) / 32.0).astype(np.float32)
    v[0, :3, 0] = [0.5, 0.5 + 2 ** -20, 0.5 - 2 ** -20]   # at the threshold
    latch = rng.random((6, 6, 3)) > 0.6
    return v, latch, np.float32(0.5)


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("surrogate", SURROGATES)
@pytest.mark.parametrize("mode", MODES)
def test_surrogate_fire_and_pool_match_reference(mode, surrogate, beta):
    """One fire step then the fused pool: v, spikes and latches bit-equal to
    the hard model's; d(sum of pooled spikes + v)/d(v) equal to the
    reference's; and the straight-through pool's gradient equal to
    ``jax.grad`` of the reference's on all-zero, single-one and tied
    windows."""
    hard = tneuron.get_neuron_model(mode)
    soft = tneuron.surrogate_model(mode, surrogate, beta)
    jsoft = jneuron.surrogate_model(mode, surrogate, beta)
    assert soft.straight_through and not hard.straight_through
    assert soft.pool_latch_once == hard.pool_latch_once == \
        jsoft.pool_latch_once
    v, latch, vth = _fire_inputs()
    vh, sh, lh = hard.fire(torch.tensor(v), torch.tensor(latch),
                           torch.tensor(vth))
    vs, ss, ls = soft.fire(torch.tensor(v), torch.tensor(latch),
                           torch.tensor(vth))
    np.testing.assert_array_equal(vs.numpy(), vh.numpy())
    np.testing.assert_array_equal(ss.numpy(), sh.numpy().astype(np.float32))
    np.testing.assert_array_equal(ls.numpy(), lh.numpy())
    assert ls.dtype == torch.bool

    p_latch = np.zeros((3, 3, 3), bool)
    p_latch[0, 0] = True

    def jstep(vv):
        v2, sp, _ = jsoft.fire(vv, jnp.asarray(latch), jnp.float32(vth))
        pooled, _ = jlayers.spike_maxpool_hwc(
            sp, 2, jnp.asarray(p_latch), latch_once=jsoft.pool_latch_once,
            straight_through=True)
        return pooled.sum() + (v2 * 0.25).sum()

    def tstep(vv):
        v2, sp, _ = soft.fire(vv, torch.tensor(latch), torch.tensor(vth))
        pooled, _ = tlayers.spike_maxpool_hwc(
            sp, 2, torch.tensor(p_latch), latch_once=soft.pool_latch_once,
            straight_through=True)
        return pooled.sum() + (v2 * 0.25).sum()

    want = np.asarray(jax.grad(jstep)(jnp.asarray(v)))
    _, got = _t_grad(tstep, v)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2.0 ** -19 * beta)

    # the pool alone, on its tie cases: all-zero, single-one, tied windows
    # (1/9 each on an all-zero 3x3 window, 1/3 on three tied ones)
    spikes = np.zeros((6, 6, 2), np.float32)
    spikes[3, 4, 0] = 1.0                                   # single one
    spikes[0:2, 3, 1] = 1.0
    spikes[1, 4, 1] = 1.0                                   # tied ones
    pl = np.zeros((2, 2, 2), bool)
    pl[1, 1, 1] = True
    wts = np.arange(8, dtype=np.float32).reshape(2, 2, 2) + 1

    def jpool(s):
        out, _ = jlayers.spike_maxpool_hwc(
            s, 3, jnp.asarray(pl), latch_once=soft.pool_latch_once,
            straight_through=True)
        return (out * wts).sum()

    def tpool(s):
        out, _ = tlayers.spike_maxpool_hwc(
            s, 3, torch.tensor(pl), latch_once=soft.pool_latch_once,
            straight_through=True)
        return (out * torch.tensor(wts)).sum()

    want = np.asarray(jax.grad(jpool)(jnp.asarray(spikes)))
    _, got = _t_grad(tpool, spikes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[0:3, 0:3, 0], 1 / 9, rtol=1e-6)  # zeros
    assert got[3, 4, 0] == wts[1, 1, 0]                     # single one
    tied = got[0:3, 3:6, 1]
    assert np.count_nonzero(tied) == 3
    np.testing.assert_allclose(tied[tied != 0], wts[0, 1, 1] / 3, rtol=1e-6)


def test_surrogate_model_unknown_mode_and_surrogate():
    with pytest.raises(ValueError, match="unknown neuron mode"):
        tneuron.surrogate_model("no-such-mode")
    with pytest.raises(ValueError, match="superspike"):
        tneuron.surrogate_model("if_reset", "no-such-surrogate")


# ---------------------------------------------------------------------------
# train_forward and its gradient
# ---------------------------------------------------------------------------

NETS = {  # spec, hw, c
    "one_pool": ("4C3-P2-6", 8, 1),
    "two_pools": ("8C3-P2-8C3-P2-10", 12, 1),
}


def _loss_both(name, input_mode, mode, target, B=3):
    spec, hw, c = NETS[name]
    params, th = dyadic_net(spec, hw, c, seed=2)
    x = images(B, hw, c, seed=5)
    labels = np.arange(B) % int(spec.split("-")[-1])
    cfg_kw = dict(spec=spec, input_hw=hw, input_c=c, T=4, mode=mode,
                  input_mode=input_mode)
    jth = tuple(jnp.asarray(t) for t in th)

    def jloss(jp):
        sl, r = jengine.train_forward(jp, jth, jengine.SNNConfig(**cfg_kw),
                                      jnp.asarray(x))
        loss = jsurrogate.target_loss(target, sl, jnp.asarray(labels))
        return loss + 0.05 * r.mean(), (sl, r)

    (jl, (jsl, jr)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params])

    tp = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
          for p in params]
    sl, r = tengine.train_forward(tp, [torch.tensor(t) for t in th],
                                  tengine.SNNConfig(**cfg_kw),
                                  torch.tensor(x))
    tl = tsurrogate.target_loss(target, sl, torch.tensor(labels)) \
        + 0.05 * r.mean()
    leaves = [v for p in tp for v in p.values()]
    grads = torch.autograd.grad(tl, leaves)
    return dict(params=params, th=th, x=x, cfg_kw=cfg_kw, jl=jl, jsl=jsl,
                jr=jr, jg=jg, tl=tl, sl=sl, r=r, tp=tp, grads=grads)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("input_mode", ["analog", "binary"])
@pytest.mark.parametrize("net", list(NETS))
def test_train_forward_and_gradients_match_reference(net, input_mode, mode):
    """For each loss target (plus a rate regularizer): step_logits and rates
    bit-equal, the loss to 1e-6, every gradient within GRAD_TOL of its
    norm; and the summed step_logits equal the port's dense inference
    logits to 1e-4 with the same rates of spikes."""
    for target in tsurrogate.VALID_TARGETS:
        o = _loss_both(net, input_mode, mode, target)
        np.testing.assert_array_equal(o["sl"].detach().numpy(),
                                      np.asarray(o["jsl"]))
        np.testing.assert_array_equal(o["r"].detach().numpy(),
                                      np.asarray(o["jr"]))
        np.testing.assert_allclose(float(o["tl"].detach()), float(o["jl"]),
                                   rtol=1e-6)
        it = iter(o["grads"])
        for tlayer, jlayer in zip(o["tp"], o["jg"]):
            assert sorted(tlayer) == sorted(jlayer)
            for k in tlayer:
                g, want = next(it).numpy(), np.asarray(jlayer[k])
                norm = np.linalg.norm(want)
                assert np.abs(g - want).max() <= GRAD_TOL * max(norm, 1e-30), \
                    (target, k, np.abs(g - want).max(), norm)

    logits, stats = tengine.infer_batch(
        o["params"], o["th"], tengine.SNNConfig(**o["cfg_kw"]), o["x"],
        backend="dense", device="cpu")
    np.testing.assert_allclose(o["sl"].detach().sum(1).numpy(),
                               logits.numpy(), rtol=1e-4, atol=1e-4)
    plan = tengine.compile_plan(*NETS[net])
    for i, cp in enumerate(plan.convs):
        n = o["cfg_kw"]["T"] * cp.out_hw * cp.out_hw * cp.out_c
        np.testing.assert_allclose(o["r"][:, i].detach().numpy() * n,
                                   stats.spikes_out[:, i].numpy(), rtol=1e-6)


def test_train_forward_runs_on_the_params_device_and_takes_numpy():
    spec, hw, c = NETS["one_pool"]
    params, th = tmodel.params_from_numpy(*dyadic_net(spec, hw, c),
                                          device="cpu")
    cfg = tengine.SNNConfig(spec=spec, input_hw=hw, input_c=c, T=3)
    sl, r = tengine.train_forward(params, th, cfg, images(2, hw, c))
    assert sl.shape == (2, 3, 6) and r.shape == (2, 1)
    assert sl.device.type == "cpu" and sl.dtype == torch.float32


@pytest.mark.parametrize("target", ["count", "train", "latency"])
def test_target_loss_matches_reference(target):
    rng = np.random.default_rng(0)
    step_logits = rng.normal(0, 1, (4, 3, 6)).astype(np.float32)
    labels = np.array([0, 1, 2, 5])
    want = float(jsurrogate.target_loss(target, jnp.asarray(step_logits),
                                        jnp.asarray(labels)))
    got = tsurrogate.target_loss(target, torch.tensor(step_logits),
                                 torch.tensor(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_unknown_target_names_the_valid_ones():
    assert tsurrogate.VALID_TARGETS == jsurrogate.VALID_TARGETS
    with pytest.raises(ValueError, match="latency"):
        tsurrogate.target_loss("nope", torch.zeros((2, 3, 4)),
                               torch.zeros((2,), dtype=torch.int32))
    cfg = tengine.SNNConfig(spec="4C3-P2-6", input_hw=8, input_c=1)
    with pytest.raises(ValueError, match="latency"):
        tsurrogate.make_snn_train_step(cfg, [1.0] * 3, target="nope")
    with pytest.raises(tstudy.StudySpecError, match="latency"):
        tstudy.StudySpec(dataset="mnist", loss_target="ttfs")


# ---------------------------------------------------------------------------
# training steps and fit_snn
# ---------------------------------------------------------------------------

def _digits(n=96):
    from repro_torch.data.synthetic import make_digits

    imgs, labels = make_digits(n, seed=0)
    return np.asarray(imgs), np.asarray(labels)


STEP_SPEC = "4C3-P2-10"
# params after AdamW steps: within a thousandth of one step (lr 5e-3). Adam
# divides each coordinate's moment by its own scale, so a coordinate whose
# gradient is near zero or changes sign between steps turns the gradients'
# rounding differences (GRAD_TOL) into a visible part of its update
PARAM_TOL = 1e-3 * 5e-3


@pytest.mark.parametrize("target,rate_reg", [("count", 0.0), ("train", 0.01),
                                             ("latency", 0.01)])
def test_train_steps_match_reference(target, rate_reg):
    """Two AdamW steps from the reference's init: the losses to 1e-5, the
    params within PARAM_TOL."""
    imgs, labels = _digits()
    hw = imgs.shape[1]
    jparams = jinit_params(jax.random.PRNGKey(1), STEP_SPEC, hw, 1)
    jth = jsurrogate.unit_thresholds(STEP_SPEC, hw, 1)
    cfg_kw = dict(spec=STEP_SPEC, input_hw=hw, input_c=1, T=2,
                  mode="mttfs_cont")
    jstep, _ = jsurrogate.make_snn_train_step(
        jengine.SNNConfig(**cfg_kw), jth, target=target, rate_reg=rate_reg)
    tparams, tth = tmodel.params_from_numpy(
        _np_params(jparams), [np.asarray(t) for t in jth], device="cpu")
    tstep, _ = tsurrogate.make_snn_train_step(
        tengine.SNNConfig(**cfg_kw), tth, target=target, rate_reg=rate_reg)
    jopt, topt = jadamw_init(jparams), tadamw_init(tparams)
    for k in range(2):
        x, y = imgs[48 * k:48 * (k + 1)], labels[48 * k:48 * (k + 1)]
        jparams, jopt, jl = jstep(jparams, jopt, jnp.asarray(x),
                                  jnp.asarray(y))
        tparams, topt, tl = tstep(tparams, topt, torch.tensor(x),
                                  torch.tensor(y))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        assert int(topt.step) == int(jopt.step) == k + 1
        for tp, jp in zip(tparams, jparams):
            for key in jp:
                assert not tp[key].requires_grad
                np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]),
                                           rtol=0, atol=PARAM_TOL)


FIT_KW = dict(T=2, epochs=1, batch=48, lr=5e-3, rate_reg=0.01, init_seed=3)


def test_fit_snn_from_reference_init_matches_reference(monkeypatch):
    """The port's fit_snn with its init_params patched to hand out the
    reference's init: the same shuffles and steps give the reference's
    params within PARAM_TOL and its loss to 1e-5."""
    imgs, labels = _digits()
    hw = imgs.shape[1]
    jp, jth, jl = jsurrogate.fit_snn(STEP_SPEC, imgs, labels, **FIT_KW)
    ref_init = jinit_params(jax.random.PRNGKey(FIT_KW["init_seed"]),
                            STEP_SPEC, hw, 1)

    def init_params(generator, spec, input_hw, input_c, *, device=None):
        return tmodel.params_from_numpy(_np_params(ref_init), [],
                                        device=device)[0]

    monkeypatch.setattr(tsurrogate, "init_params", init_params)
    tp, tth, tl = tsurrogate.fit_snn(STEP_SPEC, imgs, labels, **FIT_KW,
                                     device="cpu")
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(tp, jp):
        for k in b:
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=0, atol=PARAM_TOL)
    assert [float(t) for t in tth] == [float(t) for t in jth]


def test_fit_snn_is_deterministic():
    """Same seed, same data: bit-identical params; another seed trains a
    different net."""
    imgs, labels = _digits()
    p1, th1, l1 = tsurrogate.fit_snn(STEP_SPEC, imgs, labels, **FIT_KW,
                                     device="cpu")
    p2, th2, l2 = tsurrogate.fit_snn(STEP_SPEC, imgs, labels, **FIT_KW,
                                     device="cpu")
    _assert_params_equal(p1, p2)
    assert np.isfinite(float(l1))
    assert l1.numpy().tobytes() == l2.numpy().tobytes()
    assert len(th1) == len(th2) == 3
    p3, _, _ = tsurrogate.fit_snn(STEP_SPEC, imgs, labels,
                                  **{**FIT_KW, "init_seed": 4}, device="cpu")
    assert any(not torch.equal(a["w"], b["w"])
               for a, b in zip(p1, p3) if "w" in a)


def test_fit_snn_checkpoint_resume_is_bit_exact(tmp_path):
    """Kill after epoch 2 of 3, resume from the checkpoints: identical to
    the uninterrupted run; the steps count only the epochs run."""
    from repro_torch.checkpoint.checkpoint import latest_step

    imgs, labels = _digits()
    kw = dict(T=2, epochs=3, batch=48, lr=5e-3, init_seed=0, device="cpu")
    p_ref, _, l_ref = tsurrogate.fit_snn("4C3-P2-6", imgs, labels, **kw)
    ck = str(tmp_path / "ck")
    tsurrogate.fit_snn("4C3-P2-6", imgs, labels, **{**kw, "epochs": 2},
                       ckpt_dir=ck)
    assert latest_step(ck) == 2
    tsurrogate.reset_step_counts()
    p_res, _, l_res = tsurrogate.fit_snn("4C3-P2-6", imgs, labels, **kw,
                                         ckpt_dir=ck)
    assert tsurrogate.step_counts["steps"] == 2      # one epoch of 96 / 48
    assert latest_step(ck) == 3
    _assert_params_equal(p_ref, p_res)
    assert l_ref.numpy().tobytes() == l_res.numpy().tobytes()


# ---------------------------------------------------------------------------
# study.train_snn, collect and run on training="direct"
# ---------------------------------------------------------------------------

DIRECT_KW = dict(dataset="mnist", net="4C3-P2-6", input_hw=28, input_c=1,
                 n_train=64, epochs=1, n_eval=16, n_calib=24, T=2, depth=32,
                 mode="mttfs_cont", balance=False, training="direct",
                 snn_epochs=1, snn_batch=32)
J_DIRECT = jstudy.StudySpec(**DIRECT_KW)
T_DIRECT = tstudy.StudySpec(**DIRECT_KW)


def test_train_snn_key_equals_reference_and_a_cache_hit_runs_zero_steps():
    tstudy.reset_stage_counts()
    tsurrogate.reset_step_counts()
    cache = tstudy.StudyCache()
    a1 = tstudy.train_snn(T_DIRECT, cache=cache, device="cpu")
    steps = tsurrogate.step_counts["steps"]
    assert steps == 2 and tstudy.stage_counts["train_snn"] == 1
    assert isinstance(a1, tstudy.DirectTrainArtifact)
    assert a1.snn_params[0]["w"].device.type == "cpu"
    assert [float(t) for t in a1.thresholds] == [1.0] * 3

    a2 = tstudy.train_snn(T_DIRECT, cache=cache, device="cpu")
    assert tsurrogate.step_counts["steps"] == steps
    assert tstudy.stage_counts["train_snn"] == 1
    _assert_params_equal(a1.snn_params, a2.snn_params)

    # the key is the reference's, and a recipe field changes it
    jkey = jstages.content_key(
        "train-snn-v1", J_DIRECT.dataset, J_DIRECT.net, J_DIRECT.input_hw,
        J_DIRECT.input_c, J_DIRECT.T, J_DIRECT.mode, J_DIRECT.input_mode,
        J_DIRECT.input_theta, J_DIRECT.v_init_frac, J_DIRECT.snn_epochs,
        J_DIRECT.snn_batch, J_DIRECT.snn_lr, J_DIRECT.surrogate,
        J_DIRECT.sg_beta, J_DIRECT.loss_target, J_DIRECT.rate_reg,
        J_DIRECT.snn_init_seed, *J_DIRECT.load_train())
    assert a1.key == jkey
    other = tstudy.train_snn(T_DIRECT.replace(snn_lr=1e-3), cache=cache,
                             device="cpu")
    assert other.key != a1.key
    assert tsurrogate.step_counts["steps"] == 2 * steps


def test_train_snn_disk_round_trip(tmp_path):
    a1 = tstudy.train_snn(T_DIRECT, cache=tstudy.StudyCache(
        dir=str(tmp_path)), device="cpu")
    tsurrogate.reset_step_counts()
    a2 = tstudy.train_snn(T_DIRECT, cache=tstudy.StudyCache(
        dir=str(tmp_path)), device="cpu")
    assert tsurrogate.step_counts["steps"] == 0
    assert a2.key == a1.key
    _assert_params_equal(a1.snn_params, a2.snn_params)
    for t1, t2 in zip(a1.thresholds, a2.thresholds):
        assert torch.equal(t1, t2) and t2.dtype == torch.float32


def test_train_snn_pickles_are_interchangeable(tmp_path):
    """The reference's ``train_snn_*.pkl`` loads in the port with zero
    steps, and the port's loads in the reference with zero steps."""
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ja = jstudy.train_snn(J_DIRECT, cache=jstudy.StudyCache(dir=ref_dir))
    assert glob.glob(os.path.join(ref_dir, "train_snn_*.pkl"))
    tstudy.reset_stage_counts()
    tsurrogate.reset_step_counts()
    ta = tstudy.train_snn(T_DIRECT, cache=tstudy.StudyCache(dir=ref_dir),
                          device="cpu")
    assert tsurrogate.step_counts["steps"] == 0
    assert tstudy.stage_counts["train_snn"] == 0 and ta.key == ja.key
    _assert_params_equal(ta.snn_params, ja.snn_params)

    tb = tstudy.train_snn(T_DIRECT, cache=tstudy.StudyCache(dir=port_dir),
                          device="cpu")
    jstudy.reset_stage_counts()
    jsurrogate.reset_step_counts()
    jb = jstudy.train_snn(J_DIRECT, cache=jstudy.StudyCache(dir=port_dir))
    assert jsurrogate.step_counts["steps"] == 0
    assert jstudy.stage_counts["train_snn"] == 0 and jb.key == tb.key
    _assert_params_equal(tb.snn_params, jb.snn_params)
    assert [float(t) for t in jb.thresholds] == [1.0] * 3


# ---------------------------------------------------------------------------
# export_artifact / load_artifact
# ---------------------------------------------------------------------------

def _artifact(cls, seed=0, key="stage-key"):
    params, th = tmodel.params_from_numpy(*dyadic_net("4C3-P2-6", 8, 1,
                                                      seed=seed),
                                          device="cpu")
    return cls(params, list(th), key)


@pytest.mark.parametrize("kind", ["ConvertArtifact", "DirectTrainArtifact"])
def test_export_artifact_round_trip(kind, tmp_path):
    art = _artifact(getattr(tstudy, kind))
    root = str(tmp_path / "export")
    path = tstudy.export_artifact(art, root)
    assert path == os.path.join(root, "export.json")
    back = tstudy.load_artifact(root, device="cpu")
    assert type(back).__name__ == kind and back.key == "stage-key"
    _assert_params_equal(back.snn_params, art.snn_params)
    for a, b in zip(art.thresholds, back.thresholds):
        assert torch.equal(a, b) and b.device.type == "cpu"


def test_export_artifact_detects_swapped_params(tmp_path):
    art = _artifact(tstudy.ConvertArtifact)
    root, root2 = str(tmp_path / "export"), str(tmp_path / "export2")
    manifest_path = tstudy.export_artifact(art, root)
    tstudy.export_artifact(_artifact(tstudy.ConvertArtifact, seed=8), root2)
    with open(manifest_path) as f:
        manifest = json.load(f)
    shutil.rmtree(root)
    shutil.copytree(root2, root)
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="stale or tampered"):
        tstudy.load_artifact(root, device="cpu")


def test_export_artifact_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        tstudy.load_artifact(str(tmp_path), device="cpu")
    root = str(tmp_path / "export")
    tstudy.export_artifact(_artifact(tstudy.ConvertArtifact), root)
    shard = glob.glob(os.path.join(root, "step_*", "shard_00000.npz"))[0]
    with open(shard, "wb") as f:
        f.write(b"garbage")
    with pytest.raises(IOError):
        tstudy.load_artifact(root, device="cpu")
    path = os.path.join(root, "export.json")
    manifest = json.load(open(path))
    manifest["schema"] = "snn-export-v0"
    json.dump(manifest, open(path, "w"))
    with pytest.raises(ValueError, match="schema"):
        tstudy.load_artifact(root, device="cpu")


def test_exports_load_across_the_two_packages(tmp_path):
    """A reference export loads in the port bit-equal, and a port export
    loads in the reference bit-equal, with the same manifest."""
    params, th = dyadic_net("4C3-P2-6", 8, 1, seed=3)
    jart = jstudy.DirectTrainArtifact(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        [jnp.asarray(t) for t in th], "direct-key")
    ref_root = str(tmp_path / "ref")
    jstudy.export_artifact(jart, ref_root)
    back = tstudy.load_artifact(ref_root, device="cpu")
    assert isinstance(back, tstudy.DirectTrainArtifact)
    assert back.key == "direct-key"
    _assert_params_equal(back.snn_params, jart.snn_params)
    assert [t.numpy().tobytes() for t in back.thresholds] == \
        [np.asarray(t).tobytes() for t in jart.thresholds]

    port_root = str(tmp_path / "port")
    tstudy.export_artifact(back, port_root)
    with open(os.path.join(ref_root, "export.json")) as f:
        want = json.load(f)
    with open(os.path.join(port_root, "export.json")) as f:
        assert json.load(f) == want
    jback = jstudy.load_artifact(port_root)
    assert isinstance(jback, jstudy.DirectTrainArtifact)
    _assert_params_equal(jback.snn_params, jart.snn_params)


# ---------------------------------------------------------------------------
# input encoders
# ---------------------------------------------------------------------------

def test_encode_constant_current_equals_reference():
    x = images(1, 6, 3, seed=4)[0]
    want = np.asarray(jencoding.encode_constant_current(jnp.asarray(x), 5))
    got = tencoding.encode_constant_current(torch.tensor(x), 5)
    assert got.shape == (5, 6, 6, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_rate_mean_seed_and_clip():
    """Rate coding with an explicit generator: the mean rate of a 0.5 image
    within 0.05 of 0.5 at T = 64 (the reference's bound), one seed one
    raster, inputs clipped to [0, 1], the global RNG untouched."""
    img = torch.full((8, 8, 1), 0.5)
    state = torch.get_rng_state()
    r1 = tencoding.encode_rate(img, 64, torch.Generator().manual_seed(0))
    assert torch.equal(torch.get_rng_state(), state)
    assert r1.shape == (64, 8, 8, 1) and r1.dtype == torch.float32
    assert abs(float(r1.mean()) - 0.5) < 0.05
    assert set(np.unique(r1.numpy())) <= {0.0, 1.0}
    r2 = tencoding.encode_rate(img, 64, torch.Generator().manual_seed(0))
    assert torch.equal(r1, r2)
    r3 = tencoding.encode_rate(img, 64, torch.Generator().manual_seed(1))
    assert not torch.equal(r1, r3)
    clipped = tencoding.encode_rate(
        torch.tensor([[-2.0, 3.0]]), 16, torch.Generator().manual_seed(0))
    assert clipped[:, 0, 0].sum() == 0 and clipped[:, 0, 1].sum() == 16


def test_encode_rate_refuses_a_generator_on_another_device():
    class Meta:
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="image's device"):
        tencoding.encode_rate(torch.zeros(2, 2), 4, Meta())
