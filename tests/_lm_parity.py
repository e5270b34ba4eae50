"""Whole-model parity of the port's LM stack against the JAX package, one
smoke configuration at a time (used by ``tests/test_torch_models_*.py``).

The reference runs eagerly with ``scan_layers=False``, its own unrolled
path ("identical math, no while loops"): op by op, each bf16 op rounds to
bf16, as the port's ops do. Under ``lax.scan`` (its default) XLA compiles
each period and may skip those roundings (``xla_allow_excess_precision``),
so the scanned realization is held only through the loss, at a looser
tolerance (:func:`check_scanned_loss`).

Tolerances, in bf16 ulps (2^-8 relative) of the largest magnitude of the
reference's output:
- logits of ``forward``, ``prefill`` and ``decode_step``: 4 ulps (fp32
  exp/tanh/rsqrt/softplus round an ulp apart and an ulp now and then
  crosses a bf16 rounding boundary);
- the loss: 2^-10 of its value;
- gradients, read off the train step's first AdamW moment (``mu`` = 0.1 x
  the clipped gradient): each leaf's error within 2^-5 of that leaf's norm
  (the backward multiplies in bf16, and XLA's transpose rules and autograd
  round cotangents to bf16 at other points);
- the new parameters: within 2 x lr (a first AdamW step moves a weight by
  lr x g / |g|, so a tiny gradient whose sign differs moves it the other
  way) plus lr x weight decay x |w|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import model as JM
from repro.training import train_loop as JTL
from repro_torch.models import model as TM
from repro_torch.training import train_loop as TTL

from _smoke_archs import SMOKES
from _torch_archs import TORCH_SMOKES

B, S, EXTRA = 2, 8, 4
LOGIT_ULPS = 4
LR, WD = 3e-4, 0.1


def make_batch(cfg, seed=0):
    """numpy inputs for a smoke configuration (embeddings for the
    frontends, source embeddings for the encoder-decoder)."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.enc_dec:
        b["src_embeddings"] = rng.normal(size=(B, S, cfg.d_model))
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S))
    elif cfg.frontend != "none":
        b["embeddings"] = rng.normal(size=(B, S, cfg.d_model))
    else:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S))
    b["labels"] = rng.integers(0, cfg.vocab, (B, S))
    return {k: v.astype(np.float32 if v.dtype.kind == "f" else np.int32)
            for k, v in b.items()}


def to_jax(b):
    return {k: jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32
            else jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.as_tensor(v).bfloat16() if v.dtype == np.float32
            else torch.as_tensor(v) for k, v in b.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def flat(tree, path=()):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (k,)))
        return out
    return {"/".join(path): tree}


def run_pair(arch):
    """Everything the tests compare, computed once a configuration: the
    reference's unrolled eager outputs and the port's on the same inputs
    and weights."""
    cfg = dataclasses.replace(SMOKES[arch], scan_layers=False)
    tcfg = TORCH_SMOKES[arch]
    jp, _ = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    b = make_batch(cfg)
    pf = {k: v for k, v in b.items() if k != "labels"}
    dec = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab, (B, 1)).astype(np.int32)}
    if cfg.enc_dec:
        dec["enc_out"] = np.random.default_rng(2).normal(
            size=(B, S, cfg.d_model)).astype(np.float32)
    out = {"cfg": cfg, "tcfg": tcfg, "batch": b}

    out["forward"] = (_np(JM.forward(jp, cfg, to_jax(b), remat=False)[0]),
                      _np(TM.forward(tp, tcfg, to_torch(b), remat=False)[0]))
    jl, jc = JM.prefill(jp, cfg, to_jax(pf), max_seq=S + EXTRA)
    tl, tc = TM.prefill(tp, tcfg, to_torch(pf), max_seq=S + EXTRA)
    out["prefill"] = (_np(jl), _np(tl))
    out["caches"] = ([_np(x) for x in jax.tree.leaves(jc)],
                     [_np(x) for x in jax.tree.leaves(tc)])
    out["decode"] = (_np(JM.decode_step(jp, cfg, jc, to_jax(dec))[0]),
                     _np(TM.decode_step(tp, tcfg, tc, to_torch(dec))[0]))

    js, jm = JTL.make_train_step(cfg, base_lr=LR, warmup=0,
                                 weight_decay=WD)(JTL.init_state(jp),
                                                  to_jax(b))
    ts, tm = TTL.make_train_step(tcfg, base_lr=LR, warmup=0,
                                 weight_decay=WD)(TTL.init_state(tp),
                                                  to_torch(b))
    out["metrics"] = ({k: float(v) for k, v in jm.items()},
                      {k: float(v) for k, v in tm.items()})
    out["state"] = (js, ts)
    out["params0"] = jp
    return out


def check_logits(pair, ulps=LOGIT_ULPS):
    ref, got = pair
    assert ref.shape == got.shape
    tol = ulps * 2.0 ** -8 * float(np.abs(ref).max())
    err = float(np.abs(ref - got).max())
    assert err <= tol, (err, tol)
    assert np.isfinite(got).all()


def check_caches(out):
    ref, got = out["caches"]
    assert [r.shape for r in ref] == [g.shape for g in got]
    for r, g in zip(ref, got):
        tol = LOGIT_ULPS * 2.0 ** -8 * max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(r - g).max()) <= tol


def check_loss(out):
    ref, got = out["metrics"]
    assert abs(ref["loss"] - got["loss"]) <= 2.0 ** -10 * abs(ref["loss"])
    assert ref["lr"] == got["lr"]
    assert abs(ref["grad_norm"] - got["grad_norm"]) <= \
        2.0 ** -5 * ref["grad_norm"]


def check_grads_and_step(out, step=1, move=2 * LR):
    """Gradients (through mu) and the new parameters and moments after
    AdamW step ``step``; ``move`` bounds how far apart two updates whose
    gradients differ can move a weight (2 lr on a first step, where an
    update is lr x g / |g|)."""
    js, ts = out["state"]
    assert int(js.step) == int(ts.step) == step
    assert int(js.opt.step) == int(ts.opt.step) == step
    jmu, tmu = flat(js.opt.mu), flat(ts.opt.mu)
    assert jmu.keys() == tmu.keys()
    for k in jmu:
        r, g = _np(jmu[k]), _np(tmu[k])
        norm = float(np.linalg.norm(r))
        assert float(np.linalg.norm(r - g)) <= 2.0 ** -5 * norm + 1e-30, k
    jnu, tnu = flat(js.opt.nu), flat(ts.opt.nu)
    for k in jnu:
        r, g = _np(jnu[k]), _np(tnu[k])
        assert float(np.linalg.norm(r - g)) <= \
            2.0 ** -4 * float(np.linalg.norm(r)) + 1e-30, k
    jp1, tp1, p0 = flat(js.params), flat(ts.params), flat(out["params0"])
    for k in jp1:
        tol = move + LR * WD * np.abs(_np(p0[k])) + 1e-7
        assert (np.abs(_np(jp1[k]) - _np(tp1[k])) <= tol).all(), k


def check_scanned_loss(arch):
    """The reference's default realization (periods under ``lax.scan``,
    jitted): the loss within 2^-8 of its value. XLA may keep a fused
    chain in fp32 where the port rounds each op to bf16, which can also
    flip a routing decision; the loss averages that over the tokens."""
    cfg, tcfg = SMOKES[arch], TORCH_SMOKES[arch]
    jp, _ = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    b = make_batch(cfg)
    ref = float(jax.jit(lambda p, x: JM.loss_fn(p, cfg, x)[0])(jp, to_jax(b)))
    got = float(TM.loss_fn(tp, tcfg, to_torch(b))[0])
    assert abs(ref - got) <= 2.0 ** -8 * abs(ref), (ref, got)
