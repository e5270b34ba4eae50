"""The port's LM train step, int8 gradient compression and token stream
against the JAX package's (``repro_torch.training.train_loop``,
``training/grad_compress.py``, ``data/pipeline.py``'s ``TokenStream`` and
``Prefetcher``).

- ``compress_decompress`` / ``ef_step`` / ``init_residual``: bit for bit
  (round half to even in both; every other op one IEEE fp32 operation).
- ``make_train_step`` from the reference's weights (and, once, from its
  whole ``TrainState``, AdamW moments included, carried across), eager and
  unrolled on the reference's side: microbatches, ``grad_compression=
  "int8"``, at ``tests/_lm_parity.py``'s tolerances; microbatches 2
  against 1 in the port within the reference's own 5e-3; a
  ``DataMesh(("cpu",) * 2)`` step against the one-device step.
- ``TokenStream``: the reference's ids, integer for integer, host shards
  included; ``Prefetcher`` order and bound.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.training import grad_compress as jgc
from repro.training import train_loop as JTL
from repro_torch.data import pipeline as tpipe
from repro_torch.models import model as TM
from repro_torch.parallel.mesh import DataMesh
from repro_torch.training import grad_compress as tgc
from repro_torch.training import train_loop as TTL
from repro_torch.training.optimizer import AdamWState

import _lm_parity as P
from _smoke_archs import SMOKES
from _torch_archs import TORCH_SMOKES


def _tree(shapes, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.normal(size=shapes[0]) * scale).astype(np.float32)},
            "b": (rng.normal(size=shapes[1]) * scale).astype(np.float32)}


def _t(tree):
    return TM.params_from_numpy(tree, "cpu")


def _leaves_np(tree):
    return [np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                       else x) for x in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_compress_decompress_is_bit_equal(scale):
    g = _tree(((17, 33), (64,)), seed=3, scale=scale)
    ref = jgc.compress_decompress(jax.tree.map(jnp.asarray, g))
    got = tgc.compress_decompress(_t(g))
    for r, t in zip(_leaves_np(ref), _leaves_np(got)):
        np.testing.assert_array_equal(r, t)


def test_ef_step_is_bit_equal_over_steps():
    """Ten error-feedback steps: decompressed gradients and residuals equal
    the reference's at every step."""
    jres = jgc.init_residual(jax.tree.map(jnp.asarray, _tree(((8, 9), (5,)), 0)))
    tres = tgc.init_residual(_t(_tree(((8, 9), (5,)), 0)))
    for r, t in zip(_leaves_np(jres), _leaves_np(tres)):
        assert r.shape == t.shape and not t.any()
    for step in range(10):
        g = _tree(((8, 9), (5,)), seed=10 + step, scale=1e-3)
        jdq, jres = jgc.ef_step(jax.tree.map(jnp.asarray, g), jres)
        tdq, tres = tgc.ef_step(_t(g), tres)
        for r, t in zip(_leaves_np(jdq) + _leaves_np(jres),
                        _leaves_np(tdq) + _leaves_np(tres)):
            np.testing.assert_array_equal(r, t)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _ref_step(cfg, jstate, batch, **kw):
    cfg = dataclasses.replace(cfg, scan_layers=False)
    return JTL.make_train_step(cfg, base_lr=P.LR, warmup=0,
                               weight_decay=P.WD, **kw)(jstate, P.to_jax(batch))


def _port_step(tcfg, tstate, batch, **kw):
    return TTL.make_train_step(tcfg, base_lr=P.LR, warmup=0,
                               weight_decay=P.WD, **kw)(tstate,
                                                        P.to_torch(batch))


def _compare(jout, tout, params0, **kw):
    (js, jm), (ts, tm) = jout, tout
    P.check_loss({"metrics": ({k: float(v) for k, v in jm.items()},
                              {k: float(v) for k, v in tm.items()})})
    P.check_grads_and_step({"state": (js, ts), "params0": params0}, **kw)


@pytest.fixture(scope="module")
def dense():
    cfg = SMOKES["dense-tied"]
    jp, _ = JM.init_model(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    return cfg, jp, batch


@pytest.mark.parametrize("micro,compression", [(2, None), (1, "int8"),
                                               (2, "int8")])
def test_train_step_matches_the_reference(dense, micro, compression):
    cfg, jp, batch = dense
    cfg = dataclasses.replace(cfg, microbatches=micro)
    tcfg = dataclasses.replace(TORCH_SMOKES["dense-tied"], microbatches=micro)
    jout = _ref_step(cfg, JTL.init_state(jp), batch,
                     grad_compression=compression)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tout = _port_step(tcfg, TTL.init_state(tp), batch,
                      grad_compression=compression)
    _compare(jout, tout, jp)


def test_int8_step_applies_compress_decompress():
    """``grad_compression="int8"`` is ``compress_decompress`` applied to the
    step's gradients, then AdamW: the same step done by hand gives the
    same state bit for bit."""
    from repro_torch.training.optimizer import adamw_update, cosine_schedule

    tcfg = TORCH_SMOKES["dense-tied"]
    params, _ = TM.init_model(torch.Generator().manual_seed(1), tcfg,
                              device="cpu")
    rng = np.random.default_rng(1)
    batch = {k: torch.as_tensor(rng.integers(0, tcfg.vocab, (2, 8)),
                                dtype=torch.int32) for k in ("tokens", "labels")}
    state = TTL.init_state(params)
    got, m = TTL.make_train_step(tcfg, warmup=0, grad_compression="int8")(
        state, batch)
    loss, grads = TTL.value_and_grad(tcfg, params, batch)
    grads = tgc.compress_decompress(grads)
    lr = cosine_schedule(state.step, base_lr=3e-4, warmup=0, total=10_000)
    want, _ = adamw_update(params, grads, state.opt, lr=lr, weight_decay=0.1)
    for a, b in zip(jax.tree.leaves(got.params), jax.tree.leaves(want)):
        assert torch.equal(a, b)
    assert torch.equal(m["loss"], loss)


def test_microbatches_match_one_batch_in_the_port(dense):
    """The reference's own criterion (``tests/test_training.py``):
    microbatches 2 against 1, loss and every parameter within 5e-3."""
    cfg, jp, batch = dense
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    base = TORCH_SMOKES["dense-tied"]
    s1, m1 = _port_step(base, TTL.init_state(tp), batch)
    s2, m2 = _port_step(dataclasses.replace(base, microbatches=2),
                        TTL.init_state(tp), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-3
    for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
        assert float((a - b).abs().max()) < 5e-3


def test_train_state_carried_across_continues_like_the_reference(dense):
    """One reference step, its whole TrainState (params, AdamW step, mu,
    nu, step) carried across, then a second step in each package."""
    cfg, jp, batch = dense
    js, _ = _ref_step(cfg, JTL.init_state(jp), batch)
    ts = TTL.TrainState(
        params=TM.params_from_numpy(jax.tree.map(np.asarray, js.params),
                                    "cpu"),
        opt=AdamWState(
            step=torch.as_tensor(np.array(js.opt.step)),
            mu=TM.params_from_numpy(jax.tree.map(np.asarray, js.opt.mu),
                                    "cpu"),
            nu=TM.params_from_numpy(jax.tree.map(np.asarray, js.opt.nu),
                                    "cpu")),
        step=torch.as_tensor(np.array(js.step)))
    jout = _ref_step(cfg, js, batch)
    tout = _port_step(TORCH_SMOKES["dense-tied"], ts, batch)
    # a second AdamW update is at most ~1.3 lr per weight (|m^| / sqrt(v^)
    # over two steps), so two of them lie within 3 lr
    _compare(jout, tout, js.params, step=2, move=3 * P.LR)


@pytest.mark.parametrize("B", [4, 3])
def test_data_mesh_step_matches_one_device(B):
    """``mesh=DataMesh(("cpu",) * 2)``: each shard's loss and gradients on
    its device, averaged on the first. B = 4 splits 2 x 2; B = 3 does not
    divide, so both shards take the whole batch (the reference replicates
    over such axes). Held against the one-device step: the loss within
    2^-20 relative, the new parameters within 2 x lr (a first AdamW step
    moves a weight by about lr x sign of its gradient)."""
    tcfg = TORCH_SMOKES["dense-untied"]
    params, _ = TM.init_model(torch.Generator().manual_seed(2), tcfg,
                              device="cpu")
    rng = np.random.default_rng(2)
    batch = {k: torch.as_tensor(rng.integers(0, tcfg.vocab, (B, 8)),
                                dtype=torch.int32) for k in ("tokens", "labels")}
    step = dict(warmup=0)
    s1, m1 = TTL.make_train_step(tcfg, **step)(TTL.init_state(params), batch)
    s2, m2 = TTL.make_train_step(tcfg, mesh=DataMesh(("cpu",) * 2), **step)(
        TTL.init_state(params), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= \
        2.0 ** -20 * float(m1["loss"])
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) <= \
        2.0 ** -5 * float(m1["grad_norm"])
    for a, b in zip(jax.tree.leaves(s1.params), jax.tree.leaves(s2.params)):
        assert float((a - b).abs().max()) <= 2 * 3e-4 + 1e-7
    if B == 3:   # replicated: both shards computed the same whole batch
        for a, b in zip(jax.tree.leaves(s1.params),
                        jax.tree.leaves(s2.params)):
            assert torch.equal(a, b)


def test_state_axes_mirror_params():
    _, axes = TM.init_model(None, TORCH_SMOKES["moe"], device="meta")
    sa = TTL.state_axes(axes)
    _, jaxes = JM.init_model(jax.random.PRNGKey(0), SMOKES["moe"])
    jsa = JTL.state_axes(jaxes)
    assert sa.opt.mu == sa.params == sa.opt.nu == axes
    assert sa.step == jsa.step == () and sa.opt.step == jsa.opt.step == ()


# ---------------------------------------------------------------------------
# TokenStream, Prefetcher
# ---------------------------------------------------------------------------

STREAM = dict(seed=5, corpus_tokens=20_000)


def test_token_stream_ids_equal_the_references():
    ref = jpipe.TokenStream(128, 16, 4, **STREAM)
    got = tpipe.TokenStream(128, 16, 4, device="cpu", **STREAM)
    for step in (0, 7, 1000):
        r, g = ref.batch(step), got.batch(step)
        for k in ("tokens", "labels"):
            assert g[k].dtype == torch.int32 and g[k].device.type == "cpu"
            np.testing.assert_array_equal(np.asarray(r[k]), g[k].numpy())
        np.testing.assert_array_equal(g["tokens"][:, 1:].numpy(),
                                      g["labels"][:, :-1].numpy())
    for r, g in zip(itertools.islice(ref, 3), itertools.islice(got, 3)):
        np.testing.assert_array_equal(np.asarray(r["tokens"]),
                                      g["tokens"].numpy())


def test_token_stream_host_shards_slice_the_global_batch():
    full = tpipe.TokenStream(128, 16, 4, device="cpu", **STREAM).batch(3)
    parts = [tpipe.TokenStream(128, 16, 4, host_index=h, num_hosts=2,
                               device="cpu", **STREAM).batch(3)
             for h in (0, 1)]
    ref = jpipe.TokenStream(128, 16, 4, host_index=1, num_hosts=2,
                            **STREAM).batch(3)
    np.testing.assert_array_equal(
        torch.cat([p["tokens"] for p in parts]).numpy(),
        full["tokens"].numpy())
    np.testing.assert_array_equal(np.asarray(ref["tokens"]),
                                  parts[1]["tokens"].numpy())


def test_prefetcher_keeps_order_and_its_bound():
    pulled = []

    def source():
        for i in range(7):
            pulled.append(i)
            yield i

    pf = tpipe.Prefetcher(source(), depth=2)
    assert pf.q.maxsize == 2
    assert list(pf) == list(range(7)) == pulled
    stream = tpipe.TokenStream(64, 8, 2, device="cpu", **STREAM)
    got = list(itertools.islice(tpipe.Prefetcher(iter(stream), depth=3), 4))
    for step, b in enumerate(got):
        assert torch.equal(b["tokens"], stream.batch(step)["tokens"])
