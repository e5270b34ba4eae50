"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's: ``capacity``, ``route`` (packed words, gates, aux loss, dropped
count), ``moe_apply`` through B6's autograd gather, and its gradient.

- Integers are held exactly: ``capacity``, every routing word, the dropped
  count. Ties go to the lower expert index in both (a stable descending
  sort in the port, ``lax.top_k`` in the reference): all-zero logits (the
  reference's own uniform-routing case), logits drawn from a few values
  (ties in most rows), and Gaussian logits.
- Gates and the aux loss: fp32 softmax sums round apart by an fp32 ulp or
  two (held within 2^-20 relative).
- ``moe_apply``: the router logits are compared first and are equal, so
  the routing is the same by construction; the output within 1 bf16 ulp of
  its largest magnitude, the gradients within 2^-5 of each leaf's norm
  (bf16 backward).
- The gather's gradient (``kernels.moe_gather.MoEGather``) against
  ``jax.grad`` of the reference's inline gather (``xt[max(tok, 0)] *
  live``), with repeated tokens and empty slots: fp32 bit for bit; in bf16
  XLA's CPU scatter-add accumulates a row's contributions in another order
  (neither sequential nor in fp32), so a row of n contributions is held
  within the bound of two bf16 summation orders, 2 (n - 1) 2^-8 times the
  sum of their magnitudes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe


def _t(tree):
    return TM.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(**kw):
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


@pytest.mark.parametrize("T,E,k,cf", [(16, 8, 2, 1.25), (100, 60, 4, 1.25),
                                      (64, 2, 1, 0.5), (2048, 60, 4, 1.25),
                                      (7, 4, 2, 4.0)])
def test_capacity_is_the_references(T, E, k, cf):
    jc, tc = _cfgs(n_experts=E, top_k=k, expert_d_ff=8, capacity_factor=cf)
    assert tmoe.capacity(T, tc) == jmoe.capacity(T, jc)
    # Qwen1.5-MoE-A2.7B's width: a 4 x 512 prefill -> 176 slots an expert
    if (T, E, k) == (2048, 60, 4):
        assert tmoe.capacity(T, tc) == 176


def _logits(kind, T, E, seed):
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros((T, E), np.float32)
    if kind == "ties":      # a few bf16 values: ties in most rows
        return (rng.integers(-2, 3, (T, E)) * 0.5).astype(np.float32)
    return rng.normal(size=(T, E)).astype(np.float32)


@pytest.mark.parametrize("kind", ["zeros", "ties", "gauss"])
@pytest.mark.parametrize("T,E,k,cf", [(512, 8, 2, 1.25), (64, 2, 1, 0.5),
                                      (100, 60, 4, 1.25), (48, 4, 2, 4.0)])
def test_route_words_equal_the_references(kind, T, E, k, cf):
    jc, tc = _cfgs(n_experts=E, top_k=k, expert_d_ff=8, capacity_factor=cf)
    lg = _logits(kind, T, E, seed=T + E)
    cap = jmoe.capacity(T, jc)
    jw, jg, ja, jd = jmoe.route(jnp.asarray(lg), jc, cap)
    tw, tg, ta, td = tmoe.route(torch.as_tensor(lg), tc, cap)
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    assert int(jd) == int(td)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=2.0 ** -20,
                               atol=0)
    np.testing.assert_allclose(float(ta), float(ja), rtol=2.0 ** -20)
    if kind == "zeros" and T == 512:        # uniform routing: aux == 1
        assert abs(float(ta) - 1.0) < 0.05


def test_top_k_gives_ties_to_the_lower_index():
    """The trouble ``torch.topk`` has: on a row of equal probabilities it
    picks high indices; ``lax.top_k`` and the port pick 0, 1."""
    probs = np.full((1, 8), 0.125, np.float32)
    _, ref = jax.lax.top_k(jnp.asarray(probs), 2)
    _, got = tmoe.top_k(torch.as_tensor(probs), 2)
    assert np.asarray(ref).tolist() == got.tolist() == [[0, 1]]


@pytest.mark.parametrize("padded", [0, 10])
def test_moe_apply_and_its_gradient(padded):
    """``moe_apply`` (shared expert on) with the same weights and inputs:
    router logits equal, words equal, output within 1 bf16 ulp, aux within
    2^-20; gradients of a scalar of the output with respect to x and every
    weight within 2^-5 of each one's norm. ``padded``: experts padded to a
    bank count, whose masked logits never win."""
    kw = dict(n_experts=6, top_k=2, expert_d_ff=24, shared_d_ff=16,
              n_padded_experts=padded and 6 + padded)
    jc, tc = _cfgs(**kw)
    d = 16
    jp, _ = jmoe.moe_init(jax.random.PRNGKey(0), d, jc)
    tp = _t(jp)
    x = np.random.default_rng(1).normal(size=(2, 12, d)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).bfloat16()

    from repro.models.layers import dense_apply as jdense
    from repro_torch.models.layers import dense_apply as tdense
    np.testing.assert_array_equal(
        _np(jdense(jp["router"], jx.reshape(-1, d))),
        _np(tdense(tp["router"], tx.reshape(-1, d))))

    jo, ja = jmoe.moe_apply(jp, jx, jc)
    to, ta = tmoe.moe_apply(tp, tx, tc)
    ref = _np(jo)
    assert np.abs(ref - _np(to)).max() <= 2.0 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(float(ta), float(ja), rtol=2.0 ** -20)

    def jloss(p, x):
        o, a = jmoe.moe_apply(p, x, jc)
        return jnp.sum(jnp.square(o.astype(jnp.float32))) + a

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    leaves = jax.tree.leaves(tp)
    tp_g = jax.tree.unflatten(jax.tree.structure(tp),
                              [t.clone().requires_grad_(True) for t in leaves])
    tx_g = tx.clone().requires_grad_(True)
    o, a = tmoe.moe_apply(tp_g, tx_g, tc)
    loss = torch.sum(torch.square(o.float())) + a
    grads = torch.autograd.grad(loss, jax.tree.leaves(tp_g) + [tx_g])
    for r, g in zip(jax.tree.leaves(jgp) + [jgx], grads):
        r, g = _np(r), _np(g)
        assert np.linalg.norm(r - g) <= 2.0 ** -5 * np.linalg.norm(r) + 1e-30


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_gradient_equals_the_inline_gathers(dtype):
    """B6's autograd wrapper on the CPU: forward == the plain version ==
    ``xt[max(tok, 0)] * live``; backward == ``jax.grad`` of that inline
    gather (each live slot's row added into its token's row in slot order;
    an empty slot adds nothing, where the reference adds a zero row into
    row 0): fp32 bit for bit, bf16 within two summation orders' bound."""
    rng = np.random.default_rng(2)
    T, d, S = 10, 24, 40
    x = rng.normal(size=(T, d)).astype(np.float32)
    tok = rng.integers(-1, T, S).astype(np.int32)      # repeats and empties
    cot = rng.normal(size=(S, d)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)

    def inline(xt):
        live = tok >= 0
        return xt[jnp.maximum(tok, 0)] * jnp.asarray(live)[:, None].astype(
            xt.dtype)

    jx = jnp.asarray(x, jdt)
    ref_out, vjp = jax.vjp(inline, jx)
    (ref_grad,) = vjp(jnp.asarray(cot, jdt))
    tx = torch.as_tensor(x).to(tdt).requires_grad_(True)
    out = ops.moe_gather(tx, torch.as_tensor(tok))
    (grad,) = torch.autograd.grad(out, tx, torch.as_tensor(cot).to(tdt))
    np.testing.assert_array_equal(_np(out), _np(ref_out))
    if dtype == "float32":
        np.testing.assert_array_equal(_np(grad), _np(ref_grad))
    else:
        live = tok >= 0
        rows = np.where(live, tok, T)
        n = np.bincount(rows, minlength=T + 1)[:T, None]
        mag = np.zeros((T + 1, d), np.float32)
        np.add.at(mag, rows, np.abs(_np(torch.as_tensor(cot).to(tdt))))
        bound = 2 * np.maximum(n - 1, 0) * 2.0 ** -8 * mag[:T]
        assert (np.abs(_np(grad) - _np(ref_grad)) <= bound).all()
    assert ops.launch_counts["moe_gather"] == 0       # the CPU launches none
