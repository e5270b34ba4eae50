"""The port's LM modules (``repro_torch.models``: layers, ffn, attention,
ssm, xlstm, transformer, model) against the JAX package's, one module at a
time, on the same numpy inputs and the reference's own initial weights
carried across (``model.params_from_numpy``).

The reference runs eagerly here, op by op. Each of its bf16 ops rounds to
bf16, and the port's activations are written as the same elementary ops
(``layers.sigmoid``/``silu``/``gelu``), so most modules agree bit for bit;
where fp32 transcendentals (exp, tanh, rsqrt, softplus, cos/sin) or the
order of a sum differ by an ulp, the comparison is stated in bf16 ulps
(2^-8 relative) of the output's largest magnitude. The recurrent mixers
and the blocks are in ``test_torch_models_recurrent.py``, whole-model
parity in ``test_torch_models_*.py``, routing and B6 in
``test_torch_moe.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import ffn as jffn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro_torch.models import attention as tattn
from repro_torch.models import ffn as tffn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM

from _smoke_archs import FULL, SMOKES
from _torch_archs import TORCH_FULL, TORCH_SMOKES, port_cfg

ULP = 2.0 ** -8      # bf16's relative step


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(tree):
    return TM.params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _pair(a, dtype=np.float32):
    """The same numpy array as a JAX and a torch array (bf16 if asked)."""
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.as_tensor(a).bfloat16()
    return jnp.asarray(a), torch.as_tensor(a)


def assert_close_ulps(ref, got, ulps):
    """|got - ref| <= ulps bf16 steps of ref's largest magnitude."""
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape
    tol = ulps * ULP * float(np.abs(ref).max())
    err = float(np.abs(ref - got).max())
    assert err <= tol, (err, tol)


def assert_equal(ref, got):
    np.testing.assert_array_equal(_np(ref), _np(got))


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_dense_norm_embed_match_bit_for_bit():
    rng = _rng()
    p, _ = jlayers.dense_init(jax.random.PRNGKey(0), 48, 80, "a", "b")
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    jx, tx = _pair(x)
    assert_equal(jlayers.dense_apply(p, jx), tlayers.dense_apply(_t(p), tx))
    for kind in ("rmsnorm", "layernorm"):
        pn, _ = jlayers.norm_init(48, kind)
        pn = jax.tree.map(lambda a: a + jnp.asarray(
            rng.normal(size=a.shape), jnp.float32), pn)
        # fp32: the mean's order of adds and rsqrt round an fp32 ulp or
        # two apart (held within 2^-21 relative); bf16: bit for bit
        jx, tx = _pair(x)
        assert_close_ulps(jlayers.norm_apply(pn, jx, kind),
                          tlayers.norm_apply(_t(pn), tx, kind), 2.0 ** -13)
        jx, tx = _pair(x, "bf16")
        assert_equal(jlayers.norm_apply(pn, jx, kind),
                     tlayers.norm_apply(_t(pn), tx, kind))
    pe, _ = jlayers.embed_init(jax.random.PRNGKey(1), 100, 16)
    toks = rng.integers(0, 100, (4, 7)).astype(np.int32)
    assert_equal(jlayers.embed_apply(pe, jnp.asarray(toks)),
                 tlayers.embed_apply(_t(pe), torch.as_tensor(toks)))


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_splits_halves_like_the_reference(theta):
    """RoPE over (B, S, H, hd) at per-row positions; cos and sin of fp32
    angles may round an ulp apart, so fp32 within 2^-20 relative; in bf16
    the rounding agrees."""
    rng = _rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 9)).astype(np.int32)
    jp_, tp_ = _pair(pos)
    jx, tx = _pair(x)
    ref, got = jlayers.apply_rope(jx, jp_, theta), tlayers.apply_rope(tx, tp_, theta)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=2.0 ** -20 * 8)
    jx, tx = _pair(x, "bf16")
    assert_close_ulps(jlayers.apply_rope(jx, jp_, theta),
                      tlayers.apply_rope(tx, tp_, theta), 1)


@pytest.mark.parametrize("name", ["relu", "gelu", "silu"])
def test_activations_equal_in_bf16(name):
    """``jax.nn.gelu`` is the tanh form and ``silu`` is ``x * sigmoid(x)``
    op by op: torch's defaults (erf gelu, fused silu) differ on many bf16
    inputs; the port's elementary-op versions agree bit for bit."""
    x = (_rng(2).normal(size=(1 << 14,)) * 4).astype(np.float32)
    jx, tx = _pair(x, "bf16")
    assert_equal(jlayers.activation(name)(jx), tlayers.activation(name)(tx))
    gelu_erf = torch.nn.functional.gelu(tx.float())
    ref = _np(jax.nn.gelu(jnp.asarray(x)))
    if name == "gelu":   # the trouble the tanh form avoids
        assert np.abs(gelu_erf.numpy() - ref).max() > 1e-4


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu"])
def test_ffn_matches_bit_for_bit(kind):
    p, _ = jffn.ffn_init(jax.random.PRNGKey(3), 32, 72, kind)
    x = _rng(3).normal(size=(2, 6, 32)).astype(np.float32)
    jx, tx = _pair(x, "bf16")
    assert_equal(jffn.ffn_apply(p, jx, kind), tffn.ffn_apply(_t(p), tx, kind))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN = dict(n_heads=4, kv_heads=2, head_dim=12)


def _attn_params(d=32, seed=4):
    p, _ = jattn.attn_init(jax.random.PRNGKey(seed), d, ATTN["n_heads"],
                           ATTN["kv_heads"], ATTN["head_dim"])
    return p


@pytest.mark.parametrize("S,chunk_q,causal,theta", [
    (8, 1024, True, 10000.0), (16, 4, True, 10000.0), (12, 5, True, None),
    (8, 1024, False, None)])
def test_attention_full_and_chunked(S, chunk_q, causal, theta):
    """Full and chunked (S a multiple of chunk_q above it) GQA attention
    with the masked fp32 softmax: within 1 bf16 ulp of the output's
    largest magnitude (fp32 exp and the einsum's order of adds round apart
    before the final bf16 cast)."""
    p = _attn_params()
    x = _rng(5).normal(size=(2, S, 32)).astype(np.float32)
    jx, tx = _pair(x, "bf16")
    kw = dict(ATTN, causal=causal, rope_theta=theta, chunk_q=chunk_q)
    assert_close_ulps(jattn.attention(p, jx, **kw),
                      tattn.attention(_t(p), tx, **kw), 1)


def test_attention_cross_kv_override():
    p = _attn_params()
    rng = _rng(6)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    kv = rng.normal(size=(2, 7, 2, 12)).astype(np.float32)
    jx, tx = _pair(x, "bf16")
    jkv, tkv = _pair(kv, "bf16")
    kw = dict(ATTN, causal=False, rope_theta=None)
    assert_close_ulps(jattn.attention(p, jx, kv_override=(jkv, jkv), **kw),
                      tattn.attention(_t(p), tx, kv_override=(tkv, tkv), **kw),
                      1)


@pytest.mark.parametrize("S,chunk_q", [(6, 1024), (8, 4)])
def test_attention_prefill_then_decode_per_row(S, chunk_q):
    """Prefill writes the cache (bit for bit) and sets pos = S; decode
    scatters one entry a row at per-row positions (rows at different
    depths, as continuous batching leaves them) and masks past each row's
    position."""
    p = _attn_params()
    rng = _rng(7)
    x = rng.normal(size=(2, S, 32)).astype(np.float32)
    jx, tx = _pair(x, "bf16")
    kw = dict(ATTN, rope_theta=10000.0)
    jc = jattn.cache_init(2, S + 3, 2, 12)
    tc = tattn.cache_init(2, S + 3, 2, 12, device="cpu")
    jo, jc = jattn.attention_prefill(p, jx, jc, chunk_q=chunk_q, **kw)
    to, tc = tattn.attention_prefill(_t(p), tx, tc, chunk_q=chunk_q, **kw)
    assert_close_ulps(jo, to, 1)
    for a, b in zip(jc, tc):
        assert_equal(a, b)
    pos = np.asarray([S, S - 2], np.int32)          # rows at two depths
    jc = jc._replace(pos=jnp.asarray(pos))
    tc = tc._replace(pos=torch.as_tensor(pos))
    x1 = rng.normal(size=(2, 1, 32)).astype(np.float32)
    jx1, tx1 = _pair(x1, "bf16")
    jo, jc = jattn.attention_decode(p, jx1, jc, **kw)
    to, tc = tattn.attention_decode(_t(p), tx1, tc, **kw)
    assert_close_ulps(jo, to, 1)
    for a, b in zip(jc, tc):
        assert_equal(a, b)


# ---------------------------------------------------------------------------
# model: trees, shapes, counts, specs
# ---------------------------------------------------------------------------

def _structure(tree):
    """{path: (shape, dtype name)} of a parameter tree of either package."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out["/".join(path)] = (tuple(t.shape),
                                   str(t.dtype).replace("torch.", ""))
    walk(tree, ())
    return out


@pytest.mark.parametrize("arch", sorted(SMOKES))
def test_init_model_tree_shapes_dtypes_and_axes(arch):
    """The port's ``init_model`` gives the reference's tree: the same
    paths, leaf shapes and dtypes, and the same logical axes."""
    jp, ja = JM.init_model(jax.random.PRNGKey(0), SMOKES[arch])
    tp, ta = TM.init_model(torch.Generator().manual_seed(0),
                           TORCH_SMOKES[arch], device="cpu")
    assert _structure(tp) == _structure(jp)
    is_ax = lambda x: isinstance(x, tuple)  # noqa: E731
    ref_axes = {"/".join(str(getattr(k, "key", k)) for k in path): ax
                for path, ax in jax.tree_util.tree_flatten_with_path(
                    ja, is_leaf=is_ax)[0]}
    got_axes = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            got_axes["/".join(path)] = t
    walk(ta, ())
    assert got_axes == ref_axes


def test_full_width_moe_14b_shapes_on_meta():
    """Qwen1.5-MoE-A2.7B's dimensions (``FULL["moe-14b"]``) at full size
    on the ``meta`` device (nothing allocated) against
    ``jax.eval_shape`` of the reference's ``init_model``: the same tree,
    shapes and dtypes. ``param_count`` (the reference's formula, which
    leaves out the norms' scales) is 14,316,011,520; the tree holds those
    and the 49 scale vectors of 2,048."""
    ref = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0),
                                               FULL["moe-14b"])[0])
    tcfg = TORCH_FULL["moe-14b"]
    got, _ = TM.init_model(None, tcfg, device="meta")
    assert all(t.device.type == "meta" for t in jax.tree.leaves(got))
    assert _structure(got) == _structure(ref)
    n = sum(math.prod(t.shape) for t in jax.tree.leaves(got))
    assert tcfg.param_count() == FULL["moe-14b"].param_count() \
        == 14_316_011_520
    assert n == 14_316_011_520 + (2 * 24 + 1) * 2048
    assert tcfg.padded_vocab == 152_064


def test_param_count_and_padded_vocab_equal_the_reference():
    for name in list(SMOKES) + list(FULL):
        ref = {**SMOKES, **FULL}[name]
        got = port_cfg(ref)
        assert got.param_count() == ref.param_count()
        assert got.padded_vocab == ref.padded_vocab
        assert got.head_dim == ref.head_dim


@pytest.mark.parametrize("arch", ["dense-tied", "hybrid", "enc-dec-audio",
                                  "vlm"])
def test_input_specs_and_cache_specs_on_meta(arch):
    """``input_specs`` and ``cache_specs`` as ``meta`` tensors with the
    reference's ``ShapeDtypeStruct`` shapes and dtypes; ``cache_axes``
    equal to the reference's."""
    cfg, tcfg = SMOKES[arch], TORCH_SMOKES[arch]
    for shape in ("train", "prefill", "decode"):
        ref = JM.input_specs(cfg, shape, batch=3, seq=16)
        got = TM.input_specs(tcfg, shape, batch=3, seq=16)
        assert ref.keys() == got.keys()
        for k in ref:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == ref[k].shape
            assert str(got[k].dtype).replace("torch.", "") == str(ref[k].dtype)
    ref = JM.cache_specs(cfg, 3, 16)
    got = TM.cache_specs(tcfg, 3, 16)
    ref_l, got_l = jax.tree.leaves(ref), jax.tree.leaves(got)
    assert [tuple(t.shape) for t in got_l] == [t.shape for t in ref_l]
    assert [str(t.dtype).replace("torch.", "") for t in got_l] == \
        [str(t.dtype) for t in ref_l]
    assert all(t.device.type == "meta" for t in got_l)
    assert tuple(TM.cache_axes(tcfg)) == tuple(
        tuple(c) for c in JM.cache_axes(cfg))


def test_params_from_numpy_carries_any_tree():
    """Every leaf of a reference tree arrives equal, in its dtype, on the
    asked device; the port's forward then runs on it."""
    cfg = SMOKES["xlstm"]
    jp, _ = JM.init_model(jax.random.PRNGKey(2), cfg)
    tp = _t(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert b.device.type == "cpu" and b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    toks = torch.zeros((1, 4), dtype=torch.int32)
    logits, _ = TM.forward(tp, TORCH_SMOKES["xlstm"], {"tokens": toks})
    assert logits.shape == (1, 4, cfg.padded_vocab)
