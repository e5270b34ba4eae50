"""Block assembly and the stacked-period forward for every family of the
LM stack (port of ``repro.models.transformer``).

Depth is organized as (n_periods x block_pattern): the pattern is one
*period* of heterogeneous sublayers (e.g. the hybrid's  M M M M A M M M
with MoE on every 2nd layer); parameters of corresponding sublayers are
stacked across periods, with a leading ``n_periods`` axis on every leaf,
as in the reference. The reference scans over periods (``lax.scan``); the
port loops over them in Python, which is the same math.

Mixer kinds: 'attn' | 'mamba' | 'mlstm' | 'slstm'. FFN per layer: dense
(d_ff) or MoE (cfg.moe, every_k_layers). xLSTM layers have d_ff == 0.

Training remat: with ``cfg.remat != "none"`` each period runs under
``torch.utils.checkpoint`` (non-reentrant) and is recomputed in the
backward. The reference's policies ``dots`` and ``names`` save some
products; the port saves only the period's inputs, which recomputes more
but gives the same numbers.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..training.optimizer import _leaves, _map
from . import attention as attn
from . import ssm, xlstm
from .ffn import ffn_apply, ffn_init
from .layers import F32, norm_apply, norm_init
from .moe import moe_apply, moe_init


def _use_moe(cfg, layer_idx: int) -> bool:
    return cfg.moe is not None and (
        layer_idx % cfg.moe.every_k_layers == cfg.moe.every_k_layers - 1
    )


def _stack_trees(trees):
    """Stack equal-structure trees of tensors along a new leading axis."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(_stack_trees(list(xs)) for xs in zip(*trees)))
    if isinstance(t0, (list, tuple)):
        return type(t0)(_stack_trees(list(xs)) for xs in zip(*trees))
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# One sublayer (mixer + optional ffn/moe)
# ---------------------------------------------------------------------------

def block_init(gen, cfg, layer_idx: int, *, cross: bool = False, device):
    kind = cfg.block_pattern[layer_idx % len(cfg.block_pattern)]
    p, a = {}, {}
    p["norm1"], a["norm1"] = norm_init(cfg.d_model, cfg.norm, device=device)

    if kind == "attn":
        p["mixer"], a["mixer"] = attn.attn_init(
            gen, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim,
            device=device)
    elif kind == "mamba":
        p["mixer"], a["mixer"] = ssm.mamba_init(gen, cfg.d_model, cfg.mamba,
                                                device=device)
    elif kind == "mlstm":
        p["mixer"], a["mixer"] = xlstm.mlstm_init(gen, cfg.d_model,
                                                  cfg.n_heads, device=device)
    elif kind == "slstm":
        p["mixer"], a["mixer"] = xlstm.slstm_init(gen, cfg.d_model,
                                                  cfg.n_heads, device=device)
    else:
        raise ValueError(kind)

    if cross:  # encoder-decoder cross attention sublayer
        p["norm_x"], a["norm_x"] = norm_init(cfg.d_model, cfg.norm,
                                             device=device)
        p["cross"], a["cross"] = attn.attn_init(
            gen, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim,
            device=device)

    if _use_moe(cfg, layer_idx):
        p["norm2"], a["norm2"] = norm_init(cfg.d_model, cfg.norm,
                                           device=device)
        p["moe"], a["moe"] = moe_init(gen, cfg.d_model, cfg.moe, cfg.act,
                                      device=device)
    elif cfg.d_ff > 0:
        p["norm2"], a["norm2"] = norm_init(cfg.d_model, cfg.norm,
                                           device=device)
        p["ffn"], a["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                      device=device)
    return p, a


def block_apply(p, h, cfg, layer_idx: int, *, mode: str = "train",
                cache=None, cross_kv=None, causal: bool = True):
    """Returns (h, new_cache, aux_loss)."""
    kind = cfg.block_pattern[layer_idx % len(cfg.block_pattern)]
    aux = torch.zeros((), dtype=F32, device=h.device)
    x = norm_apply(p["norm1"], h, cfg.norm)
    new_cache = cache
    seq_chunk = getattr(cfg, "seq_chunk", 0)

    if kind == "attn":
        kw = dict(n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
                  head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
        if mode == "train":
            y = attn.attention(p["mixer"], x, causal=causal,
                               chunk_q=cfg.chunk_q, **kw)
        elif mode == "prefill":
            y, new_cache = attn.attention_prefill(p["mixer"], x, cache,
                                                  chunk_q=cfg.chunk_q, **kw)
        else:
            y, new_cache = attn.attention_decode(p["mixer"], x, cache, **kw)
    elif kind == "mamba":
        if mode == "train":
            y = ssm.mamba_apply(p["mixer"], x, cfg.mamba, seq_chunk=seq_chunk)
        elif mode == "prefill":
            y, new_cache = ssm.mamba_apply(p["mixer"], x, cfg.mamba,
                                           want_state=True)
        else:
            y, new_cache = ssm.mamba_decode(p["mixer"], x, cache, cfg.mamba)
    else:  # mlstm | slstm
        apply = xlstm.mlstm_apply if kind == "mlstm" else xlstm.slstm_apply
        y, new_cache = apply(
            p["mixer"], x, cfg.n_heads,
            cache=cache if mode == "decode" else None,
            want_state=(mode == "prefill"),
            seq_chunk=seq_chunk if mode == "train" else 0)
        if mode == "train":
            new_cache = cache

    h = h + y

    if "cross" in p and cross_kv is not None:
        xq = norm_apply(p["norm_x"], h, cfg.norm)
        y = attn.attention(
            p["cross"], xq, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim, causal=False, rope_theta=None,
            chunk_q=cfg.chunk_q, kv_override=cross_kv)
        h = h + y

    if "moe" in p:
        x2 = norm_apply(p["norm2"], h, cfg.norm)
        y, aux = moe_apply(p["moe"], x2, cfg.moe, cfg.act)
        h = h + y
    elif "ffn" in p:
        x2 = norm_apply(p["norm2"], h, cfg.norm)
        h = h + ffn_apply(p["ffn"], x2, cfg.act)
    return h, new_cache, aux


# ---------------------------------------------------------------------------
# Stacked periods
# ---------------------------------------------------------------------------

def stack_init(gen, cfg, n_layers: int, *, cross: bool = False, device):
    """Init all layers, stacked by period -> (params, axes).

    params = {"sub0": stacked tree, "sub1": ..., ...} with leading axis
    n_periods on every leaf. Each layer is drawn on ``device`` and copied
    into its period's slot, so the peak is the stack plus one layer.
    """
    plen = len(cfg.block_pattern)
    assert n_layers % plen == 0, (n_layers, cfg.block_pattern)
    n_periods = n_layers // plen

    params, axes_out = {}, {}
    for li in range(n_layers):
        p, a = block_init(gen, cfg, li, cross=cross, device=device)
        sub, period = f"sub{li % plen}", li // plen
        if li < plen:
            axes_out[sub] = _prefix_axes(a)
            params[sub] = _map(
                lambda t: t.new_empty((n_periods,) + tuple(t.shape)), p)
        _map(lambda dst, src: dst[period].copy_(src), params[sub], p)
        del p
    return params, axes_out


def _prefix_axes(a):
    """Prepend the 'layers' axis to every axes tuple of a block."""
    if isinstance(a, dict):
        return {k: _prefix_axes(v) for k, v in a.items()}
    return ("layers",) + tuple(a)


def stack_apply(params, h, cfg, *, mode: str = "train", caches=None,
                cross_kv=None, causal: bool = True, remat: bool = True):
    """Loop over periods -> (h, caches, aux). ``caches`` is the stacked
    (n_periods, ...) tuple of per-sublayer caches; ``cross_kv`` the (k, v)
    of the encoder, the same for every period (the reference broadcasts it
    over periods)."""
    plen = len(cfg.block_pattern)

    def period_body(h, aux, pp, cache_in):
        new_caches = []
        for j in range(plen):
            cj = None if cache_in is None else cache_in[j]
            h, cj_new, aux_j = block_apply(
                pp[f"sub{j}"], h, cfg, j, mode=mode, cache=cj,
                cross_kv=cross_kv, causal=causal)
            aux = aux + aux_j
            new_caches.append(cj_new)
        return h, aux, tuple(new_caches)

    use_remat = remat and mode == "train" and cfg.remat != "none"
    n_periods = _leaves(params)[0].shape[0]
    aux = torch.zeros((), dtype=F32, device=h.device)
    caches_out = []
    for i in range(n_periods):
        pp = _map(lambda t: t[i], params)
        cache_i = None if caches is None else _map(lambda t: t[i], caches)
        if use_remat:
            h, aux, c_out = checkpoint(period_body, h, aux, pp, cache_i,
                                       use_reentrant=False)
        else:
            h, aux, c_out = period_body(h, aux, pp, cache_i)
        caches_out.append(c_out)
    if caches is None:
        return h, None, aux
    return h, _stack_trees(caches_out), aux

