"""ArchConfig and the full-model functions: init, forward, loss, serving
steps, stand-in specs (port of ``repro.models.model``).

    cfg = ArchConfig(...)
    params, axes = init_model(torch.Generator("cuda").manual_seed(0), cfg)
    logits, aux = forward(params, cfg, {"tokens": tokens})
    logits, caches = prefill(params, cfg, {"tokens": prompt}, max_seq=...)
    logits, caches = decode_step(params, cfg, caches, {"tokens": nxt})

Parameters are nested dicts of tensors whose leaves under ``decoder`` /
``encoder`` carry a leading ``n_periods`` axis, the reference's tree;
:func:`params_from_numpy` carries the reference's parameters across. The
functions run on the device of the tensors they are given; ``init_model``
and ``init_cache`` take an explicit ``device`` (``None``: the card).

The reference's sharding constraints (``constrain``) are the identity
while no resolver is active; the port has no placement resolver, so it
calls none.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..training.optimizer import _map
from . import attention as attn_mod
from . import ssm as ssm_mod
from . import transformer, xlstm as xlstm_mod
from .layers import BF16, F32, dense_init, embed_apply, embed_init, \
    norm_apply, norm_init
from .moe import MoEConfig
from .ssm import MambaConfig


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    act: str = "swiglu"
    norm: str = "rmsnorm"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    block_pattern: tuple = ("attn",)
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: str = "none"      # none | vision | audio (stub embeddings)
    sub_quadratic: bool = False
    # execution knobs
    remat: str = "full"
    microbatches: int = 1
    chunk_q: int = 1024
    scan_layers: bool = True    # the port always loops over periods
    seq_chunk: int = 0          # >0: remat recurrent scans every seq_chunk
    param_dtype: Any = torch.float32
    source: str = ""            # provenance note

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, 256)

    def param_count(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        d, hd = self.d_model, self.head_dim
        total = self.padded_vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        for i in range(self.n_layers):
            kind = self.block_pattern[i % len(self.block_pattern)]
            if kind == "attn":
                total += d * hd * (self.n_heads + 2 * self.kv_heads) + \
                    self.n_heads * hd * d
            elif kind == "mamba":
                m = self.mamba
                dtr = -(-d // 16)
                total += d * 2 * m.d_inner + m.d_conv * m.d_inner + m.d_inner
                total += m.d_inner * (dtr + 2 * m.d_state) + dtr * m.d_inner
                total += m.d_inner * (2 + m.d_state) + m.d_inner * d
            elif kind == "mlstm":
                du = 2 * d
                total += d * 2 * du + 4 * du + du * du * 4 + \
                    du * 2 * self.n_heads
                total += du * d + du
            elif kind == "slstm":
                hd_s = d // self.n_heads
                ff = int(4 / 3 * d)
                total += d * 4 * d + self.n_heads * hd_s * 4 * hd_s + 4 * d
                total += d + 2 * d * ff + ff * d
            if transformer._use_moe(self, i):
                m = self.moe
                total += d * m.n_experts
                total += m.n_experts * 3 * d * m.expert_d_ff
                if m.shared_d_ff:
                    total += 3 * d * m.shared_d_ff
            elif self.d_ff > 0:
                mult = 3 if self.act in ("swiglu", "geglu") else 2
                total += mult * d * self.d_ff
        return total


# ---------------------------------------------------------------------------
# Init and weights carried across
# ---------------------------------------------------------------------------

def init_model(gen, cfg: ArchConfig, *, device=None):
    """Returns (params, axes), parallel trees. ``gen`` is a
    ``torch.Generator`` on ``device``'s type (a CUDA one for the card);
    ``device="meta"`` allocates nothing (shapes and dtypes only)."""
    device = resolve_device(device)
    params, axes = {}, {}
    params["embed"], axes["embed"] = embed_init(gen, cfg.padded_vocab,
                                                cfg.d_model, device=device)
    params["final_norm"], axes["final_norm"] = norm_init(
        cfg.d_model, cfg.norm, device=device)
    if not cfg.tie_embeddings:
        params["head"], axes["head"] = dense_init(
            gen, cfg.d_model, cfg.padded_vocab, "embed", "vocab",
            device=device)
    params["decoder"], axes["decoder"] = transformer.stack_init(
        gen, cfg, cfg.n_layers, cross=cfg.enc_dec, device=device)
    if cfg.enc_dec:
        params["encoder"], axes["encoder"] = transformer.stack_init(
            gen, cfg, cfg.n_enc_layers or cfg.n_layers, cross=False,
            device=device)
        params["enc_norm"], axes["enc_norm"] = norm_init(
            cfg.d_model, cfg.norm, device=device)
    return params, axes


def params_from_numpy(tree, device=None):
    """The reference's parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's, on ``device``."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


# ---------------------------------------------------------------------------
# Forward and loss
# ---------------------------------------------------------------------------

def _logits(params, cfg, h):
    if cfg.tie_embeddings:
        return h.to(BF16) @ params["embed"]["emb"].to(BF16).T
    return h.to(BF16) @ params["head"]["w"].to(BF16)


def _embed_inputs(params, cfg, batch):
    """Token ids or precomputed frontend embeddings -> (B, S, d)."""
    if "embeddings" in batch:      # vlm / audio-encoder stub path
        return batch["embeddings"].to(BF16)
    return embed_apply(params["embed"], batch["tokens"])


def _cross_kv(cfg, enc):
    """Cross-attention K = V: the encoder's hidden states reshaped into
    kv heads, unprojected, as the reference takes them."""
    B, Se, d = enc.shape
    kv = enc.reshape(B, Se, cfg.kv_heads, d // cfg.kv_heads)
    kv = kv[..., : cfg.head_dim]
    return (kv, kv)


def _encode(params, cfg, src, remat):
    enc, _, _ = transformer.stack_apply(
        params["encoder"], src.to(BF16), cfg, mode="train", causal=False,
        remat=remat)
    return norm_apply(params["enc_norm"], enc, cfg.norm)


def forward(params, cfg: ArchConfig, batch, *, remat: bool = True):
    """Training forward -> (logits (B, S, padded_vocab), aux_loss)."""
    cross_kv = None
    if cfg.enc_dec:
        enc = _encode(params, cfg, batch["src_embeddings"], remat)
        h = embed_apply(params["embed"], batch["tokens"])
        cross_kv = _cross_kv(cfg, enc)
    else:
        h = _embed_inputs(params, cfg, batch)
    h, _, aux = transformer.stack_apply(
        params["decoder"], h, cfg, mode="train", cross_kv=cross_kv,
        remat=remat)
    h = norm_apply(params["final_norm"], h, cfg.norm)
    return _logits(params, cfg, h), aux


def loss_fn(params, cfg: ArchConfig, batch, *, remat: bool = True):
    """Next-token cross-entropy (padded-vocab masked) + MoE aux loss."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    labels = batch["labels"].long()
    logits = logits.to(F32)
    if cfg.padded_vocab != cfg.vocab:
        logits = torch.cat([
            logits[..., : cfg.vocab],
            torch.full(logits.shape[:-1] + (cfg.padded_vocab - cfg.vocab,),
                       -1e9, dtype=F32, device=logits.device)], dim=-1)
    logp = torch.log_softmax(logits, -1)
    tok_ll = torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(F32)
    ce = -(tok_ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *, device=None):
    """Stacked (n_periods, ...) cache tree for decode: a tuple with one
    cache a sublayer of the period."""
    device = resolve_device(device)
    n_periods = cfg.n_layers // len(cfg.block_pattern)
    subs = []
    for kind in cfg.block_pattern:
        if kind == "attn":
            c = attn_mod.cache_init(batch, max_seq, cfg.kv_heads,
                                    cfg.head_dim, device=device)
        elif kind == "mamba":
            c = ssm_mod.mamba_cache_init(batch, cfg.mamba, device=device)
        elif kind == "mlstm":
            c = xlstm_mod.mlstm_cache_init(batch, cfg.d_model, cfg.n_heads,
                                           device=device)
        else:
            c = xlstm_mod.slstm_cache_init(batch, cfg.d_model, device=device)
        subs.append(c)
    return _map(lambda x: x[None].expand((n_periods,) + tuple(x.shape)).clone(),
                tuple(subs))


def cache_axes(cfg: ArchConfig):
    subs = []
    for kind in cfg.block_pattern:
        if kind == "attn":
            c = attn_mod.cache_axes()
        elif kind == "mamba":
            c = ssm_mod.mamba_cache_axes()
        elif kind == "mlstm":
            c = xlstm_mod.mlstm_cache_axes()
        else:
            c = xlstm_mod.slstm_cache_axes()
        subs.append(type(c)(*(("layers",) + tuple(ax) for ax in c)))
    return tuple(subs)


def decode_step(params, cfg: ArchConfig, caches, batch):
    """One-token decode. batch: {'tokens': (B, 1)} or {'embeddings':
    (B, 1, d)} (+ 'enc_out' for enc-dec) -> (logits (B, vocab), caches)."""
    h = _embed_inputs(params, cfg, batch)
    cross_kv = None
    if cfg.enc_dec:
        cross_kv = _cross_kv(cfg, batch["enc_out"].to(BF16))
    h, caches, _ = transformer.stack_apply(
        params["decoder"], h, cfg, mode="decode", caches=caches,
        cross_kv=cross_kv, remat=False)
    h = norm_apply(params["final_norm"], h, cfg.norm)
    logits = _logits(params, cfg, h)[:, 0, : cfg.vocab]
    return logits.to(F32), caches


def prefill(params, cfg: ArchConfig, batch, max_seq: int | None = None):
    """Prefill the cache from a prompt -> (last-token logits, caches)."""
    cross_kv = None
    if cfg.enc_dec:
        enc = _encode(params, cfg, batch["src_embeddings"], False)
        cross_kv = _cross_kv(cfg, enc)
    h = _embed_inputs(params, cfg, batch)
    B, S = h.shape[:2]
    caches = init_cache(cfg, B, max_seq or S, device=h.device)
    h, caches, _ = transformer.stack_apply(
        params["decoder"], h, cfg, mode="prefill", caches=caches,
        cross_kv=cross_kv, remat=False)
    h = norm_apply(params["final_norm"], h[:, -1:], cfg.norm)
    logits = _logits(params, cfg, h)[:, 0, : cfg.vocab]
    return logits.to(F32), caches


# ---------------------------------------------------------------------------
# Input specs: stand-ins on the meta device (no allocation)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape_name: str, *, batch: int, seq: int):
    """``meta``-device stand-ins for every model input of a shape cell
    (torch's counterpart of ``jax.ShapeDtypeStruct``)."""
    def f(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    d = cfg.d_model
    if shape_name.startswith("train"):
        if cfg.enc_dec:
            return {"src_embeddings": f((batch, seq, d), BF16),
                    "tokens": f((batch, seq), i32),
                    "labels": f((batch, seq), i32)}
        if cfg.frontend in ("vision", "audio"):
            return {"embeddings": f((batch, seq, d), BF16),
                    "labels": f((batch, seq), i32)}
        return {"tokens": f((batch, seq), i32), "labels": f((batch, seq), i32)}

    if shape_name.startswith("prefill"):
        if cfg.enc_dec:
            return {"src_embeddings": f((batch, seq, d), BF16),
                    "tokens": f((batch, seq), i32)}
        if cfg.frontend in ("vision", "audio"):
            return {"embeddings": f((batch, seq, d), BF16)}
        return {"tokens": f((batch, seq), i32)}

    # decode shapes: one new token (text id) against a seq-long cache
    spec = {"tokens": f((batch, 1), i32)}
    if cfg.enc_dec:
        spec["enc_out"] = f((batch, seq, d), BF16)
    return spec


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int):
    """The decode cache's shapes and dtypes, on the meta device."""
    return init_cache(cfg, batch, max_seq, device="meta")
