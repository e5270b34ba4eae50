"""Mixture-of-Experts with capacity-bounded, sort-based dispatch (port of
``repro.models.moe``).

Tokens are *events*; each expert's capacity buffer is a fixed-depth
*queue*; overflowing events are dropped and counted; the routing table is
a vector of packed words ``(token << RANK_BITS) | rank`` with -1 for an
empty slot. The dispatch gather is B6 (``kernels.ops.moe_gather``: the
Hopper kernel ``csrc/moe_gather.cu`` on the card, its plain version on the
CPU, differentiable in the tokens), where the reference gathers inline
(``xt[max(tok, 0)] * live``); the combine is an ``index_add`` into a
sentinel row ``T``, as the reference's scatter-add.

Top-k is a stable descending sort cut to k: ``torch.topk`` does not give
ties to the lower expert index, as ``jax.lax.top_k`` does, and bf16 router
logits tie often.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels import ops
from .ffn import ffn_apply, ffn_init
from .layers import BF16, F32, dense_apply, dense_init, normal, silu

RANK_BITS = 3  # top-k <= 8
INVALID_WORD = -1


class MoEConfig(NamedTuple):
    n_experts: int
    top_k: int
    expert_d_ff: int
    shared_d_ff: int = 0          # 0 = no shared expert path
    capacity_factor: float = 1.25
    every_k_layers: int = 1       # MoE replaces dense FFN every k-th layer
    n_padded_experts: int = 0     # pad the expert stack (e.g. 60 -> 64)

    @property
    def e_pad(self) -> int:
        return self.n_padded_experts or self.n_experts


def moe_init(gen, d_model: int, cfg: MoEConfig, kind: str = "swiglu", *,
             device):
    E, ff = cfg.e_pad, cfg.expert_d_ff
    p, a = {}, {}
    p["router"], a["router"] = dense_init(gen, d_model, E, "embed", None,
                                          device=device)

    def stack(shape_in, shape_out, ax_in, ax_out):
        w = normal(gen, (E, shape_in, shape_out), device) / math.sqrt(shape_in)
        return {"w": w}, {"w": ("experts", ax_in, ax_out)}

    p["wg"], a["wg"] = stack(d_model, ff, "embed", "mlp")
    p["wu"], a["wu"] = stack(d_model, ff, "embed", "mlp")
    p["wd"], a["wd"] = stack(ff, d_model, "mlp", "embed")
    if cfg.shared_d_ff:
        p["shared"], a["shared"] = ffn_init(gen, d_model, cfg.shared_d_ff,
                                            kind, device=device)
    return p, a


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: values and indices, ties to
    the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_logits, cfg: MoEConfig, cap: int):
    """Top-k routing -> packed per-slot routing words + per-slot gates.

    Returns (words (E*cap,) int32, gates (E*cap,), aux_loss, dropped).
    words[s] = (token << RANK_BITS) | rank, or -1 for an empty slot.
    """
    T, E = router_logits.shape
    dev = router_logits.device
    probs = torch.softmax(router_logits.to(F32), -1)
    gate_vals, eidx = top_k(probs, cfg.top_k)                  # (T, k)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    flat_e = eidx.reshape(-1)                                   # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos = torch.arange(T * cfg.top_k, device=dev) - seg_start[sorted_e]
    keep = pos < cap

    token = order // cfg.top_k
    rank = order % cfg.top_k
    packed = ((token << RANK_BITS) | rank).to(torch.int32)      # packed word

    Ep = cfg.e_pad  # padded experts never win top_k; their slots stay empty
    slot = torch.where(keep, sorted_e * cap + pos, Ep * cap)    # Ep*cap: drop
    words = torch.full((Ep * cap + 1,), INVALID_WORD, dtype=torch.int32,
                       device=dev)
    words = words.index_put(
        (slot,), torch.where(keep, packed, INVALID_WORD).to(torch.int32))
    gslot = torch.zeros((Ep * cap + 1,), dtype=F32, device=dev)
    gslot = gslot.index_put(
        (slot,), torch.where(keep, gate_vals.reshape(-1)[order], 0.0))

    # switch-style load-balance auxiliary loss (over the router's columns;
    # padded bank experts carry ~zero probability mass)
    me = probs.mean(0)                                          # (E,)
    ce = torch.zeros((E,), dtype=F32, device=dev).index_add(
        0, flat_e, torch.ones_like(flat_e, dtype=F32)) / (T * cfg.top_k)
    aux = cfg.n_experts * torch.sum(me * ce)
    dropped = (~keep).sum()
    return words[:-1], gslot[:-1], aux, dropped


def moe_apply(p, x, cfg: MoEConfig, kind: str = "swiglu"):
    """x: (B, S, d) -> (out, aux_loss). Queue dispatch through B6, expert
    FFNs in bf16, combine by ``index_add``."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    cap = capacity(T, cfg)

    logits = dense_apply(p["router"], xt).to(F32)
    if cfg.e_pad > cfg.n_experts:
        # padded bank experts must never win routing
        pad = torch.arange(cfg.e_pad, device=x.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e9)
    words, gates, aux, _dropped = route(logits, cfg, cap)

    tok = words >> RANK_BITS                    # -1 stays -1: a zero row
    live = words >= 0
    buf = ops.moe_gather(xt.contiguous(), tok)  # B6
    buf = buf.reshape(cfg.e_pad, cap, d)

    cd = BF16
    h = silu(torch.einsum("ecd,edf->ecf", buf.to(cd), p["wg"]["w"].to(cd)))
    h = h * torch.einsum("ecd,edf->ecf", buf.to(cd), p["wu"]["w"].to(cd))
    eout = torch.einsum("ecf,efd->ecd", h, p["wd"]["w"].to(cd))
    eout = eout.reshape(cfg.e_pad * cap, d)

    out = eout.new_zeros((T + 1, d)).index_add(
        0, torch.where(live, tok, T).long(), eout * gates[:, None].to(cd))
    out = out[:T]

    if "shared" in p:
        out = out + ffn_apply(p["shared"], xt, kind)
    return out.reshape(B, S, d).to(x.dtype), aux
