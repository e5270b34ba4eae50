"""Multi-head / grouped-query attention with RoPE, chunked softmax and
KV-cache decode (port of ``repro.models.attention``).

The reference computes attention in plain XLA ops (einsum, a masked
softmax with ``NEG_INF``); so does the port, in plain einsum and softmax
in fp32, rather than ``scaled_dot_product_attention``, whose numerics
differ. Three paths:
- ``full``     : materialized (B, H, S, S) scores;
- ``chunked``  : a loop over query chunks of ``chunk_q``, each against the
                 full K/V (the reference's ``lax.map``), when S is a
                 multiple of ``chunk_q`` above it;
- ``decode``   : one query position a row against the cache, each row at
                 its own depth.

GQA: kv_heads < n_heads; queries are grouped. head_dim may differ from
d_model / n_heads.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .layers import BF16, F32, apply_rope, dense_apply, dense_init

NEG_INF = -2.3819763e38  # large negative for masked logits (bf16-safe)


def attn_init(gen, d_model: int, n_heads: int, kv_heads: int, head_dim: int,
              *, device):
    p, a = {}, {}
    p["q"], a["q"] = dense_init(gen, d_model, n_heads * head_dim, "embed",
                                "heads", device=device)
    p["k"], a["k"] = dense_init(gen, d_model, kv_heads * head_dim, "embed",
                                "kv", device=device)
    p["v"], a["v"] = dense_init(gen, d_model, kv_heads * head_dim, "embed",
                                "kv", device=device)
    p["o"], a["o"] = dense_init(gen, n_heads * head_dim, d_model, "heads",
                                "embed", device=device)
    return p, a


def _project_qkv(p, x, n_heads, kv_heads, head_dim, positions, rope_theta):
    B, S, _ = x.shape
    q = dense_apply(p["q"], x).reshape(B, S, n_heads, head_dim)
    k = dense_apply(p["k"], x).reshape(B, S, kv_heads, head_dim)
    v = dense_apply(p["v"], x).reshape(B, S, kv_heads, head_dim)
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _sdpa(q, k, v, *, causal: bool, q_offset: int = 0):
    """q: (B, Sq, H, d); k/v: (B, Sk, KV, d) -> (B, Sq, H, d)."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    group = H // KV
    scale = 1.0 / math.sqrt(D)

    qg = q.reshape(B, Sq, KV, group, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(F32), k.to(F32)) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(F32))
    return out.reshape(B, Sq, H, D).to(q.dtype)


def attention(p, x, *, n_heads: int, kv_heads: int, head_dim: int,
              causal: bool = True, rope_theta: float | None = 10000.0,
              chunk_q: int = 1024, kv_override: tuple | None = None):
    """x: (B, S, d_model) -> (B, S, d_model). ``kv_override``: (k, v) for
    cross-attention; q, k and v are still projected from ``x`` first, as
    in the reference."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, n_heads, kv_heads, head_dim, positions,
                           rope_theta)
    if kv_override is not None:
        k, v = kv_override

    if S <= chunk_q or S % chunk_q != 0:
        out = _sdpa(q, k, v, causal=causal)
    else:
        out = torch.cat([
            _sdpa(q[:, i:i + chunk_q], k, v, causal=causal, q_offset=i)
            for i in range(0, S, chunk_q)], dim=1)
    return dense_apply(p["o"], out.reshape(B, S, n_heads * head_dim))


# ---------------------------------------------------------------------------
# KV-cache prefill / decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor     # (B, S_max, kv_heads, head_dim)
    v: torch.Tensor
    pos: torch.Tensor   # (B,) int32 — next write position per row


def cache_init(batch: int, max_seq: int, kv_heads: int, head_dim: int,
               dtype=BF16, *, device) -> KVCache:
    z = torch.zeros((batch, max_seq, kv_heads, head_dim), dtype=dtype,
                    device=device)
    return KVCache(z, z, torch.zeros((batch,), dtype=torch.int32,
                                     device=device))


def cache_axes() -> KVCache:
    """Logical axes of a cache entry."""
    return KVCache(
        k=("batch", "kvseq", "kv_cache", None),
        v=("batch", "kvseq", "kv_cache", None),
        pos=("batch",),
    )


def attention_prefill(p, x, cache: KVCache, *, n_heads, kv_heads, head_dim,
                      rope_theta=10000.0, chunk_q: int = 1024):
    """Causal prefill: returns (out, cache holding the S entries). Above
    ``chunk_q`` the reference hands ``x`` to :func:`attention`, which
    projects q, k and v once more; so does the port."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, n_heads, kv_heads, head_dim, positions,
                           rope_theta)
    new_k = torch.cat([k.to(cache.k.dtype), cache.k[:, S:]], dim=1)
    new_v = torch.cat([v.to(cache.v.dtype), cache.v[:, S:]], dim=1)
    if S <= chunk_q:
        out = _sdpa(q, k, v, causal=True)
        out = dense_apply(p["o"], out.reshape(B, S, n_heads * head_dim))
    else:
        out = attention(p, x, n_heads=n_heads, kv_heads=kv_heads,
                        head_dim=head_dim, causal=True,
                        rope_theta=rope_theta, chunk_q=chunk_q)
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return out, KVCache(new_k, new_v, pos)


def attention_decode(p, x, cache: KVCache, *, n_heads, kv_heads, head_dim,
                     rope_theta=10000.0):
    """One-token decode against the cache. x: (B, 1, d_model). Positions
    are per row; the cache write is a per-row scatter."""
    B = x.shape[0]
    positions = cache.pos[:, None]                              # (B, 1)
    q, k, v = _project_qkv(p, x, n_heads, kv_heads, head_dim, positions,
                           rope_theta)

    rows = torch.arange(B, device=x.device)
    at = (rows, cache.pos.long())
    k_cache = cache.k.index_put(at, k[:, 0].to(cache.k.dtype))
    v_cache = cache.v.index_put(at, v[:, 0].to(cache.v.dtype))

    S_max = cache.k.shape[1]
    mask = (torch.arange(S_max, device=x.device)[None, :]
            <= cache.pos[:, None])                              # (B, S_max)
    group = n_heads // kv_heads
    scale = 1.0 / math.sqrt(head_dim)

    qg = q.reshape(B, kv_heads, group, head_dim)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.to(F32),
                          k_cache.to(F32)) * scale
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache.to(F32))
    out = out.reshape(B, 1, n_heads * head_dim).to(x.dtype)
    return (dense_apply(p["o"], out),
            KVCache(k_cache, v_cache, cache.pos + 1))
