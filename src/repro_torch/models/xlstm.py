"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory) (port of
``repro.models.xlstm``, after Beck et al. 2024, arXiv:2405.04517).

Both mixers run as exact sequential recurrences, loops over time in the
reference's order; ``seq_chunk`` recomputes each chunk of steps in the
backward (``torch.utils.checkpoint``) as the reference's chunked
``jax.checkpoint`` does. Decode state is O(1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import F32, dense_apply, dense_init, norm_apply, norm_init, \
    normal, sigmoid, silu, softplus


class MLSTMCache(NamedTuple):
    C: torch.Tensor     # (B, H, hd, hd) matrix memory
    n: torch.Tensor     # (B, H, hd) normalizer
    m: torch.Tensor     # (B, H) stabilizer
    conv: torch.Tensor  # (B, K-1, d_up) rolling conv window


class SLSTMCache(NamedTuple):
    c: torch.Tensor     # (B, d)
    n: torch.Tensor     # (B, d)
    h: torch.Tensor     # (B, d)
    m: torch.Tensor     # (B, d)


def _log_sigmoid(x):
    """``-jax.nn.softplus(-x)``, the reference's log sigmoid."""
    return -softplus(-x)


def _chunked(step_loop, carry, xs, S: int, seq_chunk: int):
    """Run ``step_loop(carry, *xs)`` over time (the leading axis of each
    of ``xs``), in checkpointed chunks of ``seq_chunk`` steps when it
    divides S (as the reference's two-level scan), else in one go."""
    if seq_chunk and S % seq_chunk == 0 and S > seq_chunk:
        hs = []
        for i in range(0, S, seq_chunk):
            carry, h = checkpoint(step_loop, carry,
                                  *(t[i:i + seq_chunk] for t in xs),
                                  use_reentrant=False)
            hs.append(h)
        return carry, torch.cat(hs)
    return step_loop(carry, *xs)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen, d_model: int, n_heads: int, proj_factor: int = 2,
               d_conv: int = 4, *, device):
    du = proj_factor * d_model
    p, a = {}, {}
    p["up"], a["up"] = dense_init(gen, d_model, 2 * du, "embed", "mlp",
                                  device=device)
    p["conv_w"] = normal(gen, (d_conv, du), device) * 0.1
    a["conv_w"] = (None, "mlp")
    p["q"], a["q"] = dense_init(gen, du, du, "mlp", "heads", device=device)
    p["k"], a["k"] = dense_init(gen, du, du, "mlp", "heads", device=device)
    p["v"], a["v"] = dense_init(gen, du, du, "mlp", "heads", device=device)
    p["ifg"], a["ifg"] = dense_init(gen, du, 2 * n_heads, "mlp", None,
                                    device=device)
    p["skip"], a["skip"] = dense_init(gen, du, du, "mlp", "heads",
                                      device=device)
    p["gn"], a["gn"] = norm_init(du, device=device)
    p["down"], a["down"] = dense_init(gen, du, d_model, "heads", "embed",
                                      device=device)
    return p, a


def _mlstm_steps(carry, qs, ks, vs, is_, fs):
    """The mLSTM cell over the leading (time) axis -> (carry, hs)."""
    C, n, m = carry
    scale = qs.shape[-1] ** -0.5
    hs = []
    for t in range(qs.shape[0]):
        qt, kt, vt, it, ft = qs[t], ks[t], vs[t], is_[t], fs[t]
        log_f = _log_sigmoid(ft)
        m_new = torch.maximum(log_f + m, it)                    # (B, H)
        fg = torch.exp(log_f + m - m_new)[..., None, None]
        ig = torch.exp(it - m_new)[..., None, None]
        kt = kt * scale
        C = fg * C + ig * (vt[..., :, None] * kt[..., None, :])  # (B,H,hd,hd)
        n = fg[..., 0] * n + ig[..., 0] * kt
        num = torch.einsum("bhvk,bhk->bhv", C, qt)
        den = torch.maximum(
            torch.abs(torch.einsum("bhk,bhk->bh", n, qt)), torch.exp(-m_new)
        )[..., None]
        m = m_new
        hs.append(num / den)
    return (C, n, m), torch.stack(hs)


def _mlstm_scan(q, k, v, i_raw, f_raw, C0, n0, m0, seq_chunk: int = 0):
    """Exact recurrent mLSTM cell over time. q/k/v: (B, S, H, hd);
    i_raw/f_raw: (B, S, H). Returns (h (B, S, H, hd), (C, n, m))."""
    S = q.shape[1]
    xs = [t.to(F32).movedim(1, 0) for t in (q, k, v, i_raw, f_raw)]
    carry, hs = _chunked(_mlstm_steps, (C0, n0, m0), xs, S, seq_chunk)
    return hs.movedim(0, 1), carry


def mlstm_apply(p, x, n_heads: int, *, cache: MLSTMCache | None = None,
                d_conv: int = 4, want_state: bool = False,
                seq_chunk: int = 0):
    """x: (B, S, d_model). With cache (decode), S == 1 and state carries
    over; want_state (prefill) returns the final recurrent state."""
    B, S, d_model = x.shape
    up = dense_apply(p["up"], x)
    h_pre, z = torch.chunk(up, 2, -1)                     # (B, S, du) each
    du = h_pre.shape[-1]
    hd = du // n_heads

    if cache is None:
        pad = F.pad(h_pre, (0, 0, d_conv - 1, 0))
    else:
        pad = torch.cat([cache.conv.to(h_pre.dtype), h_pre], dim=1)
    conv_carry = pad[:, -(d_conv - 1):]
    conv = sum(pad[:, j: j + S] * p["conv_w"][j] for j in range(d_conv))
    conv = silu(conv)

    q = dense_apply(p["q"], conv).reshape(B, S, n_heads, hd)
    k = dense_apply(p["k"], conv).reshape(B, S, n_heads, hd)
    v = dense_apply(p["v"], h_pre).reshape(B, S, n_heads, hd)
    ifg = dense_apply(p["ifg"], conv).to(F32).reshape(B, S, 2, n_heads)
    i_raw, f_raw = ifg[:, :, 0], ifg[:, :, 1]

    if cache is None:
        C0 = torch.zeros((B, n_heads, hd, hd), dtype=F32, device=x.device)
        n0 = torch.zeros((B, n_heads, hd), dtype=F32, device=x.device)
        m0 = torch.zeros((B, n_heads), dtype=F32, device=x.device)
    else:
        C0, n0, m0 = cache.C, cache.n, cache.m

    h, (C, n, m) = _mlstm_scan(q, k, v, i_raw, f_raw, C0, n0, m0,
                               seq_chunk=seq_chunk)
    h = h.reshape(B, S, du).to(x.dtype)
    h = h + dense_apply(p["skip"], conv)
    h = norm_apply(p["gn"], h)                     # (group norm simplified)
    h = h * silu(z)
    out = dense_apply(p["down"], h)
    new_cache = None
    if cache is not None or want_state:
        new_cache = MLSTMCache(C=C, n=n, m=m, conv=conv_carry.to(F32))
    return out, new_cache


def mlstm_cache_init(batch: int, d_model: int, n_heads: int,
                     proj_factor: int = 2, d_conv: int = 4, *,
                     device) -> MLSTMCache:
    du = proj_factor * d_model
    hd = du // n_heads
    z = dict(dtype=F32, device=device)
    return MLSTMCache(
        C=torch.zeros((batch, n_heads, hd, hd), **z),
        n=torch.zeros((batch, n_heads, hd), **z),
        m=torch.zeros((batch, n_heads), **z),
        conv=torch.zeros((batch, d_conv - 1, du), **z),
    )


def mlstm_cache_axes() -> MLSTMCache:
    return MLSTMCache(
        C=("batch", "heads", None, None),
        n=("batch", "heads", None),
        m=("batch", "heads"),
        conv=("batch", None, "mlp"),
    )


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen, d_model: int, n_heads: int, ff_factor: float = 4 / 3, *,
               device):
    hd = d_model // n_heads
    ff = int(ff_factor * d_model)
    p, a = {}, {}
    p["wx"], a["wx"] = dense_init(gen, d_model, 4 * d_model, "embed", "mlp",
                                  device=device)
    p["r"] = normal(gen, (n_heads, hd, 4 * hd), device) / hd ** 0.5
    a["r"] = ("heads", None, None)
    p["b"] = torch.zeros((4 * d_model,), dtype=F32, device=device)
    a["b"] = ("mlp",)
    p["gn"], a["gn"] = norm_init(d_model, device=device)
    p["up_g"], a["up_g"] = dense_init(gen, d_model, ff, "embed", "mlp",
                                      device=device)
    p["up_v"], a["up_v"] = dense_init(gen, d_model, ff, "embed", "mlp",
                                      device=device)
    p["down"], a["down"] = dense_init(gen, ff, d_model, "mlp", "embed",
                                      device=device)
    return p, a


def _slstm_steps(carry, xs, r, b):
    """The sLSTM cell over the leading (time) axis of xs (S, B, 4d)."""
    c, n, h, m = carry
    B, d = h.shape
    n_heads, hd = r.shape[0], r.shape[1]
    hs = []
    for t in range(xs.shape[0]):
        hh = h.reshape(B, n_heads, hd)
        rec = torch.einsum("bhk,hkf->bhf", hh, r).reshape(B, 4 * d)
        zifo = xs[t] + rec + b
        z_r, i_r, f_r, o_r = torch.chunk(zifo, 4, -1)
        log_f = _log_sigmoid(f_r)
        m_new = torch.maximum(log_f + m, i_r)
        ig = torch.exp(i_r - m_new)
        fg = torch.exp(log_f + m - m_new)
        c = fg * c + ig * torch.tanh(z_r)
        n = fg * n + ig
        h = sigmoid(o_r) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return (c, n, h, m), torch.stack(hs)


def _slstm_scan(wx_t, p, n_heads: int, state: SLSTMCache, seq_chunk: int = 0):
    """wx_t: (B, S, 4*d) precomputed input contributions."""
    S = wx_t.shape[1]
    xs = wx_t.to(F32).movedim(1, 0)

    def steps(carry, xs_):
        return _slstm_steps(carry, xs_, p["r"], p["b"])

    carry, hs = _chunked(steps, tuple(state), [xs], S, seq_chunk)
    return hs.movedim(0, 1), SLSTMCache(*carry)


def slstm_apply(p, x, n_heads: int, *, cache: SLSTMCache | None = None,
                want_state: bool = False, seq_chunk: int = 0):
    B, S, d = x.shape
    wx = dense_apply(p["wx"], x)
    state = cache if cache is not None else SLSTMCache(
        *(torch.zeros((B, d), dtype=F32, device=x.device) for _ in range(4)))
    h, new_state = _slstm_scan(wx, p, n_heads, state, seq_chunk=seq_chunk)
    h = norm_apply(p["gn"], h.to(x.dtype))
    h = silu(dense_apply(p["up_g"], h)) * dense_apply(p["up_v"], h)
    out = dense_apply(p["down"], h)
    return out, (new_state if (cache is not None or want_state) else None)


def slstm_cache_init(batch: int, d_model: int, *, device) -> SLSTMCache:
    z = torch.zeros((batch, d_model), dtype=F32, device=device)
    return SLSTMCache(z, z, z, z)


def slstm_cache_axes() -> SLSTMCache:
    ax = ("batch", "mlp")
    return SLSTMCache(ax, ax, ax, ax)
