"""Mamba-style selective state-space block, the hybrid's sequence mixer
(port of ``repro.models.ssm``).

The selective scan runs as a loop over time with an O(B * d_inner * N)
carry, as the reference's ``lax.scan``; with ``seq_chunk`` each chunk of
steps is recomputed in the backward (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` over chunks. Decode keeps O(1) state: a
rolling conv window and the SSM state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import F32, dense_apply, dense_init, normal, silu, softplus


class MambaConfig(NamedTuple):
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, d_inner) rolling input window
    h: torch.Tensor     # (B, d_inner, d_state) SSM state


def mamba_init(gen, d_model: int, cfg: MambaConfig, *, device):
    di, N, K = cfg.d_inner, cfg.d_state, cfg.d_conv
    dt_rank = cfg.dt_rank or -(-d_model // 16)
    p, a = {}, {}
    p["in_proj"], a["in_proj"] = dense_init(gen, d_model, 2 * di, "embed",
                                            "mlp", device=device)
    p["conv_w"] = normal(gen, (K, di), device) * 0.1
    a["conv_w"] = (None, "mlp")
    p["conv_b"] = torch.zeros((di,), dtype=F32, device=device)
    a["conv_b"] = ("mlp",)
    p["x_proj"], a["x_proj"] = dense_init(gen, di, dt_rank + 2 * N, "mlp",
                                          None, device=device)
    p["dt_proj"], a["dt_proj"] = dense_init(gen, dt_rank, di, None, "mlp",
                                            device=device)
    p["dt_bias"] = torch.zeros((di,), dtype=F32, device=device)
    a["dt_bias"] = ("mlp",)
    # S4D-real initialization of A
    p["A_log"] = torch.log(torch.arange(1, N + 1, dtype=F32, device=device)
                           )[None, :].expand(di, N).clone()
    a["A_log"] = ("mlp", None)
    p["D"] = torch.ones((di,), dtype=F32, device=device)
    a["D"] = ("mlp",)
    p["out_proj"], a["out_proj"] = dense_init(gen, di, d_model, "mlp",
                                              "embed", device=device)
    return p, a


def _causal_conv(x, w, b):
    """Depthwise causal conv: x (B, S, di), w (K, di) -> (B, S, di), summed
    tap by tap in the reference's order."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, j: j + x.shape[1]] * w[j] for j in range(K))
    return out + b


def _ssm_params(p, xc, cfg: MambaConfig, d_model: int):
    dt_rank = cfg.dt_rank or -(-d_model // 16)
    proj = dense_apply(p["x_proj"], xc).to(F32)
    dt, Bc, Cc = torch.split(proj, [dt_rank, cfg.d_state, cfg.d_state], -1)
    dt = softplus(dense_apply(p["dt_proj"], dt).to(F32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                  # (di, N)
    return dt, Bc, Cc, A


def _scan(h, xs, dts, Bs, Cs, A):
    """Steps of the selective scan over the leading (time) axis of xs,
    dts, Bs, Cs -> (last state, ys (time, B, di))."""
    ys = []
    for t in range(xs.shape[0]):
        Ab = torch.exp(dts[t][..., None] * A)                   # (B, di, N)
        h = Ab * h + (dts[t] * xs[t])[..., None] * Bs[t][:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cs[t]))
    return h, torch.stack(ys)


def mamba_apply(p, x, cfg: MambaConfig, *, want_state: bool = False,
                seq_chunk: int = 0):
    """Training/prefill forward. x: (B, S, d_model) -> (B, S, d_model) or,
    with want_state, (y, MambaCache) so decode continues from the prefix."""
    B, S, d_model = x.shape
    xz = dense_apply(p["in_proj"], x)
    xc_pre, z = torch.chunk(xz, 2, -1)
    xc = silu(_causal_conv(xc_pre, p["conv_w"], p["conv_b"]))

    dt, Bc, Cc, A = _ssm_params(p, xc, cfg, d_model)

    h = torch.zeros((B, cfg.d_inner, cfg.d_state), dtype=F32, device=x.device)
    xs = [t.to(F32).movedim(1, 0) for t in (xc, dt, Bc, Cc)]
    if seq_chunk and S % seq_chunk == 0 and S > seq_chunk:
        ys = []
        for i in range(0, S, seq_chunk):
            h, y = checkpoint(_scan, h, *(t[i:i + seq_chunk] for t in xs), A,
                              use_reentrant=False)
            ys.append(y)
        ys = torch.cat(ys)
    else:
        h, ys = _scan(h, *xs, A)
    y = ys.movedim(0, 1) + xc.to(F32) * p["D"]
    y = y.to(x.dtype) * silu(z)
    out = dense_apply(p["out_proj"], y)
    if want_state:
        K = cfg.d_conv
        pad = F.pad(xc_pre, (0, 0, K - 1, 0))
        return out, MambaCache(conv=pad[:, -(K - 1):].to(F32), h=h)
    return out


def mamba_cache_init(batch: int, cfg: MambaConfig, dtype=F32, *,
                     device) -> MambaCache:
    return MambaCache(
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=dtype,
                      device=device),
    )


def mamba_cache_axes() -> MambaCache:
    return MambaCache(conv=("batch", None, "mlp"), h=("batch", "mlp", None))


def mamba_decode(p, x, cache: MambaCache, cfg: MambaConfig):
    """One-token decode. x: (B, 1, d_model) -> (out, new cache)."""
    B, _, d_model = x.shape
    xz = dense_apply(p["in_proj"], x[:, 0])
    xc, z = torch.chunk(xz, 2, -1)

    window = torch.cat([cache.conv, xc.to(cache.conv.dtype)[:, None]],
                       dim=1)                                   # (B, K, di)
    conv_out = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = silu(conv_out)

    dt, Bc, Cc, A = _ssm_params(p, xc, cfg, d_model)
    Ab = torch.exp(dt[..., None] * A)
    h = Ab * cache.h + (dt * xc.to(F32))[..., None] * Bc[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cc) + xc.to(F32) * p["D"]
    y = y.to(x.dtype) * silu(z)
    out = dense_apply(p["out_proj"], y)[:, None]
    return out, MambaCache(conv=window[:, 1:], h=h)
