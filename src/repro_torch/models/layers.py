"""Shared building blocks for the LM stack (port of
``repro.models.layers``).

Every parameter is created together with its *logical axes* (a tuple of
names like ('embed', 'mlp')); params and axes are parallel trees of nested
dicts. Inits draw from an explicit ``torch.Generator`` on ``device``, so
they differ from the reference's ``jax.random`` draws by design; the tests
carry the reference's parameters across with ``model.params_from_numpy``.

Compute follows the reference's dtypes: a dense layer multiplies in bf16
(both operands cast, fp32 accumulation inside the matmul), norms and RoPE
work in fp32 and return the input's dtype. The activations are written as
the elementary ops JAX lowers them to, each rounded to the input's dtype:
in bf16 they then equal the reference's bit for bit, where torch's fused
``silu`` and ``gelu`` round once and differ on many inputs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16
F32 = torch.float32


def normal(gen, shape, device, dtype=F32):
    """Standard normal draws from ``gen`` on ``device`` (``gen`` must live
    on the same device type: a CUDA generator for the card)."""
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def dense_init(gen, in_dim: int, out_dim: int, in_ax, out_ax, *, device,
               dtype=F32):
    w = normal(gen, (in_dim, out_dim), device, dtype) / math.sqrt(in_dim)
    return {"w": w}, {"w": (in_ax, out_ax)}


def dense_apply(p, x, compute_dtype=BF16):
    return x.to(compute_dtype) @ p["w"].to(compute_dtype)


def norm_init(dim: int, kind: str = "rmsnorm", *, device):
    p = {"scale": torch.ones((dim,), dtype=F32, device=device)}
    a = {"scale": (None,)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=F32, device=device)
        a["bias"] = (None,)
    return p, a


def norm_apply(p, x, kind: str = "rmsnorm", eps: float = 1e-6):
    xf = x.to(F32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    else:
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if "bias" in p:
            y = y + p["bias"]
    return (y * p["scale"]).to(x.dtype)


def embed_init(gen, vocab: int, dim: int, *, device, dtype=F32):
    w = normal(gen, (vocab, dim), device, dtype) * 0.02
    return {"emb": w}, {"emb": ("vocab", "embed")}


def embed_apply(p, tokens, compute_dtype=BF16):
    """The table cast to ``compute_dtype``, then gathered, as the reference
    does: the gradient is summed per row in ``compute_dtype``."""
    return p["emb"].to(compute_dtype)[tokens.long()]


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None):
    half = head_dim // 2
    exps = torch.arange(half, dtype=F32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=F32, device=device),
                           exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, head_dim); positions: broadcastable to (..., S). The
    head splits into two halves, as ``jnp.split`` splits it."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)          # (half,)
    angles = positions[..., None].to(F32) * freqs                # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def _const(value, x):
    """A scalar in ``x``'s dtype, as JAX rounds a weak-typed constant."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def sigmoid(x):
    """``jax.nn.sigmoid`` as it lowers: ``1 / (1 + exp(-x))``, each op
    rounded to ``x``'s dtype (``torch.sigmoid`` rounds once, and differs
    by an ulp on many bf16 inputs)."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)``, op by op as the reference."""
    return x * sigmoid(x)


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation, op by op as the
    reference computes it (``torch.nn.functional.gelu``'s default is the
    erf form)."""
    inner = _const(math.sqrt(2 / math.pi), x) * (
        x + _const(0.044715, x) * (x * x * x))
    return x * (0.5 * (1 + torch.tanh(inner)))


def activation(name: str):
    return {"relu": F.relu, "gelu": gelu, "silu": silu}[name]


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, without torch's linear
    branch above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))
