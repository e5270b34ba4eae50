"""Feed-forward variants: MLP (gelu/relu), SwiGLU, GeGLU (port of
``repro.models.ffn``)."""
from __future__ import annotations

from .layers import activation, dense_apply, dense_init

GATED = {"swiglu": "silu", "geglu": "gelu"}


def ffn_init(gen, d_model: int, d_ff: int, kind: str, *, device):
    p, a = {}, {}
    if kind in GATED:
        p["wg"], a["wg"] = dense_init(gen, d_model, d_ff, "embed", "mlp",
                                      device=device)
        p["wu"], a["wu"] = dense_init(gen, d_model, d_ff, "embed", "mlp",
                                      device=device)
    else:
        p["wu"], a["wu"] = dense_init(gen, d_model, d_ff, "embed", "mlp",
                                      device=device)
    p["wd"], a["wd"] = dense_init(gen, d_ff, d_model, "mlp", "embed",
                                  device=device)
    return p, a


def ffn_apply(p, x, kind: str):
    if kind in GATED:
        act = activation(GATED[kind])
        h = act(dense_apply(p["wg"], x)) * dense_apply(p["wu"], x)
    else:
        h = activation(kind)(dense_apply(p["wu"], x))
    return dense_apply(p["wd"], h)
