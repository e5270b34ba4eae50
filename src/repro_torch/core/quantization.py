"""Uniform quantization (port of ``repro.core.quantization``).

``quantize_symmetric`` is the deployed int path (the int8 head, the
int-quantized accumulate); ``fake_quant`` / ``fake_quant_unsigned`` are the
straight-through fake quantizers of FINN/Brevitas-style training, and
``quantize_params`` applies ``fake_quant`` to every weight tensor.
``torch.round`` rounds half to even, like ``jnp.round``.
"""
from __future__ import annotations

import torch


def quantize_symmetric(x: torch.Tensor, bits: int):
    """Per-tensor symmetric quantization -> (q_int, scale).

    ``scale`` is a 0-d float32 tensor on ``x``'s device; ``q`` is int8 for
    ``bits <= 8`` (int32 above), rounded half to even like ``jnp.round``.
    """
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp(x.abs().max(), min=1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int32), scale


def fake_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Straight-through fake quantization (gradient passes unchanged).

    The scale's ``max`` is detached, as the reference's ``stop_gradient``,
    and the forward value is ``x + (q - x)`` with ``q - x`` detached.
    """
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp(x.detach().abs().max(), min=1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax) * scale
    return x + (q - x).detach()


def fake_quant_unsigned(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned straight-through fake quantization for post-ReLU activations."""
    qmax = 2**bits - 1
    scale = torch.clamp(x.detach().max(), min=1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), 0, qmax) * scale
    return x + (q - x).detach()


def quantize_params(params, bits: int):
    """Fake-quantize every weight tensor; biases stay float (FINN keeps a
    wide bias)."""
    out = []
    for p in params:
        q = dict(p)
        if "w" in p:
            q["w"] = fake_quant(p["w"], bits)
        out.append(q)
    return out
