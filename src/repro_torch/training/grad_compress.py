"""Gradient compression with error feedback (port of
``repro.training.grad_compress``).

int8 symmetric quantization per tensor: ``compress_decompress(grads)`` is
the stateless quantize -> dequantize (the wire format of an int8 gradient
exchange); ``ef_step(grads, residual)`` the error-feedback variant that
carries the quantization error into the next call. ``torch.round`` rounds
half to even, as ``jnp.round`` does, and every other op is one IEEE fp32
operation, so both equal the reference's bit for bit.
"""
from __future__ import annotations

import torch

from .optimizer import _map


def _q(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads):
    def f(g):
        q, s = _q(g.to(torch.float32))
        return (q.to(torch.float32) * s).to(g.dtype)

    return _map(f, grads)


def ef_step(grads, residual):
    """(grads, residual) -> (decompressed grads, new residual)."""
    def f(g, r):
        x = g.to(torch.float32) + r
        q, s = _q(x)
        dq = q.to(torch.float32) * s
        return dq.to(g.dtype), x - dq

    residuals = []

    def one(g, r):
        dq, new_r = f(g, r)
        residuals.append(new_r)
        return dq

    dq = _map(one, grads, residual)
    it = iter(residuals)            # _map visits leaves in one fixed order
    return dq, _map(lambda _: next(it), grads)


def init_residual(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
