"""Per-tensor symmetric quantization (``repro.core.quantization``)."""
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
