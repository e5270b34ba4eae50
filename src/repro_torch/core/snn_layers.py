"""Channels-last spike max-pool and dense SAME conv (``repro.core.snn_layers``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def spike_maxpool_hwc(spikes: torch.Tensor, window: int, latch: torch.Tensor,
                      *, latch_once: bool = True):
    """OR-pooling of (..., H, W, C) 0/1 spikes, stride == window (VALID).

    The map is cropped to ``Ho * window`` first (32 -> 30 for P3).
    ``latch`` (..., Ho, Wo, C) bool marks pooled outputs that already fired;
    with ``latch_once`` a pooled output fires only the first time any input
    of its window fires. Returns ``(pooled spikes, new latch)``.
    """
    *lead, H, W, C = spikes.shape
    Ho, Wo = H // window, W // window
    s = spikes[..., : Ho * window, : Wo * window, :]
    s = s.reshape(*lead, Ho, window, Wo, window, C).amax(dim=(-4, -2))
    fired = s > 0
    if latch_once:
        fired = fired & ~latch
    return fired.to(spikes.dtype), latch | (s > 0)


def conv_same_nhwc(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """SAME, stride-1 conv of (N, H, W, C_in) by HWIO weights -> (N, H, W, C_out).

    cuDNN's TF32 must be off on the card (``device.resolve_device``).
    """
    K = weights.shape[0]
    out = F.conv2d(x.permute(0, 3, 1, 2).to(weights.dtype),
                   weights.permute(3, 2, 0, 1), padding=K // 2)
    return out.permute(0, 2, 3, 1)


def dense_conv_hwc(spike_map: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Dense SAME conv of an (H, W, C) map -> (H, W, C_out), channels-last."""
    return conv_same_nhwc(spike_map[None], weights)[0]
