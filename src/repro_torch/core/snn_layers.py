"""Event-driven SNN layers (``repro.core.snn_layers``).

The identity underneath: ``event_conv2d(AEQ(spike_map), W) ==
conv2d(spike_map, W)`` (SAME padding) — processing the sparse queue is the
dense convolution restricted to the nonzero inputs. :func:`event_conv2d` is
the word-level reference semantics; its membrane update is
``kernels.ops.event_accum`` (the CUDA kernel on a CUDA tensor). The
channels-last spike max-pool and dense SAME conv are what the engine's
other paths use.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .aeq import AEQ, decode_positions, kernel_span
from .encoding import AEFormat


def event_conv2d(v_mem: torch.Tensor, weights: torch.Tensor, aeq: AEQ,
                 fmt: AEFormat, t: int):
    """Accumulate all events of time step ``t`` into ``v_mem``.

    ``v_mem`` (..., H, W, C_out) with the AEQ's leading axes (none for one
    sample, (B,) for a batch), weights (K, K, C_in, C_out). A spike at
    (y, x) in channel c adds ``w[dy, dx, c, :]`` to output (y - dy + pad,
    x - dx + pad) for every in-bounds offset. Returns ``(new_v_mem,
    n_ops)``, where n_ops (...) int32 counts the scalar additions: in-bounds
    offsets x C_out per valid event, from the decoded words.
    """
    from ..kernels import ops

    K = fmt.kernel
    H, W, C_out = v_mem.shape[-3:]
    words = aeq.words.select(-4, t)                     # (..., C, K2, D)
    counts = aeq.counts.select(-3, t)                   # (..., C, K2)
    v_mem = ops.event_accum(words, counts, weights, v_mem, K=K,
                            n_win=fmt.n_win, bits=fmt.bits_coord)
    y, x, valid = decode_positions(fmt, words)
    adds = kernel_span(y, K, H) * kernel_span(x, K, W) * valid
    n_ops = (adds.sum((-3, -2, -1)) * C_out).to(torch.int32)
    return v_mem, n_ops


def event_dense(v_mem: torch.Tensor, weights: torch.Tensor,
                spikes: torch.Tensor):
    """Event-driven fully-connected accumulation: each spiking input adds
    its weight row (a masked matmul); n_ops counts those adds."""
    v_mem = v_mem + spikes @ weights
    n_ops = ((spikes > 0).sum() * weights.shape[1]).to(torch.int32)
    return v_mem, n_ops


def spike_maxpool(spikes: torch.Tensor, window: int, latch: torch.Tensor, *,
                  latch_once: bool = True):
    """OR-pooling of (C, H, W) 0/1 spikes at one step, stride == window
    (VALID); ``latch`` (C, Ho, Wo) bool marks outputs that already fired."""
    C, H, W = spikes.shape
    Ho, Wo = H // window, W // window
    s = spikes[:, : Ho * window, : Wo * window]
    s = s.reshape(C, Ho, window, Wo, window).amax(dim=(2, 4))
    fired = s > 0
    if latch_once:
        fired = fired & ~latch
    return fired.to(spikes.dtype), latch | (s > 0)


def spike_maxpool_hwc(spikes: torch.Tensor, window: int, latch: torch.Tensor,
                      *, latch_once: bool = True,
                      straight_through: bool = False):
    """:func:`spike_maxpool` over (..., H, W, C) spikes, channels-last.

    The map is cropped to ``Ho * window`` first (32 -> 30 for P3).
    ``latch`` (..., Ho, Wo, C) bool marks pooled outputs that already fired;
    with ``latch_once`` a pooled output fires only the first time any input
    of its window fires. Returns ``(pooled spikes, new latch)``.

    ``straight_through`` keeps the pooled output differentiable for
    surrogate-gradient training: on exact 0/1 float spikes the windowed max
    is the OR, and the spike-once gate multiplies by ``1 - latch`` (the
    latch stays bool, without gradient). The max is ``amax``, whose
    gradient splits evenly among tied maxima as ``jax.grad`` of the
    reference's reshaped ``max`` does (``F.max_pool2d`` would give it all
    to one element; with 0/1 spikes ties are the rule).
    """
    *lead, H, W, C = spikes.shape
    Ho, Wo = H // window, W // window
    s = spikes[..., : Ho * window, : Wo * window, :]
    s = s.reshape(*lead, Ho, window, Wo, window, C).amax(dim=(-4, -2))
    if straight_through:
        fired = s * (1.0 - latch.to(s.dtype)) if latch_once else s
        return fired, latch | (s > 0)
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


def dense_conv_oracle(spike_map: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Dense SAME conv of a (C, H, W) spike map -> (H, W, C_out): the oracle
    of :func:`event_conv2d`."""
    return conv_same_nhwc(spike_map.permute(1, 2, 0)[None], weights)[0]
