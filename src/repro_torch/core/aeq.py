"""Batched AEQ segment views: the fused spike pipeline's queue-boundary helpers.

Port of the batched half of ``repro.core.aeq`` (``phase_occupancy``,
``segment_keep``, ``span_map``). The paper's AEQ is a set of K*K queues, one
per kernel *phase*: a spike at (y, x) lands in phase (y mod K)*K + (x mod K)
as window address (y // K, x // K). Two events of one phase always have
disjoint K x K footprints, which is what lets the CUDA kernel apply a whole
queue at once without atomics (``csrc/spike_pipeline.cu``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .encoding import AEFormat


def phase_occupancy(fmt: AEFormat, raster: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) channels-last raster -> (..., C, K2, P) int32 occupancy.

    Position index p = wy * n_win + wx — the window-row-major queue append
    order the drop rule depends on. Any number of leading axes.
    """
    K, n = fmt.kernel, fmt.n_win
    *lead, H, W, C = raster.shape
    L = len(lead)
    # F.pad pads trailing dims first: (C: 0, 0), (W: 0, nK-W), (H: 0, nK-H)
    m = F.pad(raster, (0, 0, 0, n * K - W, 0, n * K - H))
    m = m.reshape(*lead, n, K, n, K, C)
    # (..., wy, ky, wx, kx, C) -> (..., C, ky, kx, wy, wx)
    perm = list(range(L)) + [L + 4, L + 1, L + 3, L + 0, L + 2]
    m = m.permute(perm).reshape(*lead, C, K * K, n * n)
    # with n == 1 the reshape is a strided view and .to() keeps its strides
    return m.to(torch.int32).contiguous()


def segment_keep(occ: torch.Tensor, depth: int) -> torch.Tensor:
    """Which occupancy positions survive a depth-``depth`` queue (bool mask).

    Events append in window-row-major order and the queue drops everything
    past ``depth``. When ``depth >= P`` nothing can overflow.
    """
    fired = occ > 0
    if depth >= occ.shape[-1]:
        return fired
    slot = torch.cumsum(fired.to(torch.int32), dim=-1) - 1   # int64
    return fired & (slot < depth)


def span_map(fmt: AEFormat, hw: int, device=None) -> torch.Tensor:
    """(K2, P) int32 map: in-bounds kernel offsets per (phase, window) slot.

    ``span(y) * span(x)`` — the adds an event-driven engine issues per event
    (before the C_out fan-out). Padding positions (y or x >= hw) get 0.
    """
    K, n = fmt.kernel, fmt.n_win
    pad = K // 2
    pos = torch.arange(n * n, dtype=torch.int32, device=device)
    wy, wx = pos // n, pos % n
    ph = torch.arange(K * K, dtype=torch.int32, device=device)[:, None]
    y = wy[None, :] * K + ph // K
    x = wx[None, :] * K + ph % K

    def span(p):  # offsets d in [0, K) with 0 <= p - d + pad < hw
        lo = torch.clamp(p + pad - hw + 1, min=0)
        hi = torch.clamp(p + pad, max=K - 1)
        return torch.clamp(hi - lo + 1, min=0)

    return (span(y) * span(x) * (y < hw) * (x < hw)).to(torch.int32)
