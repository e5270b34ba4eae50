"""Address-Event Queues with kernel-phase memory interlacing (paper Figs. 3-5).

Port of ``repro.core.aeq``. The paper's AEQ is a set of K*K queues, one per
kernel *phase*: a spike at (y, x) lands in phase (y mod K)*K + (x mod K) as
window address (y // K, x // K). Two events of one phase always have
disjoint K x K footprints, which is what lets the CUDA kernels apply a
whole queue at once without atomics (``csrc/spike_pipeline.cu``,
``csrc/event_accum.cu``).

Word-level half: :class:`AEQ` holds the packed words of every (step,
channel, phase) queue at a fixed ``depth`` (events past it are dropped and
counted); :func:`compact_spikes` is the software model of the Thresholding
Unit's event encoder — on a CUDA tensor its compaction is the queue-encoder
kernel (``csrc/spike_compact.cu``). Batched half: the fused pipeline's
queue-boundary helpers (``phase_occupancy``, ``segment_keep``,
``span_map``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .encoding import AEFormat, unpack_events


class AEQ(NamedTuple):
    words: torch.Tensor     # (..., T, C, K2, depth) int32 packed AE words
    counts: torch.Tensor    # (..., T, C, K2) int32 events per segment/phase
    overflow: torch.Tensor  # (...) int32 dropped events (capacity misses)


def aeq_init(fmt: AEFormat, T: int, C: int, depth: int, device=None) -> AEQ:
    K2 = fmt.kernel * fmt.kernel
    return AEQ(
        words=torch.full((T, C, K2, depth), fmt.invalid_word,
                         dtype=torch.int32, device=device),
        counts=torch.zeros((T, C, K2), dtype=torch.int32, device=device),
        overflow=torch.zeros((), dtype=torch.int32, device=device))


def _phase_split(fmt: AEFormat, spike_map: torch.Tensor) -> torch.Tensor:
    """(..., H, W) maps -> (..., K2, n_win*n_win) per-phase window occupancy.

    Pads each map up to n_win*K on both axes (padding holds no spikes).
    """
    K, n = fmt.kernel, fmt.n_win
    *lead, H, W = spike_map.shape
    m = F.pad(spike_map, (0, n * K - W, 0, n * K - H))
    # (..., n, K, n, K) -> (..., K, K, n, n) -> (..., K2, n*n)
    m = m.reshape(*lead, n, K, n, K).movedim((-3, -1), (-4, -3))
    return m.reshape(*lead, K * K, n * n)


def compact_spikes(fmt: AEFormat, spike_map: torch.Tensor, depth: int):
    """(..., H, W) 0/1 spike maps -> per-phase packed queues.

    Returns (words (..., K2, depth), counts (..., K2) capped at ``depth``,
    dropped (...) per map): the software model of the Thresholding Unit's
    event encoder. Events append in window-row-major order, as the
    hardware's sequential queue append does. The compaction itself is
    ``kernels.ops.spike_compact`` over all the maps' phase rows at once —
    the CUDA kernel on a CUDA tensor, the cumsum-and-scatter plain version
    on the CPU.
    """
    from ..kernels import ops

    occ = _phase_split(fmt, spike_map)
    *lead, K2, P = occ.shape
    words, total = ops.spike_compact(
        occ.reshape(-1, P).to(torch.int32).contiguous(), n_win=fmt.n_win,
        bits=fmt.bits_coord, depth=depth, invalid=fmt.invalid_word)
    total = total.reshape(*lead, K2)
    dropped = torch.clamp(total - depth, min=0).sum(-1).to(torch.int32)
    return (words.reshape(*lead, K2, depth), torch.clamp(total, max=depth),
            dropped)


def _scatter_rows(words, target, packed):
    """Row-wise scatter ``words[k, target[k, p]] = packed[k, p]``; targets
    equal to ``depth`` are dropped (they land in a spare column)."""
    R, depth = words.shape
    flat = torch.cat([words, words.new_empty((R, 1))], dim=1)
    flat.scatter_(1, target, packed)
    return flat[:, :depth].contiguous()


def aeq_set_segment(aeq: AEQ, fmt: AEFormat, t: int,
                    spikes_chw: torch.Tensor) -> AEQ:
    """Write the events of time step ``t`` (all C channels) into the queue."""
    depth = aeq.words.shape[-1]
    words, counts, dropped = compact_spikes(fmt, spikes_chw, depth)
    new_words, new_counts = aeq.words.clone(), aeq.counts.clone()
    new_words[t], new_counts[t] = words, counts
    return AEQ(new_words, new_counts, aeq.overflow + dropped.sum())


def aeq_from_raster(fmt: AEFormat, raster: torch.Tensor, depth: int) -> AEQ:
    """(T, C, H, W) 0/1 raster -> fully populated AEQ (one compaction over
    all T * C maps)."""
    words, counts, dropped = compact_spikes(fmt, raster, depth)
    return AEQ(words, counts, dropped.sum().to(torch.int32))


def aeq_from_raster_batch(fmt: AEFormat, raster: torch.Tensor,
                          depth: int) -> AEQ:
    """(B, T, C, H, W) 0/1 raster -> AEQ with a leading batch axis per
    field (overflow (B,)); one compaction over all B * T * C maps."""
    words, counts, dropped = compact_spikes(fmt, raster, depth)
    return AEQ(words, counts, dropped.flatten(1).sum(1).to(torch.int32))


def decode_positions(fmt: AEFormat, words: torch.Tensor):
    """(..., K2, depth) packed words -> absolute (y, x, valid) positions.

    y = i_c * K + ky with phase ph = ky*K + kx implicit in the second-to-last
    axis index (the compressed encoding's implicit coordinate, Sec. 5.2).
    """
    K = fmt.kernel
    i_c, j_c, valid = unpack_events(fmt, words)
    ph = torch.arange(K * K, dtype=torch.int32, device=words.device)[:, None]
    return i_c * K + ph // K, j_c * K + ph % K, valid


def aeq_total_events(aeq: AEQ) -> torch.Tensor:
    return aeq.counts.sum()


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


def kernel_span(p: torch.Tensor, K: int, size: int) -> torch.Tensor:
    """Kernel offsets d in [0, K) with 0 <= p - d + K//2 < size: the
    in-bounds SAME-conv targets of an event at coordinate ``p``."""
    pad = K // 2
    lo = torch.clamp(p + pad - size + 1, min=0)
    hi = torch.clamp(p + pad, max=K - 1)
    return torch.clamp(hi - lo + 1, min=0)


def span_map(fmt: AEFormat, hw: int, device=None) -> torch.Tensor:
    """(K2, P) int32 map: in-bounds kernel offsets per (phase, window) slot.

    ``span(y) * span(x)`` — the adds an event-driven engine issues per event
    (before the C_out fan-out). Padding positions (y or x >= hw) get 0.
    """
    return window_spans(fmt.kernel, fmt.n_win, hw, hw, device)


def window_spans(K: int, n_win: int, H: int, W: int,
                 device=None) -> torch.Tensor:
    """:func:`span_map` of an H x W map, from the geometry alone."""
    n = n_win
    pos = torch.arange(n * n, dtype=torch.int32, device=device)
    wy, wx = pos // n, pos % n
    ph = torch.arange(K * K, dtype=torch.int32, device=device)[:, None]
    y = wy[None, :] * K + ph // K
    x = wx[None, :] * K + ph % K
    return (kernel_span(y, K, H) * kernel_span(x, K, W) * (y < H)
            * (x < W)).to(torch.int32)


def queue_stats(occ: torch.Tensor, depth: int, spans: torch.Tensor,
                C_out: int):
    """The queue statistics of (B, ..., K2, P) occupancy: its
    :func:`segment_keep` mask, its per-queue totals (B, ..., K2) uncapped
    and capped at ``depth``, and per sample (B,) int32 the events kept, the
    fired positions past ``depth``, and ``C_out`` x the ``spans`` (K2, P)
    of the kept positions (the scalar adds, with :func:`span_map`'s
    spans)."""
    keep = segment_keep(occ, depth)
    tot = (occ > 0).sum(-1)
    capped = torch.clamp(tot, max=depth)
    dims = tuple(range(1, tot.ndim))
    ev = capped.sum(dims).to(torch.int32)
    ovf = (tot - capped).sum(dims).to(torch.int32)
    ops = ((keep * spans).sum((*dims, tot.ndim)) * C_out).to(torch.int32)
    return keep, tot, capped, ev, ovf, ops
