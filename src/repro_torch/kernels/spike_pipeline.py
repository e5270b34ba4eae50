"""Fused spike compaction + accumulation: the Hopper kernel and its plain version.

Port of ``repro.kernels.spike_pipeline``. Both functions compute, for
occupancy ``occ`` (N, C_in, K², P) int32 and HWIO weights (K, K, C_in,
C_out), the (N, H, W, C_out) fp32 charge of the events that survive a
depth-``depth`` queue per (row, channel, phase), and each sample's queue
statistics (events kept, events dropped, scalar adds; a sample is
``steps`` consecutive rows), which the engine's ``queue_pallas`` stage
reports:

- :func:`fused_spike_accum_cuda` — the CUDA kernel ``csrc/spike_pipeline.cu``
  (replaces the Pallas TPU kernel ``fused_spike_accum_pallas``): packed
  kept bits, whose encode pass also adds up the statistics as it ranks the
  queues, then a gather that adds into each output in (c, phase) order
  (``csrc/spike_accum.cuh``, shared with B3 and B4; unrolled for K in
  :data:`UNROLLED_K`, rolled for any other odd K);
- :func:`fused_spike_accum_plain` — the ``fused_spike_accum_xla`` semantics:
  drop mask, rebuild the surviving 0/1 map in HWC order, one SAME conv; the
  statistics as the engine's other backends compute them
  (``core.aeq.queue_stats``).

``kernels.ops.fused_spike_accum`` picks between them by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from ..audit.contracts import SMEM_BUDGET_BYTES, KernelContract, block_bytes
from ..core.aeq import queue_stats, window_spans
from ..core.snn_layers import conv_same_nhwc
from . import _cuda


def _samples(N, steps):
    """Samples of ``steps`` rows each in N rows."""
    if steps < 1 or N % steps:
        raise ValueError(f"{N} rows are not samples of {steps} steps")
    return N // steps


def fused_spike_accum_plain(occ, weights, *, K, n_win, depth, H, W,
                            steps=1):
    """Drop-mask the occupancy, rebuild the spike map, one batched SAME
    conv: (charge, ev, ovf, ops), the statistics int32 (N / steps,)."""
    N, C_in, K2, P = occ.shape
    spans = window_spans(K, n_win, H, W, occ.device)        # (K2, P)
    keep, _, _, ev, ovf, ops = queue_stats(
        occ.reshape(_samples(N, steps), steps, C_in, K2, P), depth, spans,
        weights.shape[-1])
    # inverse phase split: (N, C, ky, kx, wy, wx) -> (N, y, x, C)
    m = keep.reshape(N, C_in, K, K, n_win, n_win).to(weights.dtype)
    m = m.permute(0, 4, 2, 5, 3, 1).reshape(N, n_win * K, n_win * K, C_in)
    return conv_same_nhwc(m[:, :H, :W, :], weights), ev, ovf, ops


_SMEM_MAX = SMEM_BUDGET_BYTES    # shared memory one Hopper block may use
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 9
             + (ctypes.c_void_p,))
UNROLLED_K = (1, 3, 5, 7)   # K with an unrolled gather; others run rolled
GATHER_CELLS = 8            # window cells a gather block covers (kWarps)

# Declared intent, verified by ``python -m repro_torch.audit``: fp32
# accumulate (no quant path here), no host syncs, and the shared memory of
# :func:`smem_blocks` within one block's budget at every paper geometry.
CONTRACT = KernelContract(name="fused_spike_accum", module=__name__,
                          accum_dtype="float32")


def kept_bit_words(occ_shape) -> int:
    """uint32 words of the packed kept bits, (N, C_in, K², ceil(P/32))."""
    N, C_in, K2, P = occ_shape
    return N * C_in * K2 * (-(-P // 32))


def _gather_blocks(K, n_win, H, W, cells):
    """The staged buffers of the unrolled gather's block, as data."""
    K2 = K * K
    cc = 32 if K <= 3 else (16 if K == 5 else 8)
    nw = -(-n_win * n_win // 32)
    cells_x, cells_y = -(-W // K), -(-H // K)
    rows = (cells + cells_x * cells_y - 2) // (cells_x * cells_y) + 1
    win_rows = min((cells + cells_x - 2) // cells_x + 1, cells_y)
    sw = min(nw, ((win_rows + 2) * n_win + 31) // 32 + 1)
    return [("w_chunk", (K2, cc, 32), 4, True),
            ("kept_bits", (rows, cc, (K2 * sw) | 1), 4, True)]


def smem_blocks(*, K, n_win, H, W, cells=GATHER_CELLS, **_unused):
    """The dynamic shared memory a gather block requests, as data, for
    ``audit.smem``: ``(name, shape, bytes per element, double_buffered)``.

    Mirrors ``csrc/spike_accum.cuh``'s ``gather_smem<K, Cells>`` (its
    ``launch_smem`` query returns the bytes the launcher passes): two
    buffers of one chunk's weights (K², CC, 32) and of its rows' kept bits,
    ``SW`` words per (row, channel, phase) queue — the window rows that the
    block's ``cells`` consecutive window cells of a row span, plus one row
    of halo on each side — so it grows with the map's width, not its area.
    A K outside :data:`UNROLLED_K` runs the rolled gather, which stages
    nothing. (B4's 2-cell blocks for small grids stage less.)"""
    if K not in UNROLLED_K:
        return []
    return _gather_blocks(K, n_win, H, W, cells)


def gather_smem(K, n_win, H, W, cells=GATHER_CELLS):
    """Bytes of shared memory a block of the unrolled gather stages: the
    total of its :func:`smem_blocks` (for any K, as if it were unrolled)."""
    return block_bytes(_gather_blocks(K, n_win, H, W, cells))


def check_gather_fits(K, n_win, H, W):
    """Raise unless the gather of ``csrc/spike_accum.cuh`` runs this shape:
    K odd; for K in :data:`UNROLLED_K`, :func:`gather_smem` within a block's
    shared memory (every square map up to 3,488 x 3,488 at K = 1, 792 at
    K = 3, 760 at K = 5 and 1,120 at K = 7). Any other odd K runs the
    rolled gather, which stages nothing and has no such limit."""
    if K < 1 or K % 2 == 0:
        raise ValueError(f"the gather takes an odd K >= 1, got {K}")
    if K not in UNROLLED_K:
        return
    smem = gather_smem(K, n_win, H, W)
    if smem > _SMEM_MAX:
        raise ValueError(f"the kept bits of a {H}x{W} map at K={K} need "
                         f"{smem} bytes of shared memory per block; the "
                         f"kernel has {_SMEM_MAX}")


def fused_spike_accum_cuda(occ, weights, *, K, n_win, depth, H, W,
                           steps=1):
    """Launch ``csrc/spike_pipeline.cu`` on the current stream: (charge,
    ev, ovf, ops), equal to :func:`fused_spike_accum_plain`'s statistics
    bit for bit."""
    if occ.device.type != "cuda" or weights.device != occ.device:
        raise ValueError("fused_spike_accum_cuda needs occ and weights on "
                         "the same CUDA device")
    if occ.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(f"expected int32 occupancy and float32 weights, got "
                        f"{occ.dtype} and {weights.dtype}")
    N, C_in, K2, P = occ.shape
    check_gather_fits(K, n_win, H, W)
    if (K2 != K * K or P != n_win * n_win
            or tuple(weights.shape[:3]) != (K, K, C_in)):
        raise ValueError(f"shape mismatch: occ {tuple(occ.shape)}, weights "
                         f"{tuple(weights.shape)}, K={K}, n_win={n_win}")
    if not (occ.is_contiguous() and weights.is_contiguous()):
        raise ValueError("occ and weights must be contiguous")
    C_out = weights.shape[-1]
    out = torch.empty((N, H, W, C_out), dtype=torch.float32,
                      device=occ.device)
    stats = torch.empty((_samples(N, steps), 3), dtype=torch.int32,
                        device=occ.device)            # zeroed by the launch
    if N == 0:
        return out, *stats.unbind(1)
    scratch = torch.empty(kept_bit_words(occ.shape), dtype=torch.int32,
                          device=occ.device)
    fn = _cuda.kernel_fn("spike_pipeline", "fused_spike_accum", _ARGTYPES)
    _cuda.launch_counts["fused_spike_accum"] += 1
    err = fn(occ.data_ptr(), weights.data_ptr(), scratch.data_ptr(),
             out.data_ptr(), stats.data_ptr(), N, C_in, K, n_win, depth, H,
             W, C_out, steps, _cuda.stream_ptr(occ.device))
    _cuda.check_launch(err, "fused_spike_accum")
    return out, *stats.unbind(1)


def launch_smem(*, K, n_win, H, W, **_unused) -> int:
    """The dynamic shared memory the compiled launcher requests per gather
    block at this geometry (``csrc/spike_pipeline.cu``'s
    ``fused_spike_accum_smem``): what ``audit.smem`` holds
    :func:`smem_blocks` to on the card."""
    fn = _cuda.kernel_fn("spike_pipeline", "fused_spike_accum_smem",
                         (ctypes.c_int,) * 4, ctypes.c_longlong)
    return fn(K, n_win, H, W)
