"""Fused spike compaction + accumulation: the Hopper kernel and its plain version.

Port of ``repro.kernels.spike_pipeline``. Both functions compute, for
occupancy ``occ`` (N, C_in, K², P) int32 and HWIO weights (K, K, C_in,
C_out), the (N, H, W, C_out) fp32 charge of the events that survive a
depth-``depth`` queue per (row, channel, phase):

- :func:`fused_spike_accum_cuda` — the CUDA kernel ``csrc/spike_pipeline.cu``
  (replaces the Pallas TPU kernel ``fused_spike_accum_pallas``): packed
  kept bits, then a gather that adds into each output in (c, phase) order
  (``csrc/spike_accum.cuh``, shared with B3);
- :func:`fused_spike_accum_plain` — the ``fused_spike_accum_xla`` semantics:
  drop mask, rebuild the surviving 0/1 map in HWC order, one SAME conv.

``kernels.ops.fused_spike_accum`` picks between them by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.snn_layers import conv_same_nhwc
from . import _cuda


def fused_spike_accum_plain(occ, weights, *, K, n_win, depth, H, W):
    """Drop-mask the occupancy, rebuild the spike map, one batched SAME conv."""
    N, C_in, K2, P = occ.shape
    fired = occ > 0
    if depth < P:
        slot = torch.cumsum(fired.to(torch.int32), dim=-1) - 1
        fired = fired & (slot < depth)
    # inverse phase split: (N, C, ky, kx, wy, wx) -> (N, y, x, C)
    m = fired.reshape(N, C_in, K, K, n_win, n_win).to(weights.dtype)
    m = m.permute(0, 4, 2, 5, 3, 1).reshape(N, n_win * K, n_win * K, C_in)
    return conv_same_nhwc(m[:, :H, :W, :], weights)


_SMEM_MAX = 232_448    # shared memory one Hopper block may use
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8
             + (ctypes.c_void_p,))


def kept_bit_words(occ_shape) -> int:
    """uint32 words of the packed kept bits, (N, C_in, K², ceil(P/32))."""
    N, C_in, K2, P = occ_shape
    return N * C_in * K2 * (-(-P // 32))


def check_gather_fits(K, n_win, H, W):
    """Raise unless the gather (``csrc/spike_accum.cuh``) can stage one
    chunk's weights and its rows' kept bits, double-buffered, in a block's
    shared memory (the largest maps' bits are what may not fit)."""
    if K not in (1, 3, 5, 7):
        raise ValueError(f"the kernel is built for K in (1, 3, 5, 7), got {K}")
    cc = 32 if K <= 3 else (16 if K == 5 else 8)
    cell_words = (K * K * -(-n_win * n_win // 32)) | 1
    cells = -(-H // K) * -(-W // K)
    rows = (8 + cells - 2) // cells + 1        # of 8 window cells a block
    smem = 4 * (2 * K * K * cc * 32 + 2 * rows * cc * cell_words)
    if smem > _SMEM_MAX:
        raise ValueError(f"the kept bits of a {n_win}x{n_win}-window map "
                         f"need {smem} bytes of shared memory per block; the "
                         f"kernel has {_SMEM_MAX}")


def fused_spike_accum_cuda(occ, weights, *, K, n_win, depth, H, W):
    """Launch ``csrc/spike_pipeline.cu`` on the current stream."""
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
    if N == 0:
        return out
    scratch = torch.empty(kept_bit_words(occ.shape), dtype=torch.int32,
                          device=occ.device)
    fn = _cuda.kernel_fn("spike_pipeline", "fused_spike_accum", _ARGTYPES)
    _cuda.launch_counts["fused_spike_accum"] += 1
    err = fn(occ.data_ptr(), weights.data_ptr(), scratch.data_ptr(),
             out.data_ptr(), N, C_in, K, n_win, depth, H, W, C_out,
             _cuda.stream_ptr(occ.device))
    _cuda.check_launch(err, "fused_spike_accum")
    return out
