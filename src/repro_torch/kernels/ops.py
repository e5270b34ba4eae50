"""Device dispatch for the port's kernels.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
kernel's plain PyTorch version — by the tensor's device alone, never as a
fallback after a failed launch. ``launch_counts`` (one plain integer per
kernel, in the role of ``repro.kernels.ops.dispatch_counts``) counts kernel
launches only: it stays 0 on the CPU.
"""
from __future__ import annotations

from ._cuda import launch_counts, reset_launch_counts  # noqa: F401
from .quant_matmul import quant_matmul_cuda, quant_matmul_plain
from .spike_pipeline import fused_spike_accum_cuda, fused_spike_accum_plain


def fused_spike_accum(occ, weights, *, K, n_win, bits, depth, H, W):
    """(N, C_in, K2, P) occupancy -> (N, H, W, C_out) surviving-event charge."""
    if occ.device.type == "cuda":
        return fused_spike_accum_cuda(occ, weights, K=K, n_win=n_win,
                                      bits=bits, depth=depth, H=H, W=W)
    return fused_spike_accum_plain(occ, weights, K=K, n_win=n_win,
                                   depth=depth, H=H, W=W)


def quant_matmul(a_q, b_q, a_scale, b_scale):
    """Dequantized fp32 product of two int8 operands (exact int accumulate)."""
    if a_q.device.type == "cuda":
        return quant_matmul_cuda(a_q, b_q, a_scale, b_scale)
    return quant_matmul_plain(a_q, b_q, a_scale, b_scale)
