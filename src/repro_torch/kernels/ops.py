"""Device dispatch for the port's kernels.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
kernel's plain PyTorch version — by the tensor's device alone, never as a
fallback after a failed launch. ``launch_counts`` (one plain integer per
kernel, in the role of ``repro.kernels.ops.dispatch_counts``) counts kernel
launches only: it stays 0 on the CPU.
"""
from __future__ import annotations

from . import ref as _ref
from ._cuda import launch_counts, reset_launch_counts  # noqa: F401
from .quant_matmul import quant_matmul_cuda, quant_matmul_plain
from .spike_pipeline import fused_spike_accum_cuda, fused_spike_accum_plain
from .spike_sparse import (fused_spike_accum_sparse_cuda,
                           fused_spike_accum_sparse_plain)


def fused_spike_accum(occ, weights, *, K, n_win, bits, depth, H, W,
                      impl=None, e_cap=None, n_rows=None, weight_bits=None):
    """(N, C_in, K2, P) occupancy -> (N, H, W, C_out) surviving-event charge.

    ``impl``: None is the fused pipeline (B1); ``"sparse"`` the
    occupancy-gated one (B3: ``n_rows`` sizes its ragged grid on the card,
    ``e_cap`` its event list on the CPU); ``"ref"`` the scatter oracles.
    ``weight_bits`` selects the int-quantized accumulate of ``"sparse"`` and
    ``"ref"``; B1 has none.
    """
    if impl == "ref":
        kw = dict(K=K, n_win=n_win, depth=depth, H=H, W=W)
        if weight_bits is not None:
            return _ref.fused_spike_accum_quant_ref(
                occ, weights, weight_bits=weight_bits, **kw)
        return _ref.fused_spike_accum_ref(occ, weights, **kw)
    if impl == "sparse":
        if occ.device.type == "cuda":
            return fused_spike_accum_sparse_cuda(
                occ, weights, K=K, n_win=n_win, bits=bits, depth=depth, H=H,
                W=W, n_rows=n_rows, weight_bits=weight_bits)
        if e_cap is None:
            raise ValueError("impl='sparse' on the CPU needs an e_cap event "
                             "budget (see spike_sparse.event_bucket)")
        return fused_spike_accum_sparse_plain(
            occ, weights, K=K, n_win=n_win, depth=depth, H=H, W=W,
            e_cap=e_cap, weight_bits=weight_bits)
    if impl is not None:
        raise ValueError(f"unknown fused_spike_accum impl {impl!r} (expected "
                         "None, 'sparse' or 'ref')")
    if weight_bits is not None:
        raise ValueError("the fused pipeline has no int-quantized accumulate "
                         "path (use impl='sparse' or 'ref')")
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
