"""Device dispatch for the port's kernels.

A CUDA tensor goes to the hand-written kernel; a CPU tensor goes to the
kernel's plain PyTorch version — by the tensor's device alone, never as a
fallback after a failed launch. ``launch_counts`` (one plain integer per
kernel, in the role of ``repro.kernels.ops.dispatch_counts``) counts kernel
launches only: it stays 0 on the CPU.

Tracing (``repro_torch.obs``) counts each dispatch of the fused pipeline
as ``kernels.dispatch.fused:{impl}`` and of the int8 head as
``kernels.dispatch.quant_matmul:{backend}``, named in the reference's
vocabulary so one trace reads both packages: ``cuda`` / ``sparse_cuda``
the Hopper kernels (the reference's ``pallas`` / ``sparse_pallas``);
``xla`` B1's plain version (drop mask + conv, the realization the
reference names ``xla``), ``sparse`` B3's event list, ``ref`` the oracles
and B2's plain int32 product. The counts differ by design: the
reference's fire at trace time, once per compiled plan; these fire per
Python dispatch — per eager call, and once per CUDA-graph capture (a
replay runs no Python).
"""
from __future__ import annotations

import math

from .. import obs
from . import ref as _ref
from ._cuda import launch_counts, reset_launch_counts  # noqa: F401
from .event_accum import event_accum_cuda, event_accum_plain
from .moe_gather import MoEGather
from .quant_matmul import quant_matmul_cuda, quant_matmul_plain
from .spike_pipeline import fused_spike_accum_cuda, fused_spike_accum_plain
from .spike_compact import spike_compact_cuda, spike_compact_plain
from .spike_sparse import (fused_spike_accum_sparse_cuda,
                           fused_spike_accum_sparse_plain)


def fused_spike_accum(occ, weights, *, K, n_win, bits, depth, H, W,
                      impl=None, e_cap=None, n_rows=None, weight_bits=None,
                      steps=1):
    """(N, C_in, K2, P) occupancy -> (N, H, W, C_out) surviving-event charge.

    ``impl``: None is the fused pipeline (B1), which returns ``(charge, ev,
    ovf, ops)``: per sample, ``steps`` consecutive rows, int32 (N / steps,)
    each, the events kept, the fired positions past ``depth`` and C_out x
    the in-bounds spans of the kept events (``core.aeq.queue_stats``);
    ``"sparse"`` the occupancy-gated one (B3: ``n_rows`` sizes its ragged
    grid on the card, ``e_cap`` its event list on the CPU); ``"ref"`` the
    scatter oracles. ``weight_bits`` selects the int-quantized accumulate of
    ``"sparse"`` and ``"ref"``; B1 has none.
    """
    cuda = occ.device.type == "cuda"
    name = {None: "cuda" if cuda else "xla",
            "sparse": "sparse_cuda" if cuda else "sparse"}.get(impl, impl)
    obs.counter(f"kernels.dispatch.fused:{name}")
    if impl == "ref":
        kw = dict(K=K, n_win=n_win, depth=depth, H=H, W=W)
        if weight_bits is not None:
            return _ref.fused_spike_accum_quant_ref(
                occ, weights, weight_bits=weight_bits, **kw)
        return _ref.fused_spike_accum_ref(occ, weights, **kw)
    if impl == "sparse":
        if cuda:
            return fused_spike_accum_sparse_cuda(
                occ, weights, K=K, n_win=n_win, depth=depth, H=H, W=W,
                n_rows=n_rows, weight_bits=weight_bits)
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
    fn = fused_spike_accum_cuda if cuda else fused_spike_accum_plain
    return fn(occ, weights, K=K, n_win=n_win, depth=depth, H=H, W=W,
              steps=steps)


def quant_matmul(a_q, b_q, a_scale, b_scale):
    """Dequantized fp32 product of two int8 operands (exact int accumulate)."""
    if a_q.device.type == "cuda":
        obs.counter("kernels.dispatch.quant_matmul:cuda")
        return quant_matmul_cuda(a_q, b_q, a_scale, b_scale)
    obs.counter("kernels.dispatch.quant_matmul:ref")
    return quant_matmul_plain(a_q, b_q, a_scale, b_scale)


def event_accum(words, counts, weights, v_mem, *, K, n_win, bits):
    """Add one step's queued events into the membrane.

    words (..., C_in, K2, D) int32, counts (..., C_in, K2) int32, weights
    (K, K, C_in, C_out), v_mem (..., H, W, C_out) -> the new membrane; the
    leading axes (none, or a batch) are rows of one launch.
    """
    lead = v_mem.shape[:-3]
    N = math.prod(lead)
    args = (words.reshape(N, *words.shape[-3:]),
            counts.reshape(N, *counts.shape[-2:]), weights,
            v_mem.reshape(N, *v_mem.shape[-3:]))
    kw = dict(K=K, n_win=n_win, bits=bits)
    if v_mem.device.type == "cuda":
        out = event_accum_cuda(*args, **kw)
    else:
        out = event_accum_plain(*args, **kw)
    return out.reshape(*lead, *out.shape[1:])


def spike_compact(occ, *, n_win, bits, depth, invalid):
    """(R, P) occupancy rows -> (words (R, depth), uncapped counts (R,))."""
    kw = dict(n_win=n_win, bits=bits, depth=depth, invalid=invalid)
    if occ.device.type == "cuda":
        return spike_compact_cuda(occ, **kw)
    return spike_compact_plain(occ, **kw)


def moe_gather(x, indices):
    """Rows ``indices[s]`` of ``x`` (T, d); a negative index gives zeros.
    Differentiable in ``x`` (:class:`MoEGather`)."""
    return MoEGather.apply(x, indices)
