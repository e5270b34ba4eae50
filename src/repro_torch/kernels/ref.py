"""Torch copies of the reference oracles in ``repro.kernels.ref``.

The tests hold every kernel against them, and the ``queue_ref`` engine
backend calls the two spike-accumulate oracles, as it does in the
reference: it is the parity anchor ``queue_sparse`` is pinned against.
Each computes its function a different way from both the CUDA kernel and
the kernel's plain version. On a CUDA tensor ``index_add_`` adds with
atomics, so the fp32 oracle's summation order is fixed only on the CPU.
"""
from __future__ import annotations

import torch

from ..core.quantization import quantize_symmetric


def _surviving_events(occ, K, n_win, depth):
    """(n, c, y, x) of the events that survive the drop rule, in the
    flattened (n, c, phase, position) order."""
    fired = occ > 0
    slot = torch.cumsum(fired.to(torch.int32), dim=-1) - 1
    fired = fired & (slot < depth)
    nf, cf, phf, pf = torch.nonzero(fired, as_tuple=True)
    yf = (pf // n_win) * K + phf // K
    xf = (pf % n_win) * K + phf % K
    return nf, cf, yf, xf


def _scatter(out, w, nf, cf, yf, xf, K, H, W):
    """Add each event's K*K SAME-conv offsets of ``w`` into ``out``
    (N*H*W, C_out), offset by offset."""
    pad = K // 2
    for dy in range(K):
        for dx in range(K):
            ty = yf - dy + pad
            tx = xf - dx + pad
            ok = (ty >= 0) & (ty < H) & (tx >= 0) & (tx < W)
            idx = (nf * H + ty) * W + tx
            out.index_add_(0, idx[ok], w[dy, dx][cf[ok]])
    return out


def fused_spike_accum_ref(occ, weights, *, K, n_win, depth, H, W):
    """Per-event scatter oracle for the fused compact+accumulate kernel.

    occ (N, C_in, K2, P) int32 occupancy, weights (K, K, C_in, C_out) ->
    (N, H, W, C_out). Drops events past ``depth`` per (c, phase) queue in
    window-row-major order, then adds each surviving event's K*K offsets.
    """
    N = occ.shape[0]
    C_out = weights.shape[-1]
    out = torch.zeros((N * H * W, C_out), dtype=weights.dtype,
                      device=occ.device)
    _scatter(out, weights, *_surviving_events(occ, K, n_win, depth), K, H, W)
    return out.reshape(N, H, W, C_out)


def fused_spike_accum_quant_ref(occ, weights, *, K, n_win, depth, H, W,
                                weight_bits=8):
    """Quantized-weight variant of :func:`fused_spike_accum_ref`.

    Same event set and order; the weights are symmetric-quantized to
    ``weight_bits`` integers, every contribution accumulates exactly in
    int32, and one fp32 dequant scales the result. Integer sums are exact
    in any order, so this oracle is deterministic on the card too.
    """
    N = occ.shape[0]
    C_out = weights.shape[-1]
    w_q, w_scale = quantize_symmetric(weights, weight_bits)
    acc = torch.zeros((N * H * W, C_out), dtype=torch.int32,
                      device=occ.device)
    _scatter(acc, w_q.to(torch.int32),
             *_surviving_events(occ, K, n_win, depth), K, H, W)
    return (acc.to(torch.float32) * w_scale).reshape(N, H, W, C_out)


def quant_matmul_ref(a_q, b_q, a_scale, b_scale):
    """Exact int32 product, then fp32 dequant ``prod * (a_scale * b_scale)``.

    Integer matmul is CPU-only in PyTorch, which is where the tests run.
    """
    prod = torch.matmul(a_q.to(torch.int32), b_q.to(torch.int32))
    return prod.to(torch.float32) * (a_scale * b_scale)
