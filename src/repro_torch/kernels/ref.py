"""Torch copies of the reference oracles in ``repro.kernels.ref``.

Test oracles only — the engine never calls them. Each computes its function
a different way from both the CUDA kernel and the kernel's plain version.
"""
from __future__ import annotations

import torch


def fused_spike_accum_ref(occ, weights, *, K, n_win, depth, H, W):
    """Per-event scatter oracle for the fused compact+accumulate kernel.

    occ (N, C_in, K2, P) int32 occupancy, weights (K, K, C_in, C_out) ->
    (N, H, W, C_out). Drops events past ``depth`` per (c, phase) queue in
    window-row-major order, then adds each surviving event's K*K offsets.
    """
    N, C_in, K2, P = occ.shape
    C_out = weights.shape[-1]
    pad = K // 2
    dev = occ.device

    fired = occ > 0
    slot = torch.cumsum(fired.to(torch.int32), dim=-1) - 1
    fired = fired & (slot < depth)

    nf, cf, phf, pf = torch.nonzero(fired, as_tuple=True)
    yf = (pf // n_win) * K + phf // K
    xf = (pf % n_win) * K + phf % K

    out = torch.zeros((N * H * W, C_out), dtype=weights.dtype, device=dev)
    for dy in range(K):
        for dx in range(K):
            ty = yf - dy + pad
            tx = xf - dx + pad
            ok = (ty >= 0) & (ty < H) & (tx >= 0) & (tx < W)
            idx = (nf * H + ty) * W + tx
            out.index_add_(0, idx[ok], weights[dy, dx][cf[ok]])
    return out.reshape(N, H, W, C_out)


def quant_matmul_ref(a_q, b_q, a_scale, b_scale):
    """Exact int32 product, then fp32 dequant ``prod * (a_scale * b_scale)``.

    Integer matmul is CPU-only in PyTorch, which is where the tests run.
    """
    prod = torch.matmul(a_q.to(torch.int32), b_q.to(torch.int32))
    return prod.to(torch.float32) * (a_scale * b_scale)
