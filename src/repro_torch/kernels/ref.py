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
import torch.nn.functional as F

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


def fused_spike_accum_ordered_ref(occ, weights, *, K, n_win, depth, H, W,
                                  init=None, multiplicity=False):
    """The fused accumulate with the (c, phase) order of adds of B1, B3 and
    B4.

    Applies the drop rule, then for c ascending and phase ascending adds
    queue (c, phase)'s kept events into every output they reach, one
    ``torch.where(hit, w, 0)`` at a time, in the weights' dtype. The
    phase interlacing puts, in each output's K x K window, exactly one
    position of each phase, so an output takes at most one weight per
    queue: this is the exact sequence of adds that the gather kernels
    perform for each output (adding 0 changes no partial sum), from 0 (B1,
    B3) or, with ``init`` (N, H, W, C_out) in the weights' dtype, from the
    membrane (B4).

    With ``multiplicity`` the values of ``occ`` are how many live words name
    each position (``event_accum.event_mult_plain``): a kept position adds
    its weight that many times, back to back in its (c, phase) turn, as B4
    adds a repeated live word once per occurrence.
    """
    N, C_in, K2, P = occ.shape
    fired = occ > 0
    slot = torch.cumsum(fired.to(torch.int32), dim=-1) - 1
    kept = (fired & (slot < depth)).reshape(N, C_in, K2, n_win, n_win)
    reps = occ.reshape(N, C_in, K2, n_win, n_win)
    dev, pad, side = occ.device, K // 2, n_win * K
    out = (torch.zeros((N, H, W, weights.shape[-1]), dtype=weights.dtype,
                       device=dev) if init is None else init)
    zero = torch.zeros((), dtype=weights.dtype, device=dev)

    def window(t, k):
        """Per output coordinate: the offset d and window index of the one
        input coordinate of phase k in its window, and whether it exists."""
        d = (k - t + pad) % K
        src = t - pad + d
        return d, torch.clamp(src, 0, side - 1) // K, (src >= 0) & (src < side)

    ty = torch.arange(H, device=dev)
    tx = torch.arange(W, device=dev)
    for c in range(C_in):
        for ph in range(K2):
            dy, wy, oky = window(ty, ph // K)
            dx, wx, okx = window(tx, ph % K)
            hit = (kept[:, c, ph][:, wy][:, :, wx]
                   & oky[:, None] & okx[None, :])          # (N, H, W)
            w = weights[dy[:, None], dx[None, :], c]         # (H, W, C_out)
            out = out + torch.where(hit[..., None], w, zero)
            if multiplicity:
                times = torch.where(hit, reps[:, c, ph][:, wy][:, :, wx], 0)
                for k in range(1, int(times.max())):
                    out = out + torch.where((times > k)[..., None], w, zero)
    return out


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


def event_accum_ref(words, counts, weights, v_mem, *, K, n_win, bits):
    """Oracle for the event accumulator: decode the queues to a dense spike
    map, then add one SAME conv of it to ``v_mem``.

    words (C_in, K2, D) int32, counts (C_in, K2), weights (K, K, C_in,
    C_out), v_mem (H, W, C_out). A slot is live when its window row is in
    range and it lies below its queue's count — the identity
    event_conv2d(AEQ(map)) == conv2d(map) the design rests on. A live word
    whose window column is past the grid (j_c >= n_win) adds nothing, as
    the reference's scatter drops its out-of-range x; a repeated live word
    adds once per occurrence.
    """
    C_in, K2, D = words.shape
    H, W, C_out = v_mem.shape
    mask = (1 << bits) - 1
    i_c = (words >> bits) & mask
    j_c = words & mask
    slot = torch.arange(D, dtype=torch.int32, device=words.device)
    valid = (i_c < n_win) & (j_c < n_win) & (slot < counts[..., None])
    ph = torch.arange(K2, dtype=torch.int32, device=words.device)[:, None]
    c, y, x = (a[valid] for a in (
        torch.arange(C_in, device=words.device)[:, None, None].expand_as(i_c),
        i_c * K + ph // K, j_c * K + ph % K))
    side = n_win * K
    spikes = torch.zeros((C_in, side, side), dtype=v_mem.dtype,
                         device=words.device)
    spikes.index_put_((c, y.long(), x.long()),
                      torch.ones_like(c, dtype=v_mem.dtype), accumulate=True)
    out = F.conv2d(spikes[None, :, :H, :W], weights.permute(3, 2, 0, 1),
                   padding=K // 2)
    return v_mem + out[0].permute(1, 2, 0)


def spike_compact_ref(occ, *, n_win, bits, depth, invalid):
    """Oracle for the queue encoder: a cumsum gives each fired position its
    slot; one scatter into a row with a spare drop column past ``depth``.
    Returns (words (R, depth), uncapped counts (R,)), both int32."""
    R, P = occ.shape
    fired = occ > 0
    pos = torch.arange(P, dtype=torch.int32, device=occ.device)
    packed = ((pos // n_win) << bits) | (pos % n_win)
    slot = torch.cumsum(fired.to(torch.int32), dim=1) - 1
    target = torch.where(fired & (slot < depth), slot, depth)
    flat = torch.full((R, depth + 1), invalid, dtype=torch.int32,
                      device=occ.device)
    flat.scatter_(1, target, packed.expand(R, P).contiguous())
    return flat[:, :depth].contiguous(), fired.sum(1).to(torch.int32)


def moe_gather_ref(x, indices):
    """Oracle for the MoE row gather: row ``indices[s]`` of ``x``, or zeros
    where the index is negative."""
    ok = indices >= 0
    rows = x[torch.clamp(indices, 0, x.shape[0] - 1).long()]
    return rows * ok[:, None].to(x.dtype)
