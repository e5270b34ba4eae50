"""One step's event accumulation: the Hopper kernel and its plain version.

Port of ``repro.kernels.event_accum``, with a leading row axis N (the
samples of a batch): both functions add every live queued event of packed
AE words ``words`` (N, C_in, K², D) int32 with ``counts`` (N, C_in, K²) into
the membrane ``v_mem`` (N, H, W, C_out) — fp32, or bf16 with bf16
weights and every add rounded to bf16 — an event of channel ``c`` at
(y, x) adds ``w[dy, dx, c, :]`` to output (y - dy + K//2, x - dx + K//2)
for every in-bounds offset. Slot ``d`` of queue (c, ph) is live when its
window row decodes below ``n_win`` and ``d < counts[c, ph]``, as in the TPU
kernel (the uncompressed format's invalid word decodes to row 0, so the
count is what kills it). Both return a new membrane; the input is kept.

- :func:`event_accum_cuda` — the CUDA kernel ``csrc/event_accum.cu``
  (replaces the Pallas TPU kernel ``event_accum``);
- :func:`event_accum_plain` — the reference ``event_conv2d``'s order:
  offset by offset, every live event in (n, c, phase, slot) order.

The kernel adds into each output in (c, phase) order instead, so on
Gaussian weights the two agree to rounding, not bit for bit; on dyadic
weights every sum is exact and they are equal.
``kernels.ops.event_accum`` picks between them by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda


def _live_events(words, counts, K, n_win, bits):
    """(n, c, y, x) of the live slots, in (n, c, phase, slot) order."""
    D = words.shape[-1]
    mask = (1 << bits) - 1
    i_c = (words >> bits) & mask
    slot = torch.arange(D, dtype=torch.int32, device=words.device)
    live = (i_c < n_win) & (slot < counts[..., None])
    n, c, ph, d = torch.nonzero(live, as_tuple=True)
    word = words[n, c, ph, d]
    y = ((word >> bits) & mask) * K + ph // K
    x = (word & mask) * K + ph % K
    return n, c, y, x


def _add_rows_each_rounded(out, target, rows):
    """``out[target[i]] += rows[i]`` in order of i, every add rounded to
    ``out``'s dtype. On the CPU ``index_add_`` sums a bf16 row's repeated
    targets in a wider type; here the k-th add to each target goes in round
    k, so no round repeats a target and each add is one rounded bf16 add."""
    key, perm = torch.sort(target, stable=True)
    idx = torch.arange(key.numel(), device=key.device)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[perm] = idx - start
    for k in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == k
        out[target[sel]] = out[target[sel]] + rows[sel]


def event_accum_plain(words, counts, weights, v_mem, *, K, n_win, bits):
    """Decode the live slots, then K*K passes, one per kernel offset, into
    a copy of the membrane: ``index_add_`` in fp32; in bf16 every add is
    rounded to bf16, as the TPU kernel's ``cur + w`` is."""
    N, H, W, C_out = v_mem.shape
    n, c, y, x = _live_events(words, counts, K, n_win, bits)
    out = v_mem.reshape(N * H * W, C_out).clone()
    pad = K // 2
    for dy in range(K):
        for dx in range(K):
            ty = y - dy + pad
            tx = x - dx + pad
            ok = (ty >= 0) & (ty < H) & (tx >= 0) & (tx < W)
            target = ((n * H + ty) * W + tx)[ok]
            rows = weights[dy, dx][c[ok]].to(out.dtype)
            if out.dtype == torch.float32:
                out.index_add_(0, target, rows)
            else:
                _add_rows_each_rounded(out, target, rows)
    return out.reshape(N, H, W, C_out)


_TILE = 32             # output channels per block (kTile in the source)
_SMEM_MAX = 232_448    # shared memory one Hopper block may opt in to
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 12
             + (ctypes.c_void_p,))


def event_accum_cuda(words, counts, weights, v_mem, *, K, n_win, bits):
    """Launch ``csrc/event_accum.cu`` on the current stream.

    ``words`` and ``counts`` may be a step's slice of a larger queue (a
    stride between rows); within a row they must be contiguous.
    """
    tensors = (words, counts, weights, v_mem)
    dev = v_mem.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("event_accum_cuda needs every operand on the same "
                         "CUDA device")
    if (v_mem.dtype not in (torch.float32, torch.bfloat16)
            or weights.dtype != v_mem.dtype):
        raise ValueError(
            f"event_accum_cuda takes v_mem and weights both float32 or both "
            f"bfloat16, got {v_mem.dtype} and {weights.dtype}")
    if words.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("words and counts must be int32")
    N, C_in, K2, D = words.shape
    _, H, W, C_out = v_mem.shape
    if K not in (1, 3, 5, 7):
        raise ValueError(f"the kernel is built for K in (1, 3, 5, 7), got {K}")
    if (K2 != K * K or tuple(counts.shape) != (N, C_in, K2)
            or tuple(weights.shape) != (K, K, C_in, C_out)
            or v_mem.shape[0] != N):
        raise ValueError(f"shape mismatch: words {tuple(words.shape)}, counts "
                         f"{tuple(counts.shape)}, weights "
                         f"{tuple(weights.shape)}, v_mem "
                         f"{tuple(v_mem.shape)}, K={K}")
    smem = v_mem.element_size() * H * W * _TILE
    if smem > _SMEM_MAX:
        raise ValueError(f"a {H}x{W} membrane needs {smem} bytes of shared "
                         f"memory per block; the kernel has {_SMEM_MAX}")
    out = torch.empty_like(v_mem)
    if out.numel() == 0:
        return out
    if not (words[0].is_contiguous() and counts[0].is_contiguous()
            and weights.is_contiguous() and v_mem.is_contiguous()):
        raise ValueError("words and counts must be contiguous within a row; "
                         "weights and v_mem contiguous")
    fn = _cuda.kernel_fn("event_accum", "event_accum", _ARGTYPES)
    _cuda.launch_counts["event_accum"] += 1
    err = fn(words.data_ptr(), counts.data_ptr(), weights.data_ptr(),
             v_mem.data_ptr(), out.data_ptr(), N, words.stride(0),
             counts.stride(0), C_in, K, D, n_win, bits, H, W, C_out,
             int(v_mem.dtype == torch.bfloat16), _cuda.stream_ptr(dev))
    _cuda.check_launch(err, "event_accum")
    return out
