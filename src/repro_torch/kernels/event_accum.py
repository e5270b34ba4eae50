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
count is what kills it). A live word whose window column is past the grid
(``j_c >= n_win``) adds nothing, as the reference's scatter drops it, and
a live word that repeats a position adds once per occurrence. Both return
a new membrane; the input is kept.

- :func:`event_accum_cuda` — the CUDA kernel ``csrc/event_accum.cu``
  (replaces the Pallas TPU kernel ``event_accum``): a decode of the live
  words into packed kept bits and, for a (n, c) cell whose queues repeat a
  position, the multiplicity of each position (:func:`event_bits_plain`
  and :func:`event_mult_plain` are its plain versions), then the gather of
  ``csrc/spike_accum.cuh`` starting from the membrane (unrolled for K in
  {1, 3, 5, 7}, rolled for any other odd K);
- :func:`event_accum_plain` — the reference ``event_conv2d``'s order:
  offset by offset, every live event in (n, c, phase, slot) order.

The kernel adds into each output in (c, phase) order instead — the order of
``ref.fused_spike_accum_ordered_ref`` with ``init=v_mem`` (on the
multiplicities, with ``multiplicity=True``, where a queue repeats a
position), which it equals bit for bit — so on Gaussian weights it and the
plain version agree to rounding, not bit for bit; on dyadic weights every
sum is exact and they are equal. ``kernels.ops.event_accum`` picks between them by the tensor's
device.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _cuda
from .spike_pipeline import _SMEM_MAX, check_gather_fits


def _decode(words, counts, n_win, bits):
    """Window coordinates (i_c, j_c) of every slot, and which slots are live
    and name a grid position."""
    mask = (1 << bits) - 1
    i_c = (words >> bits) & mask
    j_c = words & mask
    slot = torch.arange(words.shape[-1], dtype=torch.int32,
                        device=words.device)
    live = (i_c < n_win) & (j_c < n_win) & (slot < counts[..., None])
    return i_c, j_c, live


def _live_events(words, counts, K, n_win, bits):
    """(n, c, y, x) of the live slots, in (n, c, phase, slot) order."""
    i_c, j_c, live = _decode(words, counts, n_win, bits)
    n, c, ph, d = torch.nonzero(live, as_tuple=True)
    y = i_c[n, c, ph, d] * K + ph // K
    x = j_c[n, c, ph, d] * K + ph % K
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


def pack_bits(kept):
    """(..., P) bool -> (..., ceil(P / 32)) int32 words, bit p % 32 of word
    p // 32 set <=> kept[..., p] (the kernels' uint32 bits, as int32)."""
    *lead, P = kept.shape
    nw = -(-P // 32)
    m = F.pad(kept.to(torch.int64), (0, nw * 32 - P)).reshape(*lead, nw, 32)
    v = (m << torch.arange(32, device=kept.device)).sum(-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def event_mult_plain(words, counts, *, n_win, bits):
    """The multiplicities of ``csrc/event_accum.cu``'s decode: (..., C_in,
    K², D) words with their counts -> (..., C_in, K², n_win²) int32, how
    many live slots name window position i_c * n_win + j_c (a live word
    with j_c >= n_win names none). With ``multiplicity=True``,
    ``ref.fused_spike_accum_ordered_ref`` on it (``depth`` = n_win²) is B4's
    order of adds."""
    P = n_win * n_win
    i_c, j_c, live = _decode(words, counts, n_win, bits)
    pos = torch.where(live, i_c * n_win + j_c, P).long()
    mult = torch.zeros((*words.shape[:-1], P + 1), dtype=torch.int32,
                       device=words.device)
    mult.scatter_add_(-1, pos, live.to(torch.int32))   # dead slots: spare P
    return mult[..., :P].contiguous()


def event_bits_plain(words, counts, *, n_win, bits):
    """The decode pass of ``csrc/event_accum.cu``: (..., C_in, K², D) words
    with their counts -> (..., C_in, K², ceil(n_win² / 32)) packed bits of
    the window positions that live slots name (:func:`event_mult_plain`
    above zero)."""
    return pack_bits(event_mult_plain(words, counts, n_win=n_win,
                                      bits=bits) > 0)


_ARGTYPES = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 12
             + (ctypes.c_void_p,))


def check_decode_fits(K, n_win):
    """Raise unless one (n, c) cell's decoded bits (K² * ceil(n_win² / 32)
    words, ``csrc/event_accum.cu``'s decode scratch) fit a block's shared
    memory: every square map up to about 1,360 x 1,360 at any K."""
    nbytes = 4 * K * K * -(-n_win * n_win // 32)
    if nbytes > _SMEM_MAX:
        raise ValueError(f"the decode of a {n_win}x{n_win}-window queue at "
                         f"K={K} needs {nbytes} bytes of shared memory per "
                         f"cell; the kernel has {_SMEM_MAX}")


def event_accum_cuda(words, counts, weights, v_mem, *, K, n_win, bits,
                     bits_out=None):
    """Launch ``csrc/event_accum.cu`` on the current stream: its decode,
    then its gather.

    ``words`` and ``counts`` may be a step's slice of a larger queue (a
    stride between rows); within a row they must be contiguous. The decode
    writes its packed bits into ``bits_out`` ((N, C_in, K², ceil(n_win² /
    32)) int32) when given, else into scratch. Its repeat flags and
    multiplicities go to scratch that no one clears: the decode writes a
    flag for every cell, and multiplicities only for the flagged ones.
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
    if (K2 != K * K or tuple(counts.shape) != (N, C_in, K2)
            or tuple(weights.shape) != (K, K, C_in, C_out)
            or v_mem.shape[0] != N):
        raise ValueError(f"shape mismatch: words {tuple(words.shape)}, counts "
                         f"{tuple(counts.shape)}, weights "
                         f"{tuple(weights.shape)}, v_mem "
                         f"{tuple(v_mem.shape)}, K={K}")
    check_gather_fits(K, n_win, H, W)
    check_decode_fits(K, n_win)
    shape = (N, C_in, K2, -(-n_win * n_win // 32))
    if bits_out is not None and (
            bits_out.device != dev or bits_out.dtype != torch.int32
            or tuple(bits_out.shape) != shape
            or not bits_out.is_contiguous()):
        raise ValueError(f"bits_out must be a contiguous int32 {shape} "
                         "tensor on the membrane's device")
    out = torch.empty_like(v_mem)
    if out.numel() == 0:
        return out
    if C_in == 0:                          # no queue, no event
        return out.copy_(v_mem)
    if not (words[0].is_contiguous() and counts[0].is_contiguous()
            and weights.is_contiguous() and v_mem.is_contiguous()):
        raise ValueError("words and counts must be contiguous within a row; "
                         "weights and v_mem contiguous")
    # one int32 allocation: the bits (unless given), the flags (N, C_in),
    # then the multiplicities (N, C_in, K², n_win²)
    n_bits = 0 if bits_out is not None else math.prod(shape)
    scratch = words.new_empty(n_bits + N * C_in * (1 + K2 * n_win * n_win))
    flags = scratch.data_ptr() + 4 * n_bits
    w = weights.float()                    # bf16 widens exactly
    fn = _cuda.kernel_fn("event_accum", "event_accum", _ARGTYPES)
    _cuda.launch_counts["event_accum"] += 1
    err = fn(words.data_ptr(), counts.data_ptr(), w.data_ptr(),
             v_mem.data_ptr(), out.data_ptr(),
             (scratch if bits_out is None else bits_out).data_ptr(),
             flags + 4 * N * C_in, flags, N, words.stride(0),
             counts.stride(0), C_in, K, D, n_win, bits, H, W, C_out,
             int(v_mem.dtype == torch.bfloat16), _cuda.stream_ptr(dev))
    _cuda.check_launch(err, "event_accum")
    return out
