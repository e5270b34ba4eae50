"""The queue encoder: the Hopper kernel and its plain version.

Port of ``repro.kernels.spike_compact``. Both functions turn occupancy rows
``occ`` (R = C·K², P = n_win²) into packed AE words ``(wy << bits) | wx``
appended in position order, ``depth`` slots per row with ``invalid`` in the
empty ones, and the uncapped event count per row (the caller derives the
overflow as ``max(count - depth, 0)``):

- :func:`spike_compact_cuda` — the CUDA kernel ``csrc/spike_compact.cu``
  (replaces the Pallas TPU kernel ``spike_compact``): a group of
  min(32, next power of two >= P) lanes per row, a block's rows staged in
  shared memory and stored 16 bytes at a time (rows deeper than one
  block's shared memory are written in place);
- :func:`spike_compact_plain` — ``aeq.compact_spikes``'s cumsum and
  scatter.

All of it is integer work, so the two agree bit for bit.
``kernels.ops.spike_compact`` picks between them by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.aeq import _scatter_rows
from . import _cuda


def spike_compact_plain(occ, *, n_win, bits, depth, invalid):
    """A cumsum gives each fired position its queue slot; a row-wise
    scatter drops the slots past ``depth``."""
    R, P = occ.shape
    fired = occ > 0
    pos = torch.arange(P, dtype=torch.int32, device=occ.device)
    packed = ((pos // n_win) << bits) | (pos % n_win)
    slot = torch.cumsum(fired.to(torch.int32), dim=1) - 1       # int64
    target = torch.where(fired & (slot < depth), slot, depth)
    words = torch.full((R, depth), invalid, dtype=torch.int32,
                       device=occ.device)
    words = _scatter_rows(words, target, packed.expand(R, P).contiguous())
    return words, fired.sum(1).to(torch.int32)


_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


def spike_compact_cuda(occ, *, n_win, bits, depth, invalid):
    """Launch ``csrc/spike_compact.cu`` on the current stream."""
    if occ.device.type != "cuda":
        raise ValueError("spike_compact_cuda needs occ on a CUDA device")
    if occ.dtype != torch.int32:
        raise TypeError(f"expected int32 occupancy, got {occ.dtype}")
    if occ.dim() != 2 or occ.shape[1] != n_win * n_win:
        raise ValueError(f"occ must be (R, n_win**2 = {n_win * n_win}), got "
                         f"{tuple(occ.shape)}")
    if not occ.is_contiguous():
        raise ValueError("occ must be contiguous")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    R, P = occ.shape
    words = torch.empty((R, depth), dtype=torch.int32, device=occ.device)
    counts = torch.empty((R,), dtype=torch.int32, device=occ.device)
    if R == 0:
        return words, counts
    fn = _cuda.kernel_fn("spike_compact", "spike_compact", _ARGTYPES)
    _cuda.launch_counts["spike_compact"] += 1
    err = fn(occ.data_ptr(), words.data_ptr(), counts.data_ptr(), R, P,
             n_win, bits, depth, invalid, _cuda.stream_ptr(occ.device))
    _cuda.check_launch(err, "spike_compact")
    return words, counts
