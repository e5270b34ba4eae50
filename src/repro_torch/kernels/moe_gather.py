"""MoE dispatch row gather: the Hopper kernel and its plain version.

Port of ``repro.kernels.moe_gather``. Both functions gather rows of token
activations ``x`` (T, d), of any dtype, into S capacity slots by an int32
token index per slot; an index of -1 (any negative one) gives a zero row:

- :func:`moe_gather_cuda` — the CUDA kernel ``csrc/moe_gather.cu``
  (replaces the Pallas TPU kernel ``moe_gather``): rows copied as raw
  bytes, by bulk copies through shared memory where a row is longer than
  512 bytes and its size and both pointers are 16-byte aligned, else by a
  warp in the widest vectors they allow;
- :func:`moe_gather_plain` — an index and a ``where``.

A copy is exact, so the two agree bit for bit. Indices past the last row
are clamped to it, as the reference oracle clamps them.
``kernels.ops.moe_gather`` picks between them by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda


def moe_gather_plain(x, indices):
    rows = x[torch.clamp(indices, 0, x.shape[0] - 1).long()]
    return torch.where((indices >= 0)[:, None], rows, torch.zeros_like(rows))


_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def moe_gather_cuda(x, indices):
    """Launch ``csrc/moe_gather.cu`` on the current stream."""
    if x.device.type != "cuda" or indices.device != x.device:
        raise ValueError("moe_gather_cuda needs x and indices on the same "
                         "CUDA device")
    if indices.dtype != torch.int32 or indices.dim() != 1:
        raise TypeError(f"indices must be (S,) int32, got {indices.dtype} of "
                        f"shape {tuple(indices.shape)}")
    if x.dim() != 2 or not (x.is_contiguous() and indices.is_contiguous()):
        raise ValueError("x must be a contiguous (T, d) tensor")
    T, d = x.shape
    S = indices.shape[0]
    out = torch.empty((S, d), dtype=x.dtype, device=x.device)
    if S == 0 or d == 0:
        return out
    if T == 0:
        raise ValueError("cannot gather from an empty x")
    row_bytes = d * x.element_size()
    vec = 16   # the widest copy unit the row and both pointers allow
    while row_bytes % vec or x.data_ptr() % vec or out.data_ptr() % vec:
        vec //= 2
    fn = _cuda.kernel_fn("moe_gather", "moe_gather", _ARGTYPES)
    _cuda.launch_counts["moe_gather"] += 1
    err = fn(x.data_ptr(), indices.data_ptr(), out.data_ptr(), T, S,
             row_bytes, vec, _cuda.stream_ptr(x.device))
    _cuda.check_launch(err, "moe_gather")
    return out
