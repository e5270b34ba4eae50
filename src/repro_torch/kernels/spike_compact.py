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

from ..audit.contracts import SMEM_BUDGET_BYTES, KernelContract
from ..core.aeq import _scatter_rows
from . import _cuda

# Declared intent, verified by ``python -m repro_torch.audit``: integer
# work only (int32 words and counts), no host syncs, and the row tile of
# :func:`smem_blocks` within one block's budget at every paper geometry.
CONTRACT = KernelContract(name="spike_compact", module=__name__,
                          accum_dtype="int32")

_THREADS = 256          # most threads a block (csrc kThreads)
_TILE_WORDS = 8192      # words a block stages (csrc kTileWords, 32 KiB)


def smem_blocks(*, n_win, depth, **_unused):
    """The dynamic shared memory a block of ``csrc/spike_compact.cu``
    requests, as data, for ``audit.smem``: its rows' words, rounded up to
    whole 16-byte stores plus one store of slack for the first row's
    alignment. A row of ``min(32, next power of two >= P)`` lanes; as many
    rows a block as fit ``_THREADS`` lanes and ``_TILE_WORDS`` words (at
    least one); a tile past one block's budget is not staged (the rows are
    written in place)."""
    P = n_win * n_win
    lanes = min(32, 1 << max(P - 1, 0).bit_length())
    rows = max(1, min(_THREADS // lanes, _TILE_WORDS // depth))
    words = -(-rows * depth // 4) * 4 + 4
    if 4 * words > SMEM_BUDGET_BYTES:
        return []
    return [("row_tile", (words,), 4, False)]


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


def launch_smem(*, n_win, depth, **_unused) -> int:
    """The dynamic shared memory the compiled launcher requests per block
    (``csrc/spike_compact.cu``'s ``spike_compact_smem``)."""
    fn = _cuda.kernel_fn("spike_compact", "spike_compact_smem",
                         (ctypes.c_int,) * 2, ctypes.c_longlong)
    return fn(n_win * n_win, depth)
