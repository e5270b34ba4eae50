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
``kernels.ops.moe_gather`` picks between them by the tensor's device,
through :class:`MoEGather`, which gives the gather its gradient: each live
slot's gradient row added into its token's row (``index_add_``), nothing
for an empty slot. The reference has no backward kernel (XLA
differentiates its inline gather), so the backward is plain PyTorch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..audit.contracts import KernelContract
from . import _cuda

# A copy accumulates nothing; the contract records the module for
# ``audit.smem``, whose budget check holds :func:`smem_blocks` at the row
# widths the LM stack launches (SMEM_GEOMETRIES) and, on the card, to the
# launcher's own bytes (``moe_gather_smem``).
CONTRACT = KernelContract(name="moe_gather", module=__name__,
                          accum_dtype="none")

_STAGES = 4             # csrc kStages
_STAGE_BYTES = 16384    # csrc kStageBytes
_MAX_SLOTS = 2048       # csrc kMaxSlots: slots a block owns at most
_WARP_ROW_BYTES = 512   # rows up to 32 16-byte units take the warp copy
H100_SMS = 132

#: ``smem_blocks`` reads the card's SM count (``compare_launchers`` passes it)
SMEM_BY_SM_COUNT = True

#: The dispatch shapes of the LM stack: Qwen1.5-MoE-A2.7B's d_model 2,048
#: (S = 60 experts x capacity: 480 a 4-row decode step, 5,280 a 1,024-token
#: training microbatch, 10,560 a 4 x 512 prefill) and the smoke
#: configurations' 64 (S = 64), each in bf16 and fp32.
SMEM_GEOMETRIES = tuple(
    dict(row_bytes=d * esize, S=S)
    for d, slots in ((2048, (480, 5280, 10560)), (64, (64,)))
    for esize in (2, 4) for S in slots)


def smem_blocks(*, row_bytes, S, sm_count=H100_SMS, **_unused):
    """The dynamic shared memory a block of ``csrc/moe_gather.cu``'s launch
    requests, as data, for ``audit.smem``: on the bulk route (a row of
    16-byte units longer than 512 B) ``kStages`` ring stages of whole rows
    (as many as fit ``kStageBytes`` and the block's slots) or of one piece
    of a longer row, then the block's int32 token table; none for the warp
    copy. Mirrors ``bulk_plan``."""
    if row_bytes % 16 or row_bytes <= _WARP_ROW_BYTES:
        return []
    grid = max(min(2 * sm_count, S), math.ceil(S / _MAX_SLOTS))
    per_block = math.ceil(S / grid)
    stage = _STAGE_BYTES
    if row_bytes <= _STAGE_BYTES:
        stage = min(_STAGE_BYTES // row_bytes, per_block) * row_bytes
    return [("stages", (_STAGES, stage), 1, False),
            ("tokens", (per_block,), 4, False)]


def launch_smem(*, row_bytes, S, **_unused) -> int:
    """The dynamic shared memory the compiled launcher requests per block
    (``csrc/moe_gather.cu``'s ``moe_gather_smem``) on the current card."""
    fn = _cuda.kernel_fn("moe_gather", "moe_gather_smem",
                         (ctypes.c_int,) * 2, ctypes.c_longlong)
    return fn(S, row_bytes)


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


class MoEGather(torch.autograd.Function):
    """The dispatch gather with a gradient: B6 forward on a CUDA tensor
    (the plain version on a CPU one), ``index_add_`` backward."""

    @staticmethod
    def forward(ctx, x, indices):
        ctx.save_for_backward(indices)
        ctx.rows = x.shape[0]
        if x.device.type == "cuda":
            return moe_gather_cuda(x, indices)
        return moe_gather_plain(x, indices)

    @staticmethod
    def backward(ctx, grad_out):
        (indices,) = ctx.saved_tensors
        T = ctx.rows
        # an empty slot adds into a sentinel row T that is cut off; an
        # index past the rows was clamped to the last one, and adds there
        at = torch.where(indices >= 0, torch.clamp(indices, max=T - 1),
                         T).long()
        grad = grad_out.new_zeros((T + 1, grad_out.shape[1]))
        grad.index_add_(0, at, grad_out)
        return grad[:T], None
