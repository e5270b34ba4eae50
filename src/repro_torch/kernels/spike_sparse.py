"""Occupancy-gated sparse spike pipeline: the Hopper kernel and its plain version.

Port of ``repro.kernels.spike_sparse``. Both functions compute what the
fused pipeline (``spike_pipeline``) computes — for occupancy ``occ``
(N, C_in, K², P) int32 and HWIO weights (K, K, C_in, C_out), the
(N, H, W, C_out) fp32 charge of the events that survive a depth-``depth``
queue per (row, channel, phase) — with work that drops with the spike rate,
and optionally an int-quantized accumulate (``weight_bits``: int8 weights,
exact int32 sums, one fp32 dequant):

- :func:`fused_spike_accum_sparse_cuda` — the CUDA kernel
  ``csrc/spike_sparse.cu`` (replaces the Pallas TPU kernel
  ``fused_spike_accum_sparse_pallas``): per-cell gates and the ragged
  ``n_rows`` grid of active rows;
- :func:`fused_spike_accum_sparse_plain` — the event-list realization
  ``fused_spike_accum_sparse``: the drop rule, a prefix-sum compaction
  into an ``e_cap``-slot list in the oracle's flattened
  (n, c, phase, position) order, then K² scatter-adds of C_out-wide rows.

The occupancy-gate helpers (:func:`kept_event_count`, :func:`event_bucket`,
:func:`max_kept_events`) are what the engine's ``queue_sparse`` dispatcher
uses to size the work. ``kernels.ops.fused_spike_accum(impl="sparse")``
picks between kernel and plain version by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.quantization import quantize_symmetric
from . import _cuda


# ---------------------------------------------------------------------------
# The occupancy gate (host-side dispatch helpers)
# ---------------------------------------------------------------------------

def kept_event_count(occ: torch.Tensor, *, depth: int) -> torch.Tensor:
    """Total events surviving the depth-``depth`` drop rule — () int32.

    Capping per (…, phase) queue at ``depth`` mirrors the queue encoder, so
    the budget never under-counts what the sparse accumulator must hold.
    """
    tot = (occ > 0).sum(-1)
    return torch.clamp(tot, max=depth).sum().to(torch.int32)


def event_bucket(n_events: int, cap: int) -> int:
    """Round a host-side event count up to a power-of-two capacity,
    clamped to ``cap`` (the static worst case, every queue full)."""
    n = max(int(n_events), 1)
    b = 1
    while b < n:
        b <<= 1
    return min(b, max(int(cap), 1))


def max_kept_events(occ_shape, depth: int) -> int:
    """Static worst-case surviving events for an occupancy shape."""
    n, c, k2, p = occ_shape
    return n * c * k2 * min(depth, p)


# ---------------------------------------------------------------------------
# Plain version: the event-list realization
# ---------------------------------------------------------------------------

def fused_spike_accum_sparse_plain(occ, weights, *, K, n_win, depth, H, W,
                                   e_cap, weight_bits=None):
    """Sparse compact+accumulate over an ``e_cap``-slot event list.

    The caller passes ``e_cap >= kept_event_count(occ)``; padded slots add
    exact zeros. The adds go offset by offset, each over the events in
    flattened (n, c, phase, position) order — the scatter oracle's order —
    and ``index_add_`` on the CPU adds in index order, so there the fp32
    result is bit-identical to ``ref.fused_spike_accum_ref`` and to the
    reference's event list. On the card ``index_add_`` uses atomics. With
    ``weight_bits`` the integer weights accumulate exactly in int32 and one
    fp32 multiply by the scale dequantizes.
    """
    N, C_in, K2, P = occ.shape
    C_out = weights.shape[-1]
    pad = K // 2
    dev = occ.device

    fired = occ > 0
    if depth < P:  # the drop rule; no queue can fill otherwise
        slot = torch.cumsum(fired.to(torch.int32), dim=-1) - 1
        fired = fired & (slot < depth)

    # prefix-sum index map: each surviving event's slot in the compacted
    # list (flattened row-major, the oracle's event order)
    keptf = fired.reshape(-1)
    pos = torch.cumsum(keptf.to(torch.int32), dim=0) - 1
    listed = keptf & (pos < e_cap)
    ev = torch.full((e_cap,), -1, dtype=torch.int64, device=dev)
    ev[pos[listed]] = torch.nonzero(listed).reshape(-1)   # flat index or -1

    valid = ev >= 0
    f = torch.clamp(ev, min=0)
    p_ = f % P
    ph = (f // P) % K2
    c = (f // (P * K2)) % C_in
    n = f // (P * K2 * C_in)
    y = (p_ // n_win) * K + ph // K
    x = (p_ % n_win) * K + ph % K

    if weight_bits is not None:
        w_q, w_scale = quantize_symmetric(weights, weight_bits)
        w_use = w_q.to(torch.int32)
    else:
        w_use = weights
    acc = torch.zeros((N * H * W, C_out), dtype=w_use.dtype, device=dev)
    for dy in range(K):
        for dx in range(K):
            ty = y - dy + pad
            tx = x - dx + pad
            ok = valid & (ty >= 0) & (ty < H) & (tx >= 0) & (tx < W)
            contrib = w_use[dy, dx][c] * ok[:, None].to(w_use.dtype)
            target = ((n * H + torch.clamp(ty, 0, H - 1)) * W
                      + torch.clamp(tx, 0, W - 1))
            acc.index_add_(0, target, contrib)
    acc = acc.reshape(N, H, W, C_out)
    if weight_bits is not None:
        return acc.to(torch.float32) * w_scale
    return acc


# ---------------------------------------------------------------------------
# The Hopper kernel
# ---------------------------------------------------------------------------

_TILE = 32             # output channels per block (kTile in the source)
_SMEM_MAX = 232_448    # shared memory one Hopper block may opt in to
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 11
             + (ctypes.c_void_p,))


def fused_spike_accum_sparse_cuda(occ, weights, *, K, n_win, bits, depth, H,
                                  W, n_rows=None, weight_bits=None):
    """Launch ``csrc/spike_sparse.cu`` on the current stream.

    ``n_rows`` (default N) must be at least the number of rows with any
    event: the kernel runs the first ``n_rows`` rows of a stable
    active-first order built on the device, and every other row of the
    output is exact zeros.
    """
    if occ.device.type != "cuda" or weights.device != occ.device:
        raise ValueError("fused_spike_accum_sparse_cuda needs occ and "
                         "weights on the same CUDA device")
    if occ.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(f"expected int32 occupancy and float32 weights, got "
                        f"{occ.dtype} and {weights.dtype}")
    N, C_in, K2, P = occ.shape
    if K not in (1, 3, 5, 7):
        raise ValueError(f"the kernel is built for K in (1, 3, 5, 7), got {K}")
    if (K2 != K * K or P != n_win * n_win
            or tuple(weights.shape[:3]) != (K, K, C_in)):
        raise ValueError(f"shape mismatch: occ {tuple(occ.shape)}, weights "
                         f"{tuple(weights.shape)}, K={K}, n_win={n_win}")
    if not (occ.is_contiguous() and weights.is_contiguous()):
        raise ValueError("occ and weights must be contiguous")
    if weight_bits is not None and not 2 <= weight_bits <= 8:
        raise ValueError(f"the int path takes int8 weights: weight_bits in "
                         f"[2, 8], got {weight_bits}")
    n_rows = N if n_rows is None else int(n_rows)
    if not 0 <= n_rows <= N:
        raise ValueError(f"n_rows must be in [0, {N}], got {n_rows}")
    smem = 4 * (H * W * _TILE + K2 * min(depth, P) + K2)
    if smem > _SMEM_MAX:
        raise ValueError(f"a {H}x{W} charge map needs {smem} bytes of shared "
                         f"memory per block; the kernel has {_SMEM_MAX}")
    C_out = weights.shape[-1]
    dev = occ.device
    # rows past n_rows are never launched: their output stays zeros
    alloc = torch.empty if n_rows == N else torch.zeros
    out = alloc((N, H, W, C_out), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    if weight_bits is not None:
        w_use, w_scale = quantize_symmetric(weights, weight_bits)
        w_use = w_use.contiguous()
        scale_ptr = w_scale.data_ptr()
    else:
        w_use, scale_ptr = weights, None
    # gate scratch: cell totals and fill bounds (N*C_in each), row
    # activity and the active-first row order (N each)
    scratch = torch.empty(2 * N * C_in + 2 * N, dtype=torch.int32,
                          device=dev)
    fn = _cuda.kernel_fn("spike_sparse", "fused_spike_accum_sparse",
                         _ARGTYPES)
    _cuda.launch_counts["fused_spike_accum_sparse"] += 1
    err = fn(occ.data_ptr(), w_use.data_ptr(), scale_ptr, scratch.data_ptr(),
             out.data_ptr(), N, n_rows, C_in, K, n_win, bits, depth, H, W,
             C_out, int(weight_bits is not None), _cuda.stream_ptr(dev))
    _cuda.check_launch(err, "fused_spike_accum_sparse")
    return out
