"""Occupancy-gated sparse spike pipeline: the Hopper kernel and its plain version.

Port of ``repro.kernels.spike_sparse``. Both functions compute what the
fused pipeline (``spike_pipeline``) computes — for occupancy ``occ``
(N, C_in, K², P) int32 and HWIO weights (K, K, C_in, C_out), the
(N, H, W, C_out) fp32 charge of the events that survive a depth-``depth``
queue per (row, channel, phase) — with work that drops with the spike rate,
and optionally an int-quantized accumulate (``weight_bits``: int8 weights,
exact integer sums, one fp32 dequant):

- :func:`fused_spike_accum_sparse_cuda` — the CUDA kernel
  ``csrc/spike_sparse.cu`` (replaces the Pallas TPU kernel
  ``fused_spike_accum_sparse_pallas``): the kept bits with per-cell gates,
  an active-first row order, and B1's gather (``csrc/spike_accum.cuh``)
  over the first ``n_rows`` rows, the int path summed in fp32 below 2^24
  and in int32 past it;
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

from ..audit.contracts import KernelContract, QuantContract
from ..core.quantization import quantize_symmetric
from . import _cuda
from . import spike_pipeline
from .spike_pipeline import check_gather_fits, kept_bit_words

# Declared intent, verified by ``python -m repro_torch.audit``: with
# ``weight_bits`` the accumulate is int8 weights -> exact integer sums ->
# ONE fp32 dequant; the dispatcher's bucket pull is the declared
# 'occupancy-gate' host sync (marked in engine.py). On the card the int
# path hands the kernel its weights as fp32 integers while every partial
# sum is below 2^24 (``int_sums_fit_fp32``) and dequantizes inside the
# kernel: the audit flags that direct int8 -> fp32 convert, and the port's
# baseline carries it with that reason.
CONTRACT = KernelContract(name="fused_spike_accum_sparse", module=__name__,
                          accum_dtype="int32", quant=QuantContract(),
                          allowed_host_syncs=("occupancy-gate",))


def smem_blocks(**geometry):
    """The dynamic shared memory a block of B1's gather, which this kernel
    runs over its first ``n_rows`` rows, requests, as data (see
    ``spike_pipeline.smem_blocks``); its encode and row-order launches use
    none."""
    return spike_pipeline.smem_blocks(**geometry)


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

_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 10
             + (ctypes.c_void_p,))


def int_sums_fit_fp32(K, C_in) -> bool:
    """Whether every partial sum of the int path (at most K*K*C_in
    quantized weights, each of magnitude <= 127) is an integer below 2^24,
    exact in fp32: then the kernel adds the integers in fp32, else in
    int32."""
    return K * K * C_in * 127 < 2 ** 24


def fused_spike_accum_sparse_cuda(occ, weights, *, K, n_win, depth, H, W,
                                  n_rows=None, weight_bits=None):
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
    check_gather_fits(K, n_win, H, W)
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
    C_out = weights.shape[-1]
    dev = occ.device
    # rows past n_rows are never launched: their output stays zeros
    alloc = torch.empty if n_rows == N else torch.zeros
    out = alloc((N, H, W, C_out), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    quant = 0
    if weight_bits is not None:
        # the integers in fp32 while every partial sum is an integer below
        # 2^24 (each add exact, the sum the int32 one, at the fp32 rate);
        # past that in int32, summed in int32
        w_use, w_scale = quantize_symmetric(weights, weight_bits)
        quant = 1 if int_sums_fit_fp32(K, C_in) else 2
        w_use = w_use.to(torch.float32 if quant == 1 else torch.int32)
        w_use = w_use.contiguous()
        scale_ptr = w_scale.data_ptr()
    else:
        w_use, scale_ptr = weights, None
    # kept bits, cell totals (N*C_in), row activity and the active-first
    # row order (N each)
    scratch = torch.empty(kept_bit_words(occ.shape) + N * C_in + 2 * N,
                          dtype=torch.int32, device=dev)
    fn = _cuda.kernel_fn("spike_sparse", "fused_spike_accum_sparse",
                         _ARGTYPES)
    _cuda.launch_counts["fused_spike_accum_sparse"] += 1
    err = fn(occ.data_ptr(), w_use.data_ptr(), scale_ptr, scratch.data_ptr(),
             out.data_ptr(), N, n_rows, C_in, K, n_win, depth, H, W, C_out,
             quant, _cuda.stream_ptr(dev))
    _cuda.check_launch(err, "fused_spike_accum_sparse")
    return out


def launch_smem(*, K, n_win, H, W, **_unused) -> int:
    """The dynamic shared memory the compiled launcher requests per gather
    block (``csrc/spike_sparse.cu``'s ``fused_spike_accum_sparse_smem``)."""
    fn = _cuda.kernel_fn("spike_sparse", "fused_spike_accum_sparse_smem",
                         (ctypes.c_int,) * 4, ctypes.c_longlong)
    return fn(K, n_win, H, W)
