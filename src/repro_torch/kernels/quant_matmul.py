"""int8 x int8 -> int32 matmul with fp32 dequant: Hopper kernel + plain version.

Port of ``repro.kernels.quant_matmul``. Both functions return
``float(a_q @ b_q) * (a_scale * b_scale)`` with an exact integer product:

- :func:`quant_matmul_cuda` — the CUDA kernel ``csrc/quant_matmul.cu``
  (replaces the Pallas TPU kernel ``quant_matmul``): K split across the
  blocks of a thread-block cluster, int8 tensor-core products into int32,
  the partials summed in the cluster leader's shared memory, one launch;
- :func:`quant_matmul_plain` — the same integer product as int32 products
  summed over K in int32 (CUDA has no integer ``torch.matmul``), exact
  while K * 128**2 < 2**31, then the same fp32 dequant.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda


def quant_matmul_plain(a_q, b_q, a_scale, b_scale):
    """Broadcast (M, K, N) int32 products, summed over K in int32.

    Holds M*K*N int32 values at once: meant for the output head's shapes
    (M = bucket, K = flattened features, N = classes)."""
    a = a_q.to(torch.int32)[:, :, None]
    prod = (a * b_q.to(torch.int32)[None]).sum(1, dtype=torch.int32)
    return prod.to(torch.float32) * (a_scale * b_scale)


_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def quant_matmul_cuda(a_q, b_q, a_scale, b_scale):
    """Launch ``csrc/quant_matmul.cu`` on the current stream."""
    dev = a_q.device
    tensors = (a_q, b_q, a_scale, b_scale)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("quant_matmul_cuda needs all operands on the same "
                         "CUDA device")
    if a_q.dtype != torch.int8 or b_q.dtype != torch.int8:
        raise TypeError(f"expected int8 operands, got {a_q.dtype}, {b_q.dtype}")
    if a_scale.dtype != torch.float32 or b_scale.dtype != torch.float32:
        raise TypeError("scales must be float32")
    if a_scale.numel() != 1 or b_scale.numel() != 1:
        raise ValueError("scales must be single values")
    M, K = a_q.shape
    K2, N = b_q.shape
    if K != K2:
        raise ValueError(f"inner dimensions differ: {K} vs {K2}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    fn = _cuda.kernel_fn("quant_matmul", "quant_matmul", _ARGTYPES)
    _cuda.launch_counts["quant_matmul"] += 1
    err = fn(a_q.data_ptr(), b_q.data_ptr(), a_scale.data_ptr(),
             b_scale.data_ptr(), out.data_ptr(), M, K, N,
             _cuda.stream_ptr(dev))
    _cuda.check_launch(err, "quant_matmul")
    return out
