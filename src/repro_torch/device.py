"""Where the port runs: CUDA unless the caller explicitly asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; a missing GPU then raises instead of quietly
    running on the CPU. Pass ``device="cpu"`` to run there on purpose.

    On a CUDA device this also turns TF32 off for cuDNN convolutions and
    cuBLAS matmuls: the neuron threshold test ``v > vth`` turns a 1e-3
    TF32 error into different spikes, and the reference computes in full
    fp32.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU explicitly")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device
