"""Hopper kernels of the port (CUDA C++ in ``../csrc``), their plain PyTorch
versions, and the device dispatch in :mod:`.ops`."""
