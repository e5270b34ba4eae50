"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package re-implements its
serving path in PyTorch, with hand-written CUDA kernels (``csrc/``) where
the reference runs Pallas TPU kernels. It imports neither ``jax`` nor
``repro``: what it needs from numpy-only modules there is copied here.

Layout mirrors the reference so every counterpart is easy to find:
``core/`` (encoding, AEQ helpers, neurons, the engine), ``kernels/`` (the
Hopper kernels, their plain PyTorch versions and the dispatch layer),
``serve/`` (registry + runtime), ``study/`` (the staged study and the
grid sweep), ``parallel/`` and ``sharding/`` (data-parallel execution over
a device mesh) and ``data/`` (procedural datasets).

Device discipline: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without that explicit request they
raise (``device.resolve_device``).
"""
