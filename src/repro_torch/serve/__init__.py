"""repro_torch.serve — the SNN serving runtime on the port's engine.

- :class:`~.batching.BucketPolicy` — dynamic batching into padded buckets;
- :class:`~.registry.ModelRegistry` — named models on one device;
- :class:`~.runtime.ServeRuntime` — admission queue + batcher +
  per-request energy metering through ``study.price_record``.
"""
from .api import InferRequest, InferResponse, ServeError  # noqa: F401
from .batching import DEFAULT_BUCKETS, BucketPolicy  # noqa: F401
from .registry import ModelHandle, ModelRegistry  # noqa: F401
from .runtime import ServeRuntime  # noqa: F401

__all__ = [
    "InferRequest", "InferResponse", "ServeError",
    "BucketPolicy", "DEFAULT_BUCKETS",
    "ModelHandle", "ModelRegistry",
    "ServeRuntime",
]
