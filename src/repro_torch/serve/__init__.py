"""repro_torch.serve — the SNN serving runtime on the port's engine.

- :class:`~.batching.BucketPolicy` — dynamic batching into padded buckets;
- :class:`~.registry.ModelRegistry` — named models on one device, each with
  a plan per bucket (a captured CUDA graph on the card; over a data mesh,
  one per shard for the buckets that divide it);
- :class:`~.runtime.ServeRuntime` — admission queue + batcher +
  per-request energy metering through ``study.price_record``, on a wall or
  virtual clock;
- :mod:`~.persist` — registry checkpoints (params through
  ``repro_torch.checkpoint``, the bucket ladder re-captured at load, the
  reference's manifest and content keys): :func:`save_registry` /
  :func:`load_registry`;
- :mod:`~.fleet` — N replica processes serving one checkpointed registry
  behind one kernel compile cache
  (``python -m repro_torch.serve.fleet --replicas N --cache-dir D``);
- :mod:`~.bench` — the closed- and open-loop load generator
  (``python -m repro_torch.serve.bench``).
"""
from .api import InferRequest, InferResponse, ServeError  # noqa: F401
from .batching import DEFAULT_BUCKETS, BucketPolicy  # noqa: F401
from .persist import (CheckpointError, CorruptCheckpointError,  # noqa: F401
                      StaleCheckpointError, load_registry, save_registry)
from .registry import (EagerPlan, GraphPlan, ModelHandle,  # noqa: F401
                       ModelRegistry)
from .runtime import ServeRuntime  # noqa: F401

__all__ = [
    "InferRequest", "InferResponse", "ServeError",
    "BucketPolicy", "DEFAULT_BUCKETS",
    "EagerPlan", "GraphPlan", "ModelHandle", "ModelRegistry",
    "ServeRuntime",
    "CheckpointError", "StaleCheckpointError", "CorruptCheckpointError",
    "save_registry", "load_registry",
]
