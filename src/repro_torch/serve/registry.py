"""Named serving handles (port of ``repro.serve.registry``, no mesh/AOT/persistence).

A :class:`ModelHandle` owns one servable SNN — params and thresholds on
its device, the engine config and the backend. PyTorch
runs eagerly, so there is no per-bucket compiled plan to cache; a captured
CUDA graph per bucket would take that place.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..core import engine
from ..device import resolve_device
from .api import ServeError
from .batching import DEFAULT_BUCKETS


class ModelHandle:
    """One servable model: artifacts on the device + the bucket runner."""

    def __init__(self, name: str, params, thresholds, cfg, *,
                 backend: str = "queue_pallas", device=None):
        engine.get_backend(backend)          # fail fast on unknown names
        self.device = resolve_device(device)
        self.name = name
        self.params, self.thresholds = engine.to_device(params, thresholds,
                                                        self.device)
        self.cfg = cfg
        self.backend = backend

    def run_bucket(self, images, n_valid: int):
        """Execute one padded (B, H, W, C) bucket; return the valid prefix.

        Synchronizes the device before returning, so the caller's clock
        read after it covers the bucket's execution.
        """
        images = torch.as_tensor(np.asarray(images, np.float32),
                                 device=self.device)
        logits, stats = engine.infer_batch(
            self.params, self.thresholds, self.cfg, images,
            backend=self.backend, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return engine.slice_valid(logits, stats, n_valid)

    def warmup(self, buckets=DEFAULT_BUCKETS) -> None:
        """Execute each bucket once (builds the kernels, picks cuDNN
        algorithms and warms the allocator) before the first request."""
        cfg = self.cfg
        for b in buckets:
            zeros = np.zeros((b, cfg.input_hw, cfg.input_hw, cfg.input_c),
                             np.float32)
            self.run_bucket(zeros, b)


class ModelRegistry:
    """Name -> :class:`ModelHandle`, LRU-bounded to ``capacity`` models."""

    def __init__(self, capacity: int = 4, *, device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.device = resolve_device(device)
        self._models: collections.OrderedDict = collections.OrderedDict()

    def register(self, name: str, params, thresholds, cfg, *,
                 backend: str = "queue_pallas") -> ModelHandle:
        """Register artifacts under ``name`` (replaces any old one)."""
        handle = ModelHandle(name, params, thresholds, cfg, backend=backend,
                             device=self.device)
        self._models.pop(name, None)
        self._models[name] = handle
        while len(self._models) > self.capacity:
            self._models.popitem(last=False)
        return handle

    def get(self, name: str) -> ModelHandle:
        try:
            handle = self._models[name]
        except KeyError:
            raise ServeError(
                f"unknown model {name!r}; registered models: "
                f"{sorted(self._models)}") from None
        self._models.move_to_end(name)
        return handle

    def names(self) -> tuple:
        return tuple(self._models)

    def __contains__(self, name: str) -> bool:
        return name in self._models

    def __len__(self) -> int:
        return len(self._models)
