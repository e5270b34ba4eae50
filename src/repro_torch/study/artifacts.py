"""Typed artifacts flowing between the Study pipeline stages (port of
``repro.study.artifacts``).

Each stage produces one artifact type, carrying the content key it was
cached under. Params and thresholds stay tensors on the stage's device
(the trained net never leaves the card between stages); images, logits and
stats records are numpy, as in the reference, and go to disk as numpy.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class TrainArtifact(NamedTuple):
    """Output of the ``train`` stage (or a wrapper around caller params)."""

    params: list            # per-layer {'w','b'} float32 tensors
    train_images: np.ndarray | None   # None when params came from the caller
    train_labels: np.ndarray | None
    key: str


class ConvertArtifact(NamedTuple):
    """Output of the ``convert`` stage: the m-TTFS SNN."""

    snn_params: list        # normalized weights (same list layout)
    thresholds: list        # per-layer V_t (balanced when spec.balance)
    key: str


class DirectTrainArtifact(NamedTuple):
    """Output of the ``train_snn`` stage (surrogate-gradient training),
    field-compatible with :class:`ConvertArtifact`: ``collect`` consumes
    either."""

    snn_params: list
    thresholds: list
    key: str


class StatsRecord(NamedTuple):
    """Raw per-sample SNNStats as numpy, stacked over N samples.

    All fields are integer counts, so pricing a record equals pricing a
    fresh inference bit for bit.
    """

    events_in: np.ndarray    # (N, L) events consumed per layer
    spikes_out: np.ndarray   # (N, L) spikes emitted per layer
    add_ops: np.ndarray      # (N, L) scalar accumulations
    queue_words: np.ndarray  # (N, L) peak words resident per layer queue
    overflow: np.ndarray     # (N,)  dropped events per sample

    def as_snn_stats(self):
        """Rehydrate to an engine :class:`SNNStats` of CPU tensors."""
        import torch

        from ..core.engine import SNNStats

        return SNNStats(**{f: torch.as_tensor(getattr(self, f))
                           for f in SNNStats._fields})


class CollectArtifact(NamedTuple):
    """Output of the ``collect`` stage: one batched SNN inference pass."""

    images: np.ndarray       # (N, H, W, C) — kept so pricing variants can
                             # re-evaluate the *CNN* side (bit-width sweeps)
    snn_logits: np.ndarray   # (N, n_out)
    snn_pred: np.ndarray     # (N,) argmax, computed at collect time
    stats: StatsRecord
    key: str
