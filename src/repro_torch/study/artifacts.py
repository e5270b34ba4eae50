"""The recorded per-sample stats (port of ``repro.study.artifacts.StatsRecord``)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
