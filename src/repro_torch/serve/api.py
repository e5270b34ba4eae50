"""Request/response types and errors (port of ``repro.serve.api``)."""
from __future__ import annotations

import dataclasses

import numpy as np

from ..study.artifacts import StatsRecord


class ServeError(RuntimeError):
    """A serving-layer failure (unknown model, bad request geometry, ...)."""


@dataclasses.dataclass
class InferRequest:
    """One admitted inference request, waiting in (or taken from) the queue."""

    rid: int
    model: str
    image: np.ndarray            # (H, W, C) float32, the model's geometry
    arrival_s: float = 0.0       # clock time at submit (wall or virtual)


@dataclasses.dataclass
class InferResponse:
    """The completed request: prediction + per-request accounting.

    ``energy_j`` / ``model_latency_s`` price this request's stats row
    through ``study.price_record``, so per-request totals sum to a one-shot
    pricing of the same stats.
    """

    rid: int
    model: str
    logits: np.ndarray           # (n_out,)
    pred: int
    stats: StatsRecord           # (1, L) rows — this request only
    energy_j: float              # energy-model estimate for this request
    model_latency_s: float       # energy-model latency (pricing model)
    bucket: int                  # padded batch size the request rode in
    batch_valid: int             # how many real requests shared that bucket
    queue_wait_s: float          # admission -> batch launch
    service_s: float             # the bucket's execute wall time
    batch_form_s: float = 0.0    # model pick + take + pad, up to launch
    price_s: float = 0.0         # the six pulls + batch pricing + responses
    pad_fraction: float = 0.0    # padded slots / bucket for this batch
    step_total_s: float = 0.0    # the whole step() wall time (telescoped)

    @property
    def latency_s(self) -> float:
        """End-to-end serving latency: queue wait + batch service."""
        return self.queue_wait_s + self.service_s

    @property
    def breakdown(self) -> dict:
        """The per-request time breakdown, in waterfall order. The three
        step parts telescope: ``batch_form_s + service_s + price_s ==
        step_total_s`` up to float rounding. Finer, the runtime cuts each
        step into seven phases (``serve.runtime.PHASES``, summed per bucket
        in ``stats_summary()["phase_s"]``): ``execute_s`` is ``copy_in +
        launch + sync_wait`` and ``price_s`` is ``pull + price +
        respond``."""
        return {
            "queue_wait_s": self.queue_wait_s,
            "batch_form_s": self.batch_form_s,
            "execute_s": self.service_s,
            "price_s": self.price_s,
        }
