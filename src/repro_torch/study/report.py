"""Report — the priced result of one study point (port of
``repro.study.report``, numpy as there).

The reference's fields, plus the :class:`StudySpec` it was priced under,
JSON emission, and sweep grouping helpers for the paper's multi-variant
tables.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _deciles(a) -> list:
    return [float(q) for q in np.percentile(a, [0, 10, 25, 50, 75, 90, 100])]


@dataclass
class Report:
    dataset: str
    cnn_acc: float
    snn_acc: float
    agreement: float                 # fraction of samples where argmax matches
    snn_energy_j: np.ndarray         # per-sample
    cnn_energy_j: float
    snn_latency_s: np.ndarray
    cnn_latency_s: float
    snn_fps_per_w: np.ndarray
    cnn_fps_per_w: float
    spikes_per_sample: np.ndarray
    events_per_sample: np.ndarray
    overflow: int
    per_class_spikes: dict = field(default_factory=dict)
    spec: object = None              # the StudySpec this was priced under

    def summary_rows(self):
        def rng(a):
            return f"[{np.min(a):.3g}; {np.max(a):.3g}]"

        return [
            ("cnn_acc", f"{self.cnn_acc:.4f}"),
            ("snn_acc", f"{self.snn_acc:.4f}"),
            ("conversion_gap_pp", f"{(self.cnn_acc - self.snn_acc) * 100:.2f}"),
            ("agreement", f"{self.agreement:.4f}"),
            ("snn_energy_J", rng(self.snn_energy_j)),
            ("cnn_energy_J", f"{self.cnn_energy_j:.3g}"),
            ("snn_latency_s", rng(self.snn_latency_s)),
            ("cnn_latency_s", f"{self.cnn_latency_s:.3g}"),
            ("snn_FPS_per_W", rng(self.snn_fps_per_w)),
            ("cnn_FPS_per_W", f"{self.cnn_fps_per_w:.4g}"),
            ("overflow_events", str(self.overflow)),
        ]

    def to_json(self) -> dict:
        """Machine-readable summary (used by benchmark --json snapshots)."""
        out = {
            "dataset": self.dataset,
            "cnn_acc": float(self.cnn_acc),
            "snn_acc": float(self.snn_acc),
            "agreement": float(self.agreement),
            "cnn_energy_j": float(self.cnn_energy_j),
            "cnn_latency_s": float(self.cnn_latency_s),
            "cnn_fps_per_w": float(self.cnn_fps_per_w),
            "overflow": int(self.overflow),
            "n_samples": int(np.size(self.snn_energy_j)),
            "snn_energy_j_deciles": _deciles(self.snn_energy_j),
            "snn_latency_s_deciles": _deciles(self.snn_latency_s),
            "snn_fps_per_w_deciles": _deciles(self.snn_fps_per_w),
            "per_class_spikes": {str(k): float(v)
                                 for k, v in self.per_class_spikes.items()},
        }
        out["snn_events_median"] = float(np.median(self.events_per_sample))
        if self.spec is not None:
            out["pricing"] = {
                "compressed": self.spec.compressed,
                "vmem_resident": self.spec.vmem_resident,
                "weight_bits": self.spec.weight_bits,
            }
            out["training"] = getattr(self.spec, "training", "convert")
        return out

    def label(self) -> str:
        if self.spec is None:
            return self.dataset
        return f"{self.dataset}/{self.spec.pricing_label()}"


def sweep_rows(reports, fields=("compressed", "vmem_resident", "weight_bits")):
    """Group a pricing sweep into (variant-label, median metrics) rows.

    The sweep table the paper's Sec. 5 ablations print: one row per variant,
    keyed by whichever spec fields actually vary across the reports.
    """
    varied = [f for f in fields
              if len({getattr(r.spec, f) for r in reports if r.spec}) > 1]
    rows = []
    for r in reports:
        if r.spec is not None:
            key = ", ".join(f"{f}={getattr(r.spec, f)}" for f in varied) \
                or r.spec.pricing_label()
        else:
            key = r.dataset
        rows.append((key, {
            "median_energy_j": float(np.median(r.snn_energy_j)),
            "median_latency_s": float(np.median(r.snn_latency_s)),
            "median_fps_per_w": float(np.median(r.snn_fps_per_w)),
            "snn_acc": float(r.snn_acc),
        }))
    return rows
