"""Paper model specs (Table 6) — a copy of ``repro.configs.PAPER_SPECS``."""
from __future__ import annotations

PAPER_SPECS = {
    "mnist": dict(spec="32C3-32C3-P3-10C3-10", hw=28, c=1, params=20568),
    "svhn": dict(spec="1C3-32C3-32C3-P3-64C3-64C3-P3-128C3-128C3-10",
                 hw=32, c=3, params=297990),
    "cifar10": dict(spec="32C3-32C3-P3-64C3-64C3-P3-128C3-128C3-128C3-10",
                    hw=32, c=3, params=446122),
}
