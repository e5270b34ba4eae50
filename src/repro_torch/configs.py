"""Paper model specs (Table 6) and the LM benchmark shapes — a copy of
``repro.configs``.

The reference once carried a 10-architecture LM config zoo here; it was
deleted as dead code, and ``get`` / ``get_smoke`` only fail loudly with
that pointer. LM configurations are passed as an ``ArchConfig`` directly.
"""
from __future__ import annotations

PAPER_SPECS = {
    "mnist": dict(spec="32C3-32C3-P3-10C3-10", hw=28, c=1, params=20568),
    "svhn": dict(spec="1C3-32C3-32C3-P3-64C3-64C3-P3-128C3-128C3-10",
                 hw=32, c=3, params=297990),
    "cifar10": dict(spec="32C3-32C3-P3-64C3-64C3-P3-128C3-128C3-128C3-10",
                    hw=32, c=3, params=446122),
}

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

_ZOO_REMOVED = (
    "the LM architecture zoo was removed (dead code on the SNN path, "
    "flagged by `python -m repro.audit`); pass an ArchConfig directly — "
    "reduced smoke configs live in tests/_smoke_archs.py"
)


def get(name: str):
    raise LookupError(f"configs.get({name!r}): {_ZOO_REMOVED}")


def get_smoke(name: str):
    raise LookupError(f"configs.get_smoke({name!r}): {_ZOO_REMOVED}")


def shape_applicable(cfg, shape_name: str) -> tuple[bool, str]:
    """Whether a (arch, shape) cell runs; returns (ok, reason-if-skipped)."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k dense-KV decode "
                       "skipped per assignment (DESIGN.md long-context policy)")
    return True, ""
