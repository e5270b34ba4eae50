"""Registry persistence: checkpointed models + the bucket ladder of their
plans (port of ``repro.serve.persist``; the same ``registry-ckpt-v1``
layout and manifest, so each package restores a registry the other saved).

A restarted replica's cold start is (import) + (kernel libraries) +
(params) + (one plan per bucket). This module removes what can be kept:

- **params/thresholds** round-trip through the port's
  ``checkpoint.checkpoint`` (the reference's on-disk format: atomic commit
  markers, per-leaf content hashes, loud verification on load).
- **kernel libraries** come from the compile cache
  (``core.compile_cache``): a replica that shares its directory builds
  nothing.
- **plans**: a CUDA graph is bound to the memory of the process that
  captured it and cannot be serialized, so the manifest records each
  saved bucket as ``{"format": "cuda_graph", "bucket": B}`` (``"eager"``
  on the CPU) with no blob, and :func:`load_registry` re-captures each one
  through ``handle.adopt_plan``: ``cached_buckets()`` equals the saved
  ladder, ``compile_count`` stays 0, and a following ``warmup`` is
  execute-only. A plan entry of another format (the reference's
  ``jax_export`` blobs) is counted on ``persist.plan_restore_skipped`` and
  that bucket is built lazily on first use — never an error.
- **keys**: every model entry carries ``study.cache.content_key`` over its
  actual params, thresholds, config and backend (the reference's key for
  the same content); :func:`load_registry` recomputes it and raises
  :class:`StaleCheckpointError` on a mismatch.

Checkpoint layout::

    <root>/registry.json                    # manifest (schema, keys, cfg)
    <root>/models/<dir>/step_000000000/     # checkpoint params

Errors are loud and typed: :class:`CheckpointError` (missing/unusable),
:class:`StaleCheckpointError` (content-key mismatch),
:class:`CorruptCheckpointError` (damaged shard or manifest). Tracing: the
``persist.save`` span, ``coldstart.restore_params`` and
``coldstart.restore_plans`` spans, and the ``persist.plan_export`` /
``persist.plan_restore`` / ``persist.plan_restore_skipped`` counters.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import torch

from .. import obs
from ..checkpoint import checkpoint as ckpt
from ..core.engine import SNNConfig
from ..study.cache import content_key
from .api import ServeError
from .registry import ModelRegistry

SCHEMA = "registry-ckpt-v1"
MANIFEST = "registry.json"
# the plan formats this package restores (one per device kind)
PLAN_FORMATS = {"cuda": "cuda_graph", "cpu": "eager"}


class CheckpointError(ServeError):
    """Registry checkpoint missing or structurally unusable."""


class StaleCheckpointError(CheckpointError):
    """Restored content no longer matches the manifest's content key.

    Raised when the recomputed ``content_key`` over (params, thresholds,
    config, backend) differs from the key recorded at save time — an edited
    manifest, swapped shard, or spec drift. Never served silently.
    """


class CorruptCheckpointError(CheckpointError):
    """A shard or the manifest failed integrity verification."""


def registry_key(params, thresholds, cfg, backend: str) -> str:
    """Content key of one servable model, study-cache-consistent (the
    reference's key for the same arrays, config values and backend)."""
    return content_key("serve-registry-v1", list(params), list(thresholds),
                       tuple(cfg), backend)


def _safe_dir(name: str, taken: set) -> str:
    base = re.sub(r"[^-._a-zA-Z0-9]", "_", name) or "model"
    out, i = base, 1
    while out in taken:
        out, i = f"{base}.{i}", i + 1
    taken.add(out)
    return out


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------

def save_registry(registry: ModelRegistry, root: str, *,
                  buckets=None, plans: bool = True) -> str:
    """Checkpoint every registered model (params + plan ladder) under
    ``root``.

    ``buckets`` selects which plan buckets to record (default: each
    handle's already-built ``cached_buckets()``); ``plans=False`` saves
    params only. Returns ``root``.
    """
    os.makedirs(root, exist_ok=True)
    taken: set = set()
    models = {}
    with obs.span("persist.save", root=root, models=len(registry)):
        for name in registry.names():
            handle = registry.get(name)
            d = _safe_dir(name, taken)
            tree = {"params": [dict(layer) for layer in handle.params],
                    "thresholds": list(handle.thresholds)}
            ckpt.save(os.path.join(root, "models", d), 0, tree)

            plan_entries = {}
            if plans:
                fmt = PLAN_FORMATS[handle.device.type]
                want = (buckets if buckets is not None
                        else handle.cached_buckets())
                for b in want:
                    plan_entries[str(int(b))] = {"format": fmt,
                                                 "bucket": int(b)}
                    obs.counter("persist.plan_export")

            models[name] = {
                "dir": d,
                "key": registry_key(handle.params, handle.thresholds,
                                    handle.cfg, handle.backend),
                "backend": handle.backend,
                "vmem_resident": handle.vmem_resident,
                "source_key": handle.source_key,
                "cfg": handle.cfg._asdict(),
                "params_tree": [sorted(layer) for layer in handle.params],
                "n_thresholds": len(handle.thresholds),
                "plans": plan_entries,
            }

        manifest = {"schema": SCHEMA, "torch_version": torch.__version__,
                    "models": models}
        fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(root, MANIFEST))
    return root


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------

def read_manifest(root: str) -> dict:
    path = os.path.join(root, MANIFEST)
    if not os.path.exists(path):
        raise CheckpointError(
            f"no registry checkpoint under {root!r} (missing {MANIFEST})")
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CorruptCheckpointError(
            f"unreadable registry manifest {path!r}: {e}") from e
    if manifest.get("schema") != SCHEMA:
        raise CheckpointError(
            f"unsupported registry checkpoint schema "
            f"{manifest.get('schema')!r} (expected {SCHEMA!r})")
    return manifest


def _restore_plan(handle, bucket: int, entry: dict) -> bool:
    """Build and adopt one bucket's plan; False = left to the lazy path.

    Either of this package's formats restores on either device: the entry
    names a bucket of the saved ladder, and the plan is built here for the
    handle's device (a graph capture on the card, the eager call on the
    CPU).
    """
    if entry.get("format") not in PLAN_FORMATS.values():
        obs.counter("persist.plan_restore_skipped")
        return False
    handle.adopt_plan(bucket, handle.build_plan(bucket))
    obs.counter("persist.plan_restore")
    return True


def load_registry(root: str, *, names=None, plans: bool = True,
                  capacity: int | None = None,
                  plan_cache_size: int | None = None,
                  device=None) -> ModelRegistry:
    """Rebuild a :class:`ModelRegistry` from a :func:`save_registry` dir
    (this package's or the reference's) on ``device`` (``None``: the card).

    Every model's content key is recomputed from the restored bytes and
    checked against the manifest (:class:`StaleCheckpointError` on
    mismatch); damaged shards raise :class:`CorruptCheckpointError`. With
    ``plans=True`` each saved bucket's plan is rebuilt and adopted, so a
    following ``handle.warmup(buckets)`` is execute-only —
    ``compile_count`` stays 0; the kernels come from the compile cache.
    """
    manifest = read_manifest(root)
    entries = manifest["models"]
    if names is not None:
        missing = sorted(set(names) - set(entries))
        if missing:
            raise CheckpointError(
                f"models {missing} not in checkpoint {root!r} "
                f"(has {sorted(entries)})")
        entries = {n: entries[n] for n in names}

    registry = ModelRegistry(
        capacity=capacity if capacity is not None else max(4, len(entries)),
        plan_cache_size=plan_cache_size or 8, device=device)

    for name, entry in entries.items():
        with obs.span("coldstart.restore_params", model=name):
            template = {
                "params": [{k: 0 for k in layer}
                           for layer in entry["params_tree"]],
                "thresholds": [0] * entry["n_thresholds"],
            }
            try:
                tree, _ = ckpt.restore(
                    os.path.join(root, "models", entry["dir"]), template)
            except OSError as e:
                raise CorruptCheckpointError(
                    f"model {name!r}: no intact params checkpoint under "
                    f"{root!r} ({e})") from e

        cfg = SNNConfig(**entry["cfg"])
        got = registry_key(tree["params"], tree["thresholds"], cfg,
                           entry["backend"])
        if got != entry["key"]:
            raise StaleCheckpointError(
                f"model {name!r}: restored content hashes to {got} but the "
                f"manifest pins {entry['key']} — the checkpoint no longer "
                "matches what was saved (edited manifest, swapped shard, "
                "or config drift); refusing to serve it")

        handle = registry.register(
            name, tree["params"], tree["thresholds"], cfg,
            backend=entry["backend"], vmem_resident=entry["vmem_resident"])
        handle.source_key = entry.get("source_key")

        if plans:
            with obs.span("coldstart.restore_plans", model=name,
                          n=len(entry["plans"])):
                for b, pentry in sorted(entry["plans"].items(),
                                        key=lambda kv: int(kv[0])):
                    _restore_plan(handle, int(b), pentry)
    return registry
