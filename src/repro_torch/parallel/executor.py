"""Data-parallel SNN execution: ``engine.infer_batch`` over a device mesh
(port of ``repro.parallel.executor``).

The reference's ``shard_map`` splits the batch inside one compiled call;
here one process runs each shard on its own device: params and thresholds
are replicated to each shard's device, that shard's slice of the batch goes
through ``engine.batch_runner`` there, and the outputs come back to the
mesh's first device, concatenated in batch order. The engine's mask
contract makes batch rows independent in every backend, so the sharded
result is **bit-exact** against the single-device call, logits and every
stat, overflow in the drop regime included.

A batch that does not divide the mesh is zero-padded to the next multiple
and the valid prefix sliced back out (``engine.slice_valid``), as the
serving buckets are; whether it needs that is the resolver's divisibility
rule (:func:`repro_torch.sharding.resolver.batch_partition_spec`).

:func:`use_mesh` installs the sharded path as the engine's batch dispatch,
so everything built on ``engine.infer_batch`` (the study's ``collect``, the
sweep runner) runs sharded without change. ``repro_torch.serve`` wires the
mesh through its plans (``serve.registry.ModelHandle``).

Caches: the sharded runners per (config, backend, mesh) and the params'
copies per (mesh, device) (:func:`replicate`, which the serving plans use
too) are both emptied by the neuron registry's hooks
(``neuron._on_registry_change``), as the engine's own caches are.
"""
from __future__ import annotations

import contextlib

import torch

from .. import obs
from ..core import engine
from ..core.neuron import _on_registry_change
from ..device import resolve_device
from ..sharding.resolver import batch_partition_spec
from .mesh import data_mesh, mesh_size

# (config, backend, mesh) -> sharded runner; a mesh is hashable by its
# devices and data_mesh() returns cached instances, so keys stay stable
_RUNNERS: dict = {}
# (mesh, device) -> (source tensors with their version counters, params,
# thresholds): the copies of the last params seen on a shard's device, so
# a replica on another device is not copied again on every call
_REPLICAS: dict = {}

# a re-registered neuron mode must drop sharded runners too, or a cached
# one would keep the old plan
_on_registry_change.append(_RUNNERS.clear)
_on_registry_change.append(_REPLICAS.clear)


def on_device(device: torch.device):
    """Make ``device`` current while a shard launches there (the kernel
    wrappers launch on the current device's stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def replicate(params, thresholds, device, mesh):
    """Params (a list of {'w', 'b'} tensors) and thresholds on ``device``.

    Tensors already there are used as they are; a copy for another device
    is kept per (mesh, device) for as long as the source tensors are the
    same objects at the same version (an in-place update makes a new copy).
    """
    leaves = [t for layer in params for t in layer.values()] + list(thresholds)
    hit = _REPLICAS.get((mesh, device))
    if hit is not None and len(hit[0]) == len(leaves) and all(
            a is t and v == t._version for (a, v), t in zip(hit[0], leaves)):
        return hit[1], hit[2]
    p, th = engine.to_device(params, thresholds, device)
    _REPLICAS[(mesh, device)] = ([(t, t._version) for t in leaves], p, th)
    return p, th


def gather(outs, device):
    """Per-shard ``(logits, SNNStats)`` -> one batch on ``device``, in
    shard order."""
    with torch.inference_mode():
        logits = torch.cat([o[0].to(device) for o in outs])
        stats = engine.SNNStats(*(
            torch.cat([a.to(device) for a in field])
            for field in zip(*(o[1] for o in outs))))
    return logits, stats


def batch_runner_sharded(cfg, backend_name: str, mesh):
    """The data-parallel runner for (config, backend, mesh), cached.

    ``run(params, thresholds, images) -> (logits, SNNStats)`` over params,
    thresholds and a (B, H, W, C) batch on the mesh's first device, B
    divisible by the mesh size (:func:`infer_batch_sharded` pads to that):
    shard ``i`` gets rows ``[i*B/n, (i+1)*B/n)`` on ``mesh.devices[i]``.
    The sharded analogue of ``engine.batch_runner``.
    """
    key = (cfg, backend_name, mesh)
    cached = _RUNNERS.get(key)
    if cached is not None:
        return cached
    if getattr(engine.get_backend(backend_name), "host_dispatch", False):
        raise ValueError(
            f"backend {backend_name!r} dispatches on host-side occupancy "
            "totals between layers and is not split into shards; "
            "infer_batch_sharded runs it on the local runner")
    run = engine.batch_runner(cfg, backend_name)
    # resolve_device turns TF32 off on every CUDA device of the mesh
    devices = tuple(resolve_device(d) for d in mesh.devices)
    n = len(devices)

    def sharded(params, thresholds, images):
        B = images.shape[0]
        if B % n:
            raise ValueError(f"batch of {B} does not divide the {n}-way mesh")
        k = B // n
        outs = []
        for i, d in enumerate(devices):
            p, th = replicate(params, thresholds, d, mesh)
            with on_device(d):
                outs.append(run(p, th, images[i * k:(i + 1) * k].to(d)))
        return gather(outs, devices[0])

    _RUNNERS[key] = sharded
    return sharded


def infer_batch_sharded(params, thresholds, cfg, images, *,
                        backend: str = "dense", mesh=None):
    """Run a (B, H, W, C) batch sharded over ``mesh``; bit-exact against
    one device. Returns ``(logits, SNNStats)`` on the mesh's first device.

    ``mesh=None`` takes :func:`data_mesh` over every visible card; a
    one-device mesh, and a ``host_dispatch`` backend (``queue_sparse``),
    run the engine's own batched call on the mesh's first device. When B
    does not divide the mesh size, the batch is zero-padded to the next
    multiple and the valid prefix sliced back out: padded rows are inert
    under the mask contract, so padding costs compute, never exactness.
    """
    mesh = data_mesh() if mesh is None else mesh
    first = resolve_device(mesh.devices[0])
    params, thresholds = engine.to_device(params, thresholds, first)
    images = engine.images_on(images, first)
    n = mesh_size(mesh)
    if n <= 1 or getattr(engine.get_backend(backend), "host_dispatch", False):
        # queue_sparse sizes each layer from host-side totals; its local
        # run is bit-exact (the same mask contract), so inside use_mesh it
        # runs unsharded
        return engine.batch_runner(cfg, backend)(params, thresholds, images)

    B = images.shape[0]
    runner = batch_runner_sharded(cfg, backend, mesh)
    if batch_partition_spec(mesh, tuple(images.shape))[0] is None:
        pad = (-B) % n
        with obs.span("parallel.shard_execute", backend=backend, B=B,
                      devices=n, shard_B=(B + pad) // n, padded=pad):
            padded = torch.cat(
                [images, images.new_zeros((pad,) + tuple(images.shape[1:]))])
            logits, stats = runner(params, thresholds, padded)
            return engine.slice_valid(logits, stats, B)
    with obs.span("parallel.shard_execute", backend=backend, B=B,
                  devices=n, shard_B=B // n, padded=0):
        return runner(params, thresholds, images)


@contextlib.contextmanager
def use_mesh(mesh):
    """Route every ``engine.infer_batch`` in the block through ``mesh``.

    Installs :func:`infer_batch_sharded` as the engine's batch dispatch and
    restores the previous one on exit, exception or not. Sharded results
    are bit-exact, so callers above the engine (``study.collect``, its
    content-keyed cache, the sweep runner) need not know about the mesh.
    ``mesh=None`` is a no-op block.
    """
    if mesh is None:
        yield None
        return

    def dispatch(params, thresholds, cfg, images, *, backend):
        return infer_batch_sharded(params, thresholds, cfg, images,
                                   backend=backend, mesh=mesh)

    prev = engine._batch_dispatch
    engine._batch_dispatch = dispatch
    try:
        yield mesh
    finally:
        engine._batch_dispatch = prev
