"""Logical-axis -> mesh-axis sharding resolver with divisibility fallbacks
(port of ``repro.sharding.resolver``).

Every parameter or cache leaf carries a tuple of logical axis names; the
resolver maps them onto the axes of a mesh:

    batch     -> ('pod', 'data')          (data parallel, pods included)
    embed     -> 'data'   (ZeRO/FSDP)     fallback: 'model' (row-parallel)
    heads/kv/mlp/vocab -> 'model'         (tensor parallel)
    experts   -> 'model'  (expert parallel; falls back to sharding the
                           expert FFN width when E doesn't divide)
    kv_cache  -> 'model'  (decode KV-heads) fallback: the cache *sequence*
    kvseq     -> 'model'  (only if kv_cache could not shard)
    layers    -> never sharded (scan dimension)

An axis candidate is taken only if its size divides the dimension and no
other dimension of the same tensor already claimed it.

The port keeps its own :class:`PartitionSpec`, a tuple of entries (``None``,
an axis name, or a tuple of names), and :class:`Resolver` reads only
``mesh.shape``, an ``{axis: size}`` mapping, so any object with that
attribute (:class:`Mesh`, ``parallel.DataMesh``, a stub in the tests) is a
mesh here. The data-parallel executor uses :func:`batch_partition_spec`.

Placement: :class:`Mesh` is a named N-axis mesh of ``torch.device``s (a
device may repeat: a *virtual* mesh), :class:`NamedSharding` a spec on a
mesh, which ``place`` turns into one slice per mesh position, each on its
position's device. ``Resolver.sharding_for`` / ``tree_shardings`` give the
shardings of model parameters, caches and train state.

Activation constraints: the model calls the module-level :func:`constrain`
where the reference does. The port runs the whole model on one device in
one process and partitions nothing, so a constraint leaves its tensor as
it is; with a resolver active (:func:`use_resolver`) it resolves the spec
and records it (``Resolver.constraints``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any

import numpy as np
import torch

from .. import obs

# candidate lists per logical name; each candidate is a tuple of mesh axes
RULES: dict[str, list[tuple[str, ...]]] = {
    "batch": [("pod", "data"), ("data",)],
    "embed": [("data",)],
    "heads": [("model",)],
    "kv": [("model",)],
    "mlp": [("model",)],
    "experts": [("model",)],
    "vocab": [("model",)],
    "kv_cache": [("model",)],
    "kvseq": [("model",)],
    "act_embed": [],          # activations stay batch-sharded (Megatron style)
    "layers": [],
    None: [],
}
# second-pass candidates, tried only while 'model' is still unused
SECOND_PASS: dict[str, list[tuple[str, ...]]] = {
    "embed": [("model",)],    # row-parallel fallback when TP axis went unused
}
# resolution priority: dims earlier in this list claim mesh axes first
PRIORITY = ["batch", "kv_cache", "heads", "kv", "experts", "mlp", "vocab",
            "kvseq", "embed"]


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axes_size(mesh, axes: tuple[str, ...]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


class Mesh:
    """A named N-axis mesh: ``devices``, a numpy object array of
    ``torch.device``s, one axis per name in ``axis_names``. ``shape`` is
    the ordered ``{axis: size}`` mapping and ``devices.size`` the count,
    as on ``jax.sharding.Mesh``. A device may appear more than once (a
    *virtual* mesh: every position on one card, or on ``meta``)."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-d device array and axes "
                             f"{axis_names} differ in rank")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(arr.shape, dtype=object)
        for pos in np.ndindex(arr.shape):
            self.devices[pos] = torch.device(arr[pos])
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {sorted({str(d) for d in self.devices.flat})})"


class NamedSharding:
    """``spec`` on ``mesh``: dimension ``i`` of a tensor is split over the
    mesh axes of ``spec[i]`` (in order, the first outermost) and kept
    whole over every other axis, whose positions get copies."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def _axes(self, i):
        e = self.spec[i] if i < len(self.spec) else None
        return () if e is None else (e,) if isinstance(e, str) else tuple(e)

    def shard_shape(self, global_shape) -> tuple:
        out = []
        for i, n in enumerate(global_shape):
            parts = _axes_size(self.mesh, self._axes(i))
            if n % parts:
                raise ValueError(f"dimension {i} of {tuple(global_shape)} "
                                 f"does not divide over {self._axes(i)} "
                                 f"({parts} parts)")
            out.append(n // parts)
        return tuple(out)

    def index(self, pos, global_shape) -> tuple:
        """The slices of the global tensor that mesh position ``pos``
        holds."""
        coord = dict(zip(self.mesh.axis_names, pos))
        local = self.shard_shape(global_shape)
        out = []
        for i, n in enumerate(local):
            k = 0
            for a in self._axes(i):
                k = k * self.mesh.shape[a] + coord[a]
            out.append(slice(k * n, (k + 1) * n))
        return tuple(out)

    def place(self, x):
        """``x`` (a tensor or array) laid out on the mesh: each position's
        slice on its own device, as a :class:`ShardedTensor`; on a mesh
        of one device, the plain tensor on that device."""
        x = torch.as_tensor(x)
        devices = self.mesh.devices
        if devices.size == 1:
            return x.to(devices.flat[0])
        self.shard_shape(x.shape)
        shards = np.empty(devices.shape, dtype=object)
        for pos in np.ndindex(devices.shape):
            shards[pos] = x[self.index(pos, x.shape)].to(devices[pos],
                                                         copy=True)
        return ShardedTensor(shards, self, tuple(x.shape), x.dtype)


class ShardedTensor:
    """A tensor laid out by a :class:`NamedSharding`: ``shards`` holds one
    tensor per mesh position (replicated axes hold copies)."""

    def __init__(self, shards, sharding: NamedSharding, shape, dtype):
        self.shards, self.sharding = shards, sharding
        self.shape, self.dtype = tuple(shape), dtype

    def full(self, device=None) -> torch.Tensor:
        """The global tensor, assembled on ``device`` (default: the first
        position's)."""
        first = self.shards.flat[0]
        out = torch.empty(self.shape, dtype=self.dtype,
                          device=first.device if device is None else device)
        for pos in np.ndindex(self.shards.shape):
            out[self.sharding.index(pos, self.shape)] = self.shards[pos]
        return out

    def __array__(self, dtype=None, copy=None):
        # audit: allow[host-sync] numpy conversion is a host copy by request
        a = self.full().cpu().numpy()
        return a if dtype is None else a.astype(dtype)


class Resolver:
    """profile:

    - ``'auto'``: the FSDP + TP rules above (default);
    - ``'dp_only'``: pure data parallelism, params replicated, the batch
      sharded over every mesh axis.

    ``constraints`` lists every :meth:`constrain` call made while this
    resolver was active, as ``(shape, logical, spec)``.
    """

    def __init__(self, mesh, profile: str = "auto"):
        self.mesh = mesh
        self.profile = profile
        self.constraints: list[tuple] = []

    def _rules(self, name):
        if self.profile == "dp_only":
            if name == "batch":
                return [tuple(a for a in ("pod", "data", "model")
                              if a in self.mesh.shape)]
            return []
        return RULES.get(name, [])

    def spec_for(self, shape, logical) -> PartitionSpec:
        """shape: tuple of ints; logical: tuple of names (len == ndim)."""
        if len(shape) != len(logical):
            raise ValueError(
                f"shape {tuple(shape)} and logical axes {tuple(logical)} "
                "differ in length")
        assign: list[Any] = [None] * len(shape)
        used: set[str] = set()
        order = sorted(
            range(len(shape)),
            key=lambda i: PRIORITY.index(logical[i])
            if logical[i] in PRIORITY else len(PRIORITY))

        def try_assign(i, candidates):
            for cand in candidates:
                if any(a not in self.mesh.shape for a in cand):
                    continue
                if any(a in used for a in cand):
                    continue
                if shape[i] % _axes_size(self.mesh, cand) != 0:
                    continue
                assign[i] = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                return True
            return False

        for i in order:
            try_assign(i, self._rules(logical[i]))
        if self.profile != "auto":
            return PartitionSpec(*assign)
        if "model" not in used:
            # second pass: hand the unused TP axis to a dim that accepts it,
            # either an unassigned dim or by extending an FSDP-sharded dim
            # to ('data', 'model') (the row-parallel fallback)
            for i in order:
                if logical[i] not in SECOND_PASS:
                    continue
                if assign[i] is None:
                    if try_assign(i, SECOND_PASS[logical[i]]):
                        break
                else:
                    cur = (assign[i] if isinstance(assign[i], tuple)
                           else (assign[i],))
                    ext = cur + ("model",)
                    if shape[i] % _axes_size(self.mesh, ext) == 0:
                        assign[i] = ext
                        used.add("model")
                        break
        return PartitionSpec(*assign)

    def sharding_for(self, shape, logical) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(shape, logical))

    def constrain(self, x, logical):
        """The reference's ``with_sharding_constraint``, a hint to XLA's
        partitioner that leaves values unchanged. The port partitions
        nothing (one device, one process) and fakes no partitioner: ``x``
        comes back as it is, the same tensor, neither moved nor copied.
        The spec is resolved all the same (so a mesh the rules cannot
        serve raises here as in the reference), recorded in
        ``constraints`` and counted as ``sharding.constrain``."""
        spec = self.spec_for(tuple(x.shape), logical)
        self.constraints.append((tuple(x.shape), tuple(logical), spec))
        obs.counter("sharding.constrain")
        return x

    def tree_shardings(self, tree, axes_tree):
        """Parallel walk of (tree, axes) -> a tree of NamedShardings."""
        return map_with_axes(
            lambda leaf, ax: self.sharding_for(tuple(leaf.shape), ax),
            tree, axes_tree)


def batch_partition_spec(mesh, shape) -> PartitionSpec:
    """Data-parallel spec for a batch-leading array, divisibility-checked.

    Dimension 0 is logical ``batch``, every other dimension unsharded,
    resolved under the ``dp_only`` profile (the batch takes every mesh axis
    present). When the batch does not divide the mesh, the spec comes back
    unsharded (``spec[0] is None``) and the caller decides how to cope
    (``parallel.infer_batch_sharded`` pads to divisible and slices the valid
    prefix back out).
    """
    logical = ("batch",) + (None,) * (len(shape) - 1)
    return Resolver(mesh, profile="dp_only").spec_for(tuple(shape), logical)


def is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def map_with_axes(f, tree, axes):
    """Map ``f(leaf, axes_leaf)`` over parallel (values, logical-axes)
    trees; an axes leaf is a tuple of names, so the walk is by hand."""
    if is_axes_leaf(axes):
        return f(tree, axes)
    if isinstance(tree, dict):
        return {k: map_with_axes(f, tree[k], axes[k]) for k in tree}
    if hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*[
            map_with_axes(f, a, b) for a, b in zip(tree, axes)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_axes(f, a, b) for a, b in zip(tree, axes))
    return f(tree, axes)


# ---------------------------------------------------------------------------
# The active resolver (read by the model's activation constraints)
# ---------------------------------------------------------------------------

_ACTIVE: Resolver | None = None


@contextlib.contextmanager
def use_resolver(r: Resolver | None):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = r
    try:
        yield r
    finally:
        _ACTIVE = prev


def active() -> Resolver | None:
    return _ACTIVE


def constrain(x, logical):
    """``Resolver.constrain`` of the active resolver; the identity (no
    allocation, no sync) when none is active or ranks differ."""
    if _ACTIVE is None:
        return x
    if x.ndim != len(logical):
        return x
    return _ACTIVE.constrain(x, logical)
