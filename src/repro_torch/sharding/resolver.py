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
attribute (``parallel.DataMesh``, a stub in the tests) is a mesh here. The
data-parallel executor uses :func:`batch_partition_spec`; placing model
parameters by these specs belongs with the model code, which the port does
not have yet.
"""
from __future__ import annotations

from typing import Any

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
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


class Resolver:
    """profile:

    - ``'auto'``: the FSDP + TP rules above (default);
    - ``'dp_only'``: pure data parallelism, params replicated, the batch
      sharded over every mesh axis.
    """

    def __init__(self, mesh, profile: str = "auto"):
        self.mesh = mesh
        self.profile = profile

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
