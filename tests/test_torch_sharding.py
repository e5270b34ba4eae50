"""The port's sharding resolver against the JAX package's.

The cases of ``tests/test_sharding.py`` over a mesh-shape stub (the port's
``Resolver`` reads only ``mesh.shape``), then a grid: for every mesh
(``data``, ``data x model``, ``pod x data x model``), both profiles, a set
of logical-axis tuples and every shape drawn from dimension sizes that
divide some axes and not others, ``Resolver.spec_for`` and
``batch_partition_spec`` give the reference's ``PartitionSpec`` entry for
entry. The reference's meshes repeat the one CPU device, as its own tests'
meshes do.
"""
import itertools
from types import SimpleNamespace
from typing import NamedTuple

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.sharding import resolver as jres
from repro_torch.sharding.resolver import (PartitionSpec as P, Resolver,
                                           batch_partition_spec,
                                           is_axes_leaf, map_with_axes)

MESHES = {  # name -> axis sizes
    "data": {"data": 4},
    "data_model": {"data": 4, "model": 2},
    "pod_data_model": {"pod": 2, "data": 2, "model": 2},
}
LOGICAL = [
    ("embed", "mlp"), ("experts", "embed", "mlp"),
    ("batch", "kvseq", "kv_cache", None), ("embed", "heads"),
    ("batch", None), ("vocab", "embed"), ("kv", "embed"),
    ("layers", "embed", "mlp"), ("act_embed", "batch"),
    ("batch", "embed", "heads"), ("heads", "kv"), ("mlp", "experts"),
    ("unknown", "embed"), (None,),
]
DIMS = (1, 2, 3, 4, 6, 8, 61, 64)


def _stub(name):
    return SimpleNamespace(shape=dict(MESHES[name]))


def _jax_mesh(name):
    sizes = MESHES[name]
    n = int(np.prod(list(sizes.values())))
    devs = np.array(jax.devices() * n)[:n].reshape(tuple(sizes.values()))
    return Mesh(devs, tuple(sizes))


@pytest.fixture(scope="module")
def mesh():
    return _stub("data_model")


def test_fsdp_plus_tp(mesh):
    r = Resolver(mesh)
    # (embed, mlp) weight: embed -> data (fsdp), mlp -> model (tp)
    assert r.spec_for((64, 128), ("embed", "mlp")) == P("data", "model")


def test_experts_divisibility_fallback(mesh):
    r = Resolver(mesh)
    # 61 experts don't divide the 2-way model axis -> expert width shards
    assert r.spec_for((61, 64, 128), ("experts", "embed", "mlp")) == \
        P(None, "data", "model")
    # 64 experts divide -> expert-parallel, width unsharded
    assert r.spec_for((64, 64, 128), ("experts", "embed", "mlp")) == \
        P("model", "data", None)


def test_kv_cache_seq_fallback(mesh):
    r = Resolver(mesh)
    assert r.spec_for((8, 1024, 16, 128),
                      ("batch", "kvseq", "kv_cache", None)) == \
        P("data", None, "model", None)
    # kv=1 (MQA) cannot shard -> the sequence shards instead
    assert r.spec_for((8, 1024, 1, 128),
                      ("batch", "kvseq", "kv_cache", None)) == \
        P("data", "model", None, None)


def test_row_parallel_second_pass(mesh):
    r = Resolver(mesh)
    # output dim 63 never divides -> the second pass extends embed's data
    # axis with model (row-parallel)
    assert r.spec_for((64, 63), ("embed", "heads")) == P(("data", "model"),
                                                        None)


def test_batch_axis_multi_pod():
    r = Resolver(_stub("pod_data_model"))
    assert r.spec_for((8, 128), ("batch", None)) == P(("pod", "data"), None)


def test_indivisible_stays_replicated(mesh):
    assert Resolver(mesh).spec_for((7, 13), ("embed", "mlp")) == P(None, None)


def test_spec_for_refuses_mismatched_ranks(mesh):
    with pytest.raises(ValueError, match="differ in length"):
        Resolver(mesh).spec_for((4, 4), ("embed",))


class _Cache(NamedTuple):
    k: np.ndarray
    v: np.ndarray
    pos: np.ndarray


def test_map_with_axes_namedtuple():
    cache = _Cache(k=np.zeros((2, 4, 2, 8)), v=np.zeros((2, 4, 2, 8)),
                   pos=np.zeros((2,), np.int32))
    axes = _Cache(k=("batch", "kvseq", "kv_cache", None),
                  v=("batch", "kvseq", "kv_cache", None), pos=("batch",))
    out = map_with_axes(lambda leaf, ax: len(ax), cache, axes)
    assert out.k == 4 and out.pos == 1
    nested = map_with_axes(lambda leaf, ax: ax, {"a": [1, 2]},
                           {"a": [("embed",), ("mlp",)]})
    assert nested == {"a": [("embed",), ("mlp",)]}
    assert jres.map_with_axes(lambda leaf, ax: len(ax), cache, axes) == out


def test_is_axes_leaf():
    for x in (("embed", "mlp"), (), (None, "mlp"), ({"a": 1},), ["embed"]):
        assert is_axes_leaf(x) == jres.is_axes_leaf(x)
    assert is_axes_leaf(("embed", "mlp")) and not is_axes_leaf(({"a": 1},))


def test_rule_tables_equal_the_reference():
    from repro_torch.sharding import resolver as tres

    assert tres.RULES == jres.RULES
    assert tres.SECOND_PASS == jres.SECOND_PASS
    assert tres.PRIORITY == jres.PRIORITY


@pytest.mark.parametrize("profile", ["auto", "dp_only"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_spec_for_equals_the_reference_over_a_grid(mesh_name, profile):
    ours = Resolver(_stub(mesh_name), profile=profile)
    theirs = jres.Resolver(_jax_mesh(mesh_name), profile=profile)
    n = 0
    for logical in LOGICAL:
        for shape in itertools.product(DIMS, repeat=len(logical)):
            assert _outcome(ours, shape, logical) == \
                _outcome(theirs, shape, logical), (shape, logical)
            n += 1
    assert n > 4000


def _outcome(resolver, shape, logical):
    """The spec's entries, or the error's type: the second pass asks a
    mesh without a ``model`` axis for its size and raises ``KeyError`` in
    both packages (an ``embed`` dim already on ``data``)."""
    try:
        return tuple(resolver.spec_for(shape, logical))
    except KeyError as e:
        return KeyError, e.args


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_partition_spec_equals_the_reference(mesh_name):
    jmesh = _jax_mesh(mesh_name)
    for B in range(1, 33):
        for shape in ((B,), (B, 10, 10, 1), (B, 28, 28, 3)):
            got = batch_partition_spec(_stub(mesh_name), shape)
            want = jres.batch_partition_spec(jmesh, shape)
            assert tuple(got) == tuple(want), shape
            assert isinstance(got, P) and len(got) == len(shape)
