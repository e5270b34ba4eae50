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
import torch
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


# ---------------------------------------------------------------------------
# Placement: tree_shardings over the model's trees, constrain, NamedSharding
# ---------------------------------------------------------------------------

def _paths(tree, leaf):
    """{checkpoint path: leaf(x)} of a tree."""
    from repro_torch.checkpoint.checkpoint import _flatten

    return {path: leaf(x) for path, x in _flatten(tree).items()}


def _ref_trees(cfg):
    """The reference's parameter, train-state and cache trees (shapes
    only, ``jax.eval_shape``) with their logical axes."""
    from repro.models import model as JM
    from repro.training import train_loop as JTL

    captured = {}

    def init(k):
        p, a = JM.init_model(k, cfg)
        captured["axes"] = a
        return p

    params = jax.eval_shape(init, jax.random.PRNGKey(0))
    axes = captured["axes"]
    state = jax.eval_shape(JTL.init_state, params)
    return {"params": (params, axes),
            "state": (state, JTL.state_axes(axes)),
            "caches": (JM.cache_specs(cfg, 8, 64), JM.cache_axes(cfg))}


def _port_trees(tcfg):
    from repro_torch.models import model as TM
    from repro_torch.training import train_loop as TTL

    params, axes = TM.init_model(None, tcfg, device="meta")
    return {"params": (params, axes),
            "state": (TTL.init_state(params), TTL.state_axes(axes)),
            "caches": (TM.cache_specs(tcfg, 8, 64), TM.cache_axes(tcfg))}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["dense-7b", "dense-20b", "moe-14b",
                                  "recurrent-125m"])
def test_tree_shardings_equal_the_reference(arch, multi_pod):
    """``Resolver.tree_shardings`` over every FULL configuration's params,
    train state and decode caches on the production mesh (the port's
    virtual ``meta`` mesh) gives the reference's ``spec_for`` leaf for
    leaf, over a stub of the same mesh shape."""
    from _smoke_archs import FULL
    from _torch_archs import TORCH_FULL
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.devices.size == (512 if multi_pod else 256)
    ours = Resolver(mesh)
    theirs = jres.Resolver(SimpleNamespace(shape=dict(mesh.shape)))
    ref, port = _ref_trees(FULL[arch]), _port_trees(TORCH_FULL[arch])
    for name in ("params", "state", "caches"):
        rtree, raxes = ref[name]
        want = _paths(jres.map_with_axes(
            lambda leaf, ax: SimpleNamespace(spec=theirs.spec_for(leaf.shape,
                                                                  ax)),
            rtree, raxes), lambda s: tuple(s.spec))
        ptree, paxes = port[name]
        got = _paths(ours.tree_shardings(ptree, paxes),
                     lambda s: tuple(s.spec))
        assert got == want, name
        shapes = _paths(ptree, lambda t: tuple(t.shape))
        assert shapes == _paths(rtree, lambda x: tuple(x.shape)), name


SMOKE_NAMES = ["dense-tied", "dense-untied", "dense-gelu-ln",
               "dense-geglu-hd", "moe", "hybrid", "xlstm", "enc-dec-audio",
               "vlm"]


@pytest.mark.parametrize("arch", SMOKE_NAMES)
def test_constrain_sequence_equals_the_reference(arch, monkeypatch):
    """The forward's constrain calls: the reference's, recorded by a
    test-only patch of its ``Resolver.constrain`` (eager, periods
    unrolled), equal the port's ``Resolver.constraints``, shape, logical
    axes and spec, call for call, on a 4 x 2 stub mesh."""
    import dataclasses

    import _lm_parity as LP
    from _smoke_archs import SMOKES
    from _torch_archs import TORCH_SMOKES
    from repro.models import model as JM
    from repro_torch.models import model as TM
    from repro_torch.sharding.resolver import use_resolver

    cfg = dataclasses.replace(SMOKES[arch], scan_layers=False)
    jp, _ = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = LP.make_batch(cfg)
    seen = []

    def record(self, x, logical):
        seen.append((tuple(x.shape), tuple(logical),
                     tuple(self.spec_for(x.shape, logical))))
        return x

    monkeypatch.setattr(jres.Resolver, "constrain", record)
    stub = _stub("data_model")
    with jres.use_resolver(jres.Resolver(stub)):
        JM.forward(jp, cfg, LP.to_jax(batch), remat=False)
    ours = Resolver(stub)
    with use_resolver(ours):
        TM.forward(tp, TORCH_SMOKES[arch], LP.to_torch(batch), remat=False)
    got = [(s, lg, tuple(sp)) for s, lg, sp in ours.constraints]
    assert got == seen
    n_periods = cfg.n_layers // len(cfg.block_pattern)
    n_blocks = cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)
    assert n_periods >= 1 and len(got) == 2 + 2 * n_blocks


@pytest.mark.parametrize("arch", ["dense-tied", "moe", "enc-dec-audio"])
def test_outputs_under_a_resolver_equal_outputs_without(arch):
    """A constraint changes no value: the port's forward under
    ``use_resolver`` (16 x 16 virtual mesh) is bit-equal to it without,
    its ``constrain`` hands back the very tensor, and the reference's
    forward under its own resolver on a 1 x 1 mesh equals its forward
    without. (The reference's ``make_host_mesh`` builds ``Explicit`` axes
    on this jax, on which ``with_sharding_constraint`` raises; the mesh
    here has the ``Auto`` axes the reference's constrain needs.)"""
    import dataclasses

    import _lm_parity as LP
    from _smoke_archs import SMOKES
    from _torch_archs import TORCH_SMOKES
    from repro.models import model as JM
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model as TM
    from repro_torch.sharding.resolver import constrain, use_resolver

    cfg = dataclasses.replace(SMOKES[arch], scan_layers=False)
    jp, _ = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = LP.make_batch(cfg)
    tcfg = TORCH_SMOKES[arch]
    plain = TM.forward(tp, tcfg, LP.to_torch(batch), remat=False)[0]
    r = Resolver(make_production_mesh())
    with use_resolver(r):
        held = TM.forward(tp, tcfg, LP.to_torch(batch), remat=False)[0]
        x = torch.zeros((4, 3, 8))
        assert constrain(x, ("batch", None, "act_embed")) is x
        assert constrain(x, ("batch",)) is x      # ranks differ: identity
    assert torch.equal(plain, held) and len(r.constraints) > 2
    jplain = JM.forward(jp, cfg, LP.to_jax(batch), remat=False)[0]
    host = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with jres.use_resolver(jres.Resolver(host)):
        jheld = JM.forward(jp, cfg, LP.to_jax(batch), remat=False)[0]
    np.testing.assert_array_equal(np.asarray(jplain), np.asarray(jheld))


def test_active_and_use_resolver_nest_like_the_reference():
    from repro_torch.sharding.resolver import active, use_resolver

    a, b = Resolver(_stub("data")), Resolver(_stub("data_model"))
    assert active() is None and jres.active() is None
    with use_resolver(a):
        assert active() is a
        with use_resolver(b):
            assert active() is b
        with use_resolver(None):
            assert active() is None
        assert active() is a
    assert active() is None


def test_constrain_on_a_mesh_without_model_raises_like_the_reference():
    """C4: an ``embed`` dimension already on ``data`` sends the second pass
    to a ``model`` axis the mesh lacks: ``KeyError`` in both packages,
    through ``constrain`` too."""
    ours, theirs = Resolver(_stub("data")), jres.Resolver(_stub("data"))
    with pytest.raises(KeyError):
        theirs.spec_for((8, 4), ("embed", None))
    with pytest.raises(KeyError):
        ours.constrain(torch.zeros((8, 4)), ("embed", None))


def test_mesh_and_named_sharding_place_a_tensor():
    """A 2 x 2 virtual CPU mesh: ``shard_shape``, each position's slice
    (``data`` splits dim 0, ``model`` dim 1; a replicated axis copies),
    ``full()`` and ``__array__`` give the tensor back; a 1 x 1 mesh places
    the plain tensor."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.resolver import Mesh, NamedSharding

    mesh = Mesh(np.array([["cpu", "cpu"], ["cpu", "cpu"]], dtype=object),
                ("data", "model"))
    assert mesh.shape == {"data": 2, "model": 2} and mesh.devices.size == 4
    assert list(mesh.shape) == ["data", "model"]
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    s = NamedSharding(mesh, P("data", "model"))
    assert s.shard_shape((4, 6)) == (2, 3)
    placed = s.place(x)
    assert torch.equal(placed.shards[1, 0], x[2:, :3])
    assert torch.equal(placed.full(), x)
    np.testing.assert_array_equal(np.asarray(placed), x.numpy())
    rep = NamedSharding(mesh, P(None, ("data", "model"))).place(x[:, :4])
    assert rep.shards[1, 1].shape == (4, 1)
    assert torch.equal(rep.shards[0, 1], x[:, 1:2])
    row = NamedSharding(mesh, P("model")).place(x)
    assert torch.equal(row.shards[0, 1], row.shards[1, 1])   # data copies
    assert row.shards[0, 1].data_ptr() != row.shards[1, 1].data_ptr()
    with pytest.raises(ValueError, match="does not divide"):
        NamedSharding(mesh, P("data")).place(torch.zeros(3))
    host = make_host_mesh("cpu")
    one = NamedSharding(host, P("data", "model")).place(x)
    assert isinstance(one, torch.Tensor) and torch.equal(one, x)
    r = Resolver(mesh)
    assert tuple(r.sharding_for((4, 6), ("embed", "mlp")).spec) == \
        ("data", "model")
