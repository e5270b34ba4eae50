"""The port's checkpoint layer against the JAX package's.

The reference's own cases (atomicity, integrity, corruption fallback,
async writes and GC, NamedTuple state, the SNN params tree with empty pool
slots) on tensor trees, then the on-disk format across the two packages:
a tree the JAX package saves restores in the port bit-equal, and the
reverse, for plain trees and for ``(params, AdamWState)`` with empty pool
slots. (``reshard_on_load`` onto devices and a ``DataMesh`` is held in
``tests/test_torch_parallel.py``; onto the resolver's shardings here.)
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.core.snn_model import init_params as jinit_params
from repro.training.optimizer import adamw_init as jadamw_init
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.core.snn_model import init_params, params_from_numpy
from repro_torch.training.optimizer import AdamWState, adamw_init

pytestmark = pytest.mark.filterwarnings(
    "ignore:The given NumPy array is not writable")


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.tensor(rng.normal(size=(4, 8)), dtype=torch.float32),
        "nested": {"b": torch.tensor(rng.integers(0, 9, (3,)),
                                     dtype=torch.int32)},
    }


def _leaves_equal(a, b):
    fa, fb = ck._flatten(a), ck._flatten(b)
    assert sorted(fa) == sorted(fb)
    for p in fa:
        x, y = (np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor)
                           else v) for v in (fa[p], fb[p]))
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(x, y, err_msg=p)


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    ck.save(str(tmp_path), 7, tree)
    restored, step = ck.restore(str(tmp_path), tree)
    assert step == 7
    _leaves_equal(restored, tree)
    assert restored["a"].dtype == torch.float32
    assert restored["nested"]["b"].dtype == torch.int32


def test_restore_follows_the_template_leaves(tmp_path):
    """A tensor template leaf gives a tensor of its dtype and device; any
    other leaf gives the saved numpy array."""
    tree = _tree()
    ck.save(str(tmp_path), 1, tree)
    template = {"a": torch.zeros((), dtype=torch.float64),
                "nested": {"b": 0}}
    restored, _ = ck.restore(str(tmp_path), template)
    assert restored["a"].dtype == torch.float64
    assert restored["a"].device.type == "cpu"
    assert isinstance(restored["nested"]["b"], np.ndarray)
    np.testing.assert_array_equal(restored["nested"]["b"],
                                  tree["nested"]["b"].numpy())


def test_latest_step_ignores_uncommitted(tmp_path):
    ck.save(str(tmp_path), 5, _tree())
    os.makedirs(tmp_path / "step_000000009")     # a crashed save
    assert ck.latest_step(str(tmp_path)) == 5
    assert ck.latest_step(str(tmp_path / "none")) is None


def test_corrupt_checkpoint_falls_back(tmp_path):
    tree = _tree()
    ck.save(str(tmp_path), 1, tree)
    ck.save(str(tmp_path), 2, {"a": tree["a"] + 1,
                               "nested": {"b": tree["nested"]["b"] + 1}})
    shard = tmp_path / "step_000000002" / "shard_00000.npz"
    shard.write_bytes(b"garbage")
    restored, step = ck.restore(str(tmp_path), tree)
    assert step == 1
    _leaves_equal(restored, tree)


def test_hash_mismatch_detected(tmp_path):
    tree = _tree()
    path = ck.save(str(tmp_path), 3, tree)
    man = json.load(open(os.path.join(path, "manifest.json")))
    next(iter(man["leaves"].values()))["hash"] = "deadbeef"
    json.dump(man, open(os.path.join(path, "manifest.json"), "w"))
    with pytest.raises(IOError):
        ck.restore(str(tmp_path), tree)
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "none"), tree)


def test_async_checkpointer_and_gc(tmp_path):
    acp = ck.AsyncCheckpointer(str(tmp_path), keep=2)
    trees = {s: _tree(s) for s in [10, 20, 30, 40]}
    for s, tree in trees.items():
        acp.save(s, tree)
    acp.wait()
    acp._gc()
    steps = sorted(int(n[5:-10]) for n in os.listdir(tmp_path)
                   if n.endswith(".COMMITTED"))
    assert steps == [30, 40] and acp.last_saved == 40
    restored, step = ck.restore(str(tmp_path), trees[40])
    assert step == 40
    _leaves_equal(restored, trees[40])


def test_namedtuple_state_roundtrip(tmp_path):
    params = [{"w": torch.randn(3, 4), "b": torch.zeros(4)}]
    state = (params, adamw_init(params))
    state[1].mu[0]["w"].add_(0.5)
    ck.save(str(tmp_path), 5, state)
    restored, _ = ck.restore(str(tmp_path), state)
    assert isinstance(restored[1], AdamWState)
    assert restored[1].step.dtype == torch.int32
    _leaves_equal(restored, state)


def test_snn_params_with_empty_pool_slots_roundtrip(tmp_path):
    """The engine's params (a list of per-layer dicts, pool slots EMPTY
    dicts) and their AdamW state: the tree ``fit_snn`` checkpoints between
    epochs round-trips bit-exactly, the empty slot included."""
    params = init_params(torch.Generator().manual_seed(0), "4C3-P2-6", 8, 1,
                         device="cpu")
    assert params[1] == {}
    state = (params, adamw_init(params))
    ck.save(str(tmp_path), 2, state)
    restored, step = ck.restore(str(tmp_path), state)
    assert step == 2 and restored[0][1] == {}
    _leaves_equal(restored, state)


def _jax_state():
    params = jinit_params(jax.random.PRNGKey(0), "4C3-P2-6", 8, 1)
    opt = jadamw_init(params)
    opt = opt._replace(step=jnp.asarray(3, jnp.int32),
                       mu=jax.tree.map(lambda x: x + 0.25, opt.mu))
    return params, opt


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The JAX package saves ``(params, AdamWState)`` and a plain tree; the
    port restores both bit-equal into its own templates."""
    jstate = _jax_state()
    jck.save(str(tmp_path / "a"), 4, jstate)
    tparams = params_from_numpy(
        [{k: np.zeros_like(np.asarray(v)) for k, v in p.items()}
         for p in jstate[0]], [], device="cpu")[0]
    template = (tparams, adamw_init(tparams))
    restored, step = ck.restore(str(tmp_path / "a"), template)
    assert step == 4 and restored[0][1] == {}
    assert isinstance(restored[1], AdamWState)
    _leaves_equal(restored, jax.tree.map(np.asarray, jstate))

    plain = {"a": jnp.arange(6.0).reshape(2, 3),
             "nested": {"b": jnp.asarray([1, 2, 3], jnp.int32)}}
    jck.save(str(tmp_path / "b"), 1, plain)
    restored, _ = ck.restore(str(tmp_path / "b"), _tree())
    _leaves_equal(restored, jax.tree.map(np.asarray, plain))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port saves; the JAX package restores bit-equal, and the two
    manifests (paths, shapes, dtypes, shards, hashes) are equal."""
    jstate = _jax_state()
    tparams = params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in jstate[0]], [],
        device="cpu")[0]
    topt = AdamWState(
        step=torch.tensor(3, dtype=torch.int32),
        mu=params_from_numpy([{k: np.asarray(v) for k, v in p.items()}
                              for p in jstate[1].mu], [], device="cpu")[0],
        nu=params_from_numpy([{k: np.asarray(v) for k, v in p.items()}
                              for p in jstate[1].nu], [], device="cpu")[0])
    port_path = ck.save(str(tmp_path / "port"), 6, (tparams, topt))
    restored, step = jck.restore(str(tmp_path / "port"), jstate)
    assert step == 6 and restored[0][1] == {}
    _leaves_equal(restored, (tparams, topt))

    ref_path = jck.save(str(tmp_path / "ref"), 6, jstate)
    with open(os.path.join(port_path, "manifest.json")) as f:
        port_manifest = json.load(f)
    with open(os.path.join(ref_path, "manifest.json")) as f:
        assert port_manifest == json.load(f)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref"))


def test_elastic_reshard_on_load(tmp_path):
    """Restore, then place onto a (degenerate 1x1) host mesh through the
    resolver's shardings — the elastic path, as the reference's test; and
    onto a 2 x 2 virtual CPU mesh, where each leaf becomes its shards."""
    import numpy as np

    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.sharding.resolver import Resolver, ShardedTensor

    tree = _tree()
    ck.save(str(tmp_path), 1, tree)
    restored, _ = ck.restore(str(tmp_path), tree)
    for mesh in (make_host_mesh("cpu"),
                 make_production_mesh(dp=2, tp=2, device="cpu")):
        r = Resolver(mesh)
        shardings = {
            "a": r.sharding_for((4, 8), ("embed", "mlp")),
            "nested": {"b": r.sharding_for((3,), (None,))},
        }
        placed = ck.reshard_on_load(restored, shardings)
        np.testing.assert_array_equal(np.asarray(placed["a"]),
                                      np.asarray(tree["a"]))
        np.testing.assert_array_equal(np.asarray(placed["nested"]["b"]),
                                      tree["nested"]["b"].numpy())
        if mesh.devices.size > 1:
            assert isinstance(placed["a"], ShardedTensor)
            assert placed["a"].shards[0, 1].shape == (2, 4)
        else:
            assert isinstance(placed["a"], torch.Tensor)
