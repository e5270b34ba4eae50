"""The port's data-parallel layer (``repro_torch.parallel``) on the CPU.

Every case of ``tests/test_parallel.py`` runs here on a 4-way *virtual*
mesh, ``DataMesh(("cpu",) * 4)``: four shards on the one CPU device, the
port's counterpart of the reference's ``--xla_force_host_platform_device_
count``. So none of them skips in the tier-1 run, where the reference's own
multi-device cases do.

- Sharded == the port's single-device ``infer_batch``, bit for bit, logits
  and all five stats, at B in {1, 3, 16, 64} (1 and 3 take the padding
  path) on ``dense`` and ``queue_pallas``, at a depth that overflows.
- The port's sharded result against the reference's single-device
  ``infer_batch`` on a dyadic net: integer stats equal, logits to the
  engine parity tests' 1e-4 (``tests/test_torch_engine.py``). The
  reference's sharded result equals its single-device one by its own
  contract.
- ``use_mesh`` routing, ``queue_sparse``'s local fallback, the one-device
  mesh, ``data_mesh``, the resolver's batch rule, serving over a mesh
  (runtime, ``set_mesh``, ``load_registry(mesh=)``), ``reshard_on_load``,
  and the runner cache's reset by the neuron registry's hooks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro_torch import obs, parallel
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.core import engine, neuron
from repro_torch.parallel import executor
from repro_torch.sharding.resolver import batch_partition_spec

from _torch_nets import dyadic_net

SPEC = "6C3-P2-4C3-8"
HW, C = 10, 1
N_LAYERS = len(engine.parse_spec(SPEC))
MESH = parallel.DataMesh(("cpu",) * 4)
STAT_FIELDS = engine.SNNStats._fields
# depth 8 at T=3 on binary input puts the queues in the drop regime
DROP = dict(T=3, depth=8, mode="mttfs_cont", input_mode="binary")


def _cfg(**kw):
    return engine.SNNConfig(spec=SPEC, input_hw=HW, input_c=C, **kw)


@pytest.fixture(scope="module")
def net():
    """Gaussian weights from a seed, thresholds 0.5, 64 images."""
    rng = np.random.default_rng(7)
    plan = engine.compile_plan(SPEC, HW, C)
    params = [{} for _ in range(plan.n_layers)]
    for cp in plan.convs:
        params[cp.index] = {
            "w": rng.normal(0, 0.5, (3, 3, cp.in_c, cp.out_c)),
            "b": rng.normal(0, 0.1, (cp.out_c,))}
    params[plan.out.index] = {
        "w": rng.normal(0, 0.3, (plan.out.n_in, plan.out.n_out)),
        "b": rng.normal(0, 0.1, (plan.out.n_out,))}
    params = [{k: v.astype(np.float32) for k, v in p.items()}
              for p in params]
    th = [np.float32(0.5)] * N_LAYERS
    imgs = np.random.default_rng(3).random((64, HW, HW, C)).astype(np.float32)
    return params, th, imgs


def _assert_bit_exact(got, ref, label):
    gl, gs = got
    rl, rs = ref
    assert torch.equal(gl, rl), f"{label}: logits"
    for f, a, b in zip(STAT_FIELDS, gs, rs):
        assert torch.equal(a, b), f"{label}: stats.{f}"


# ---------------------------------------------------------------------------
# Bit-exactness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "queue_pallas"])
@pytest.mark.parametrize("B", [1, 3, 16, 64])
def test_sharded_bit_exact_vs_single_device(net, backend, B):
    """Sharded logits AND stats == single-device, overflow included."""
    params, th, imgs = net
    cfg = _cfg(**DROP)
    ref = engine.infer_batch(params, th, cfg, imgs[:B], backend=backend,
                             device="cpu")
    got = parallel.infer_batch_sharded(params, th, cfg, imgs[:B],
                                       backend=backend, mesh=MESH)
    _assert_bit_exact(got, ref, f"{backend}/B={B}")
    if B >= 16:
        # the small depth must really drop events, or the overflow
        # comparison proves nothing
        assert int(ref[1].overflow.sum()) > 0


@pytest.mark.parametrize("backend", ["dense", "queue_pallas"])
@pytest.mark.parametrize("B", [1, 3, 16, 64])
def test_sharded_matches_reference_single_device(backend, B):
    """The port sharded 4 ways against the reference on one device, on a
    dyadic net: integer stats equal, logits within 1e-4."""
    params, th = dyadic_net(SPEC, HW, C)
    imgs = (np.random.default_rng(5).integers(0, 256, (B, HW, HW, C))
            / 256.0).astype(np.float32)
    kw = dict(spec=SPEC, input_hw=HW, input_c=C, **DROP)
    lj, sj = jengine.infer_batch(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in params],
        [jnp.asarray(t) for t in th], jengine.SNNConfig(**kw),
        jnp.asarray(imgs), backend=backend)
    lt, st = parallel.infer_batch_sharded(params, th, engine.SNNConfig(**kw),
                                          imgs, backend=backend, mesh=MESH)
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                               rtol=1e-4)


def test_sharded_analog_input_mode(net):
    """The analog (constant-current) encoding shards bit-exactly too."""
    params, th, imgs = net
    cfg = _cfg(T=3, mode="mttfs_cont", input_mode="analog")
    ref = engine.infer_batch(params, th, cfg, imgs[:16], backend="dense",
                             device="cpu")
    got = parallel.infer_batch_sharded(params, th, cfg, imgs[:16],
                                       backend="dense", mesh=MESH)
    _assert_bit_exact(got, ref, "analog/dense")


def test_shard_execute_span_records_the_geometry(net):
    """One ``parallel.shard_execute`` span a sharded call, with the
    reference's attributes; padded calls say how many rows they added."""
    params, th, imgs = net
    cfg = _cfg(**DROP)
    obs.reset()
    obs.enable()
    try:
        parallel.infer_batch_sharded(params, th, cfg, imgs[:6],
                                     backend="queue_pallas", mesh=MESH)
        parallel.infer_batch_sharded(params, th, cfg, imgs[:16],
                                     backend="queue_pallas", mesh=MESH)
        spans = [s.attrs for s in obs.spans()
                 if s.name == "parallel.shard_execute"]
    finally:
        obs.disable()
        obs.reset()
    assert spans == [
        dict(backend="queue_pallas", B=6, devices=4, shard_B=2, padded=2),
        dict(backend="queue_pallas", B=16, devices=4, shard_B=4, padded=0)]


def test_use_mesh_routes_engine_infer_batch(net):
    """Inside ``use_mesh`` the engine entry point itself is sharded (same
    bits); the dispatch is restored on exit, exception included."""
    params, th, imgs = net
    cfg = _cfg(**DROP)
    batch = imgs[:6]                    # 6 % 4 != 0: padded under the mesh
    ref = engine.infer_batch(params, th, cfg, batch, backend="dense",
                             device="cpu")

    assert engine._batch_dispatch is None
    obs.reset()
    obs.enable()
    try:
        with parallel.use_mesh(MESH):
            assert engine._batch_dispatch is not None
            got = engine.infer_batch(params, th, cfg, batch, backend="dense")
        routed = [s for s in obs.spans()
                  if s.name == "parallel.shard_execute"]
    finally:
        obs.disable()
        obs.reset()
    assert engine._batch_dispatch is None
    assert len(routed) == 1
    _assert_bit_exact(got, ref, "use_mesh/dense")

    with pytest.raises(RuntimeError, match="boom"):
        with parallel.use_mesh(MESH):
            raise RuntimeError("boom")
    assert engine._batch_dispatch is None      # restored despite the raise

    with parallel.use_mesh(None):              # None is a no-op block
        assert engine._batch_dispatch is None


def test_queue_sparse_falls_back_to_the_local_runner(net):
    """``queue_sparse`` sizes its layers from host-side totals: under a
    mesh it runs unsharded (equal to the engine), and the sharded runner
    refuses it."""
    params, th, imgs = net
    cfg = _cfg(**DROP)
    ref = engine.infer_batch(params, th, cfg, imgs[:16],
                             backend="queue_sparse", device="cpu")
    obs.reset()
    obs.enable()
    try:
        with parallel.use_mesh(MESH):
            got = engine.infer_batch(params, th, cfg, imgs[:16],
                                     backend="queue_sparse")
        assert not [s for s in obs.spans()
                    if s.name == "parallel.shard_execute"]
    finally:
        obs.disable()
        obs.reset()
    _assert_bit_exact(got, ref, "queue_sparse under a mesh")
    with pytest.raises(ValueError, match="host-side occupancy"):
        parallel.batch_runner_sharded(cfg, "queue_sparse", MESH)


def test_single_device_mesh_falls_back_to_engine(net):
    """A mesh of one device == the engine's own batched call."""
    params, th, imgs = net
    cfg = _cfg(T=2, depth=16, mode="mttfs_cont")
    ref = engine.infer_batch(params, th, cfg, imgs[:4], backend="dense",
                             device="cpu")
    got = parallel.infer_batch_sharded(params, th, cfg, imgs[:4],
                                       backend="dense",
                                       mesh=parallel.DataMesh(("cpu",)))
    _assert_bit_exact(got, ref, "1-device mesh")


# ---------------------------------------------------------------------------
# The mesh, the resolver's batch rule, the runner cache
# ---------------------------------------------------------------------------

def test_data_mesh_shape_caching_and_errors(monkeypatch):
    """``data_mesh`` takes distinct visible cards, caches its meshes, and
    names the virtual-mesh route past the visible count."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = parallel.data_mesh()
    assert mesh.axis_names == (parallel.DATA_AXIS,)
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.shape == {"data": 2} and parallel.mesh_size(mesh) == 2
    assert parallel.data_mesh() is mesh          # cached: stable cache keys
    assert parallel.data_mesh(2) is mesh
    assert parallel.data_mesh(1).devices == (torch.device("cuda", 0),)
    assert parallel.mesh_size(None) == 1
    with pytest.raises(ValueError, match="DataMesh"):
        parallel.data_mesh(3)
    with pytest.raises(ValueError):
        parallel.data_mesh(0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="virtual mesh"):
        parallel.data_mesh()


def test_virtual_mesh_is_immutable_and_keyed_by_its_devices():
    mesh = parallel.DataMesh(["cpu", torch.device("cpu")])
    assert mesh.shape == {"data": 2} and parallel.mesh_size(mesh) == 2
    assert mesh == parallel.DataMesh(("cpu",) * 2)
    assert hash(mesh) == hash(parallel.DataMesh(("cpu",) * 2))
    assert mesh != parallel.DataMesh(("cpu",) * 3)
    with pytest.raises(AttributeError):
        mesh.devices = ()
    with pytest.raises(ValueError):
        parallel.DataMesh(())


def test_batch_partition_spec_divisibility_fallback():
    # the resolver rule the executor reuses: shard iff B divides the mesh
    assert batch_partition_spec(MESH, (8, 10, 10, 1))[0] == "data"
    assert batch_partition_spec(MESH, (6, 10, 10, 1))[0] is None
    assert batch_partition_spec(MESH, (3, 28, 28, 1))[0] is None
    assert tuple(batch_partition_spec(MESH, (8, 10, 10, 1))[1:]) == (
        None, None, None)


def test_reregistered_mode_clears_the_runner_cache(net):
    """A neuron registry write empties the sharded runners and the params'
    copies (the hooks of ``neuron._on_registry_change``), and a mode
    re-registered with another fire function then gives that function's
    result sharded, equal to the engine's."""
    params, th, imgs = net
    name = "probe_parallel"
    base = neuron.get_neuron_model("mttfs_cont")
    neuron.register_neuron_model(name, base.fire)
    try:
        cfg = _cfg(T=3, depth=8, mode=name, input_mode="binary")
        first = parallel.infer_batch_sharded(params, th, cfg, imgs[:16],
                                             backend="queue_pallas",
                                             mesh=MESH)
        assert executor._RUNNERS and executor._REPLICAS
        reset = neuron.get_neuron_model("if_reset")
        neuron.register_neuron_model(name, reset.fire, overwrite=True)
        assert not executor._RUNNERS and not executor._REPLICAS
        got = parallel.infer_batch_sharded(params, th, cfg, imgs[:16],
                                           backend="queue_pallas", mesh=MESH)
        ref = engine.infer_batch(params, th, cfg, imgs[:16],
                                 backend="queue_pallas", device="cpu")
        _assert_bit_exact(got, ref, "re-registered mode")
        assert not torch.equal(got[1].spikes_out, first[1].spikes_out)
    finally:
        neuron.unregister_neuron_model(name)


def test_replicas_are_kept_until_the_params_change(net):
    """A params copy per (mesh, device) is reused while its sources are the
    same tensors at the same version, and made anew after an in-place
    update."""
    params, th, _ = net
    p, t = engine.to_device(params, th, "cpu")
    mesh = parallel.DataMesh(("cpu",) * 2)
    cpu = torch.device("cpu")
    first = executor.replicate(p, t, cpu, mesh)
    assert executor.replicate(p, t, cpu, mesh)[0] is first[0]   # kept
    p[0]["b"].add_(0.0)                        # bumps the version counter
    assert executor.replicate(p, t, cpu, mesh)[0] is not first[0]


# ---------------------------------------------------------------------------
# Serving over a mesh
# ---------------------------------------------------------------------------

def _serve_cfg():
    return engine.SNNConfig(spec=SPEC, input_hw=HW, input_c=C, T=3,
                            depth=16, mode="mttfs_cont", input_mode="binary")


def test_serve_runtime_mesh_responses_bit_equal(net):
    """A mesh-backed runtime serves the same logits, stats and energies as
    a local one, and only mesh-divisible buckets build sharded plans."""
    from repro_torch.serve import BucketPolicy, ModelRegistry, ServeRuntime
    from repro_torch.serve.registry import ShardedPlan

    params, th, imgs = net
    cfg = _serve_cfg()

    def serve_all(mesh):
        registry = ModelRegistry(device="cpu")
        registry.register("toy", params, th, cfg, backend="queue_pallas")
        rt = ServeRuntime(registry, BucketPolicy((1, 4, 16)), mesh=mesh)
        out = []
        for n in (9, 1, 4):                    # buckets 16, 1 and 4
            for im in imgs[:n]:
                rt.submit(im)
            out += rt.run_until_drained()
        return sorted(out, key=lambda r: r.rid), registry.get("toy")

    local, _ = serve_all(None)
    sharded, handle = serve_all(MESH)
    assert len(local) == len(sharded) == 14
    for a, b in zip(local, sharded):
        np.testing.assert_array_equal(a.logits, b.logits)
        for x, y in zip(a.stats, b.stats):
            np.testing.assert_array_equal(x, y)
        assert a.energy_j == b.energy_j            # float-exact metering
        assert a.model_latency_s == b.model_latency_s
        assert (a.pred, a.bucket) == (b.pred, b.bucket)
    assert handle.mesh == MESH and handle.compile_count == 3
    assert isinstance(handle.plan_for(16), ShardedPlan)
    assert isinstance(handle.plan_for(4), ShardedPlan)
    assert not isinstance(handle.plan_for(1), ShardedPlan)
    for b in (1, 4, 16):
        assert handle._bucket_sharded(b) == (b % 4 == 0)


def test_registry_set_mesh_drops_plans(net):
    from repro_torch.serve import ModelRegistry

    params, th, imgs = net
    cfg = _cfg(T=2, depth=16, mode="mttfs_cont")
    registry = ModelRegistry(device="cpu")
    handle = registry.register("toy", params, th, cfg, backend="dense")
    handle.plan_for(4)
    before = handle.run_bucket(imgs[:4], 3)
    assert handle.cached_buckets() == (4,) and handle.compile_count == 1
    registry.set_mesh(MESH)                    # re-equips live handles
    assert handle.mesh == MESH and registry.mesh == MESH
    assert handle.cached_buckets() == ()       # placement-stale plans gone
    registry.set_mesh(parallel.DataMesh(("cpu",) * 4))   # an equal mesh
    handle.plan_for(4)                         # rebuilds sharded, runs
    assert handle.compile_count == 2
    registry.set_mesh(parallel.DataMesh(("cpu",) * 4))
    assert handle.cached_buckets() == (4,)     # unchanged mesh: plans kept
    _assert_bit_exact(handle.run_bucket(imgs[:4], 3), before, "set_mesh")
    assert registry.register("new", params, th, cfg,
                             backend="dense").mesh == MESH


def test_load_registry_with_a_mesh_builds_plans_lazily(net, tmp_path):
    """``load_registry(mesh=)`` restores the params and builds no plan;
    each bucket's plan (sharded where it divides the mesh) comes on first
    use, one ``compile_count`` each, answering as the saved registry."""
    from repro_torch.serve import ModelRegistry, load_registry, save_registry
    from repro_torch.serve.registry import ShardedPlan

    params, th, imgs = net
    cfg = _serve_cfg()
    built = ModelRegistry(device="cpu")
    built.register("toy", params, th, cfg).warmup((1, 4, 16))
    save_registry(built, str(tmp_path))

    eager = load_registry(str(tmp_path), device="cpu")
    assert eager.get("toy").cached_buckets() == (1, 4, 16)
    lazy = load_registry(str(tmp_path), device="cpu", mesh=MESH)
    h = lazy.get("toy")
    assert h.mesh == MESH and h.cached_buckets() == ()
    assert h.compile_count == 0
    for b in (1, 4, 16):
        _assert_bit_exact(h.run_bucket(imgs[:b], b),
                          built.get("toy").run_bucket(imgs[:b], b),
                          f"restored over a mesh, bucket {b}")
    assert h.cached_buckets() == (1, 4, 16) and h.compile_count == 3
    assert isinstance(h.plan_for(16), ShardedPlan)


def test_reshard_on_load_places_every_leaf(tmp_path):
    """Restored leaves go to the device given for each (a mesh: its first
    device), dtypes kept; placements of another structure are refused."""
    rng = np.random.default_rng(0)
    tree = {"params": [{"w": rng.normal(size=(3, 4)).astype(np.float32),
                        "b": np.arange(4, dtype=np.int32)}, {}],
            "thresholds": [np.float32(0.5)]}
    ck.save(str(tmp_path), 1, tree)
    restored, _ = ck.restore(str(tmp_path), tree)
    placements = {"params": [{"w": MESH, "b": "cpu"}, {}],
                  "thresholds": [torch.device("cpu")]}
    placed = ck.reshard_on_load(restored, placements)
    leaves = [placed["params"][0]["w"], placed["params"][0]["b"],
              placed["thresholds"][0]]
    assert all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
               for x in leaves)
    assert placed["params"][1] == {}
    assert placed["params"][0]["b"].dtype == torch.int32
    np.testing.assert_array_equal(leaves[0].numpy(), tree["params"][0]["w"])
    np.testing.assert_array_equal(leaves[1].numpy(), tree["params"][0]["b"])
    assert float(leaves[2]) == 0.5
    with pytest.raises(ValueError, match="placements"):
        ck.reshard_on_load(restored, {"params": [{"w": "cpu"}, {}],
                                      "thresholds": ["cpu"]})
