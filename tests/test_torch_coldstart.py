"""Registry checkpoints and the replica fleet: ``repro_torch.serve.persist``
and ``repro_torch.serve.fleet`` against ``tests/test_coldstart.py``'s
contract and against the reference package.

1. **Bit-exactness** — a registry restored from disk serves the same
   logits, stats and energies as the registry that built it.
2. **No rebuild on the warm path** — ``load_registry`` rebuilds the saved
   bucket ladder through ``adopt_plan``: ``cached_buckets()`` is the
   ladder, ``compile_count`` stays 0 through ``warmup``.
3. **Failures are loud and named** (stale, corrupt, missing).
4. **Degrade, don't die** — a plan entry of a foreign format (the
   reference's ``jax_export`` blobs) is skipped and built lazily.
5. **Across packages** — ``registry_key`` equals the reference's on the
   same params, and a registry saved by either package restores in the
   other with equal stats and logits (dyadic nets: exact, as the serving
   parity tests hold them).
6. **The fleet** — replicas on the CPU answer bit-identically and equal
   the in-process restored registry; a tiny ``--timeout`` exits 124; a
   worker asked for the card without one fails.
"""
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.core import engine as jengine
from repro.serve import persist as jpersist
from repro_torch import obs
from repro_torch import serve as tserve
from repro_torch.core import engine, snn_model
from repro_torch.serve import bench, fleet, persist
from repro_torch.serve import (CheckpointError, CorruptCheckpointError,
                               StaleCheckpointError, load_registry,
                               save_registry)

from _torch_nets import dyadic_net, images

SPEC = "4C3-P2-8"
HW, C = 8, 1
BUCKETS = (1, 4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_cfg(pkg=engine, **overrides):
    kw = dict(spec=SPEC, input_hw=HW, input_c=C, T=3, depth=16,
              mode="mttfs_cont", input_mode="binary")
    kw.update(overrides)
    return pkg.SNNConfig(**kw)


@pytest.fixture(scope="module")
def net():
    params = snn_model.init_params(torch.Generator().manual_seed(7), SPEC,
                                   HW, C, device="cpu")
    th = [torch.tensor(0.5)] * len(params)
    imgs = np.random.default_rng(3).random((6, HW, HW, C)).astype(np.float32)
    return params, th, imgs


def build_registry(net, **cfg_overrides):
    params, th, _ = net
    reg = tserve.ModelRegistry(device="cpu")
    reg.register("toy", params, th, make_cfg(**cfg_overrides),
                 backend="queue_pallas")
    return reg


def serve_all(serve_mod, registry, imgs):
    """Run every image through a fresh runtime; responses sorted by rid."""
    rt = serve_mod.ServeRuntime(registry, serve_mod.BucketPolicy(BUCKETS))
    for img in imgs:
        rt.submit(img)
    responses = rt.step() + rt.run_until_drained()
    responses.sort(key=lambda r: r.rid)
    return responses


@pytest.fixture(scope="module")
def saved(net, tmp_path_factory):
    """One canonical save: (checkpoint root, reference responses)."""
    _, _, imgs = net
    reg = build_registry(net)
    root = str(tmp_path_factory.mktemp("ckpt") / "registry")
    save_registry(reg, root, buckets=BUCKETS)
    return root, serve_all(tserve, reg, imgs)


def copy_ckpt(saved, tmp_path):
    dst = str(tmp_path / "registry")
    shutil.copytree(saved[0], dst)
    return dst


def assert_same_responses(ref, got):
    assert [r.rid for r in got] == [r.rid for r in ref]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a.logits),
                                      np.asarray(b.logits))
        assert a.pred == b.pred
        assert np.float32(a.energy_j) == np.float32(b.energy_j)
        for f_a, f_b in zip(a.stats, b.stats):
            np.testing.assert_array_equal(np.asarray(f_a), np.asarray(f_b))


# ---------------------------------------------------------------------------
# Round trip: bit-exactness + the no-rebuild warm path
# ---------------------------------------------------------------------------

def test_restore_serves_bit_exact(net, saved):
    _, _, imgs = net
    root, ref = saved
    got = serve_all(tserve, load_registry(root, device="cpu"), imgs)
    assert_same_responses(ref, got)
    for a, b in zip(ref, got):
        assert a.energy_j == b.energy_j    # the fleet parent's comparison


def test_restore_plans_then_warmup_never_compiles(saved):
    root, _ = saved
    obs.enable()
    try:
        h = load_registry(root, device="cpu").get("toy")
        counters = obs.metrics_snapshot()["counters"]
    finally:
        obs.disable()
        obs.reset()
    assert set(h.cached_buckets()) == set(BUCKETS)
    assert h.compile_count == 0
    assert counters["persist.plan_restore"] == len(BUCKETS)
    assert counters["serve.plan_adopt"] == len(BUCKETS)
    h.warmup(BUCKETS)            # execute-only: restored plans are hits
    assert h.compile_count == 0


def test_restored_handle_keeps_provenance(saved):
    root, _ = saved
    manifest = persist.read_manifest(root)
    assert manifest["torch_version"] == torch.__version__
    entry = manifest["models"]["toy"]
    h = load_registry(root, device="cpu").get("toy")
    assert entry["key"] == persist.registry_key(
        h.params, h.thresholds, h.cfg, h.backend)
    assert entry["backend"] == "queue_pallas"
    assert entry["plans"] == {str(b): {"format": "eager", "bucket": b}
                              for b in BUCKETS}
    assert sorted(entry) == sorted(
        ("dir", "key", "backend", "vmem_resident", "source_key", "cfg",
         "params_tree", "n_thresholds", "plans"))


def test_save_defaults_to_cached_buckets_and_params_only(net, tmp_path):
    reg = build_registry(net)
    reg.get("toy").warmup((4,))
    root = save_registry(reg, str(tmp_path / "a"))
    assert set(persist.read_manifest(root)["models"]["toy"]["plans"]) == {"4"}
    root = save_registry(reg, str(tmp_path / "b"), plans=False)
    assert persist.read_manifest(root)["models"]["toy"]["plans"] == {}
    h = load_registry(root, device="cpu").get("toy")
    assert h.cached_buckets() == () and h.compile_count == 0


def test_load_selects_names_and_refuses_unknown_ones(net, tmp_path):
    params, th, _ = net
    reg = build_registry(net)
    reg.register("other", params, th, make_cfg(T=2))
    root = save_registry(reg, str(tmp_path / "registry"))
    assert load_registry(root, names=["other"], device="cpu").names() == (
        "other",)
    with pytest.raises(CheckpointError, match="not in checkpoint"):
        load_registry(root, names=["nope"], device="cpu")


# ---------------------------------------------------------------------------
# Named failures
# ---------------------------------------------------------------------------

def test_missing_checkpoint_raises_named_error(tmp_path):
    with pytest.raises(CheckpointError, match="no registry checkpoint"):
        load_registry(str(tmp_path / "nowhere"), device="cpu")


def test_tampered_manifest_raises_stale(saved, tmp_path):
    root = copy_ckpt(saved, tmp_path)
    path = os.path.join(root, persist.MANIFEST)
    with open(path) as f:
        manifest = json.load(f)
    manifest["models"]["toy"]["cfg"]["T"] += 1     # silent config drift
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(StaleCheckpointError, match="no longer matches"):
        load_registry(root, device="cpu")


def _flip_byte(path, offset=100):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def test_corrupted_params_shard_raises(saved, tmp_path):
    root = copy_ckpt(saved, tmp_path)
    shards = [os.path.join(dp, fn)
              for dp, _, fns in os.walk(os.path.join(root, "models"))
              for fn in fns if fn.endswith(".npz")]
    assert shards
    _flip_byte(shards[0])
    with pytest.raises(CorruptCheckpointError):
        load_registry(root, device="cpu")


def test_unreadable_manifest_raises_corrupt(saved, tmp_path):
    root = copy_ckpt(saved, tmp_path)
    with open(os.path.join(root, persist.MANIFEST), "w") as f:
        f.write("{ not json")
    with pytest.raises(CorruptCheckpointError, match="unreadable"):
        load_registry(root, device="cpu")


def test_unknown_schema_raises(saved, tmp_path):
    root = copy_ckpt(saved, tmp_path)
    path = os.path.join(root, persist.MANIFEST)
    with open(path) as f:
        manifest = json.load(f)
    manifest["schema"] = "registry-ckpt-v0"
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointError, match="unsupported"):
        load_registry(root, device="cpu")


# ---------------------------------------------------------------------------
# Degrade-don't-die: a plan entry this package cannot restore
# ---------------------------------------------------------------------------

def test_foreign_plan_format_degrades_to_lazy_build(net, saved, tmp_path):
    _, _, imgs = net
    root = copy_ckpt(saved, tmp_path)
    path = os.path.join(root, persist.MANIFEST)
    with open(path) as f:
        manifest = json.load(f)
    for b, entry in manifest["models"]["toy"]["plans"].items():
        entry.update(format="jax_export", file=f"plans/toy/bucket_{b}.jaxexp")
    with open(path, "w") as f:
        json.dump(manifest, f)
    obs.enable()
    try:
        restored = load_registry(root, device="cpu")
        skipped = obs.metrics_snapshot()["counters"][
            "persist.plan_restore_skipped"]
    finally:
        obs.disable()
        obs.reset()
    assert skipped == len(BUCKETS)
    h = restored.get("toy")
    assert h.cached_buckets() == ()
    got = serve_all(tserve, restored, imgs)      # builds lazily
    assert h.compile_count == len(BUCKETS)
    assert_same_responses(saved[1], got)


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------

def test_registry_key_is_content_stable(net):
    params, th, _ = net
    k1 = persist.registry_key(params, th, make_cfg(), "queue_pallas")
    assert k1 == persist.registry_key(params, th, make_cfg(), "queue_pallas")
    assert k1 != persist.registry_key(params, th, make_cfg(T=4),
                                      "queue_pallas")
    assert k1 != persist.registry_key(params, th, make_cfg(), "dense")
    bumped = [dict(layer) for layer in params]
    key0 = sorted(bumped[0])[0]
    bumped[0][key0] = bumped[0][key0] + 1e-3
    assert k1 != persist.registry_key(bumped, th, make_cfg(), "queue_pallas")


@pytest.mark.parametrize("weight_bits", [None, 8])
def test_registry_key_equals_the_reference(weight_bits):
    params_np, th = dyadic_net(SPEC, HW, C)
    kw = dict(weight_bits=weight_bits)
    assert persist.registry_key(params_np, th, make_cfg(**kw),
                                "queue_pallas") == jpersist.registry_key(
        params_np, th, make_cfg(jengine, **kw), "queue_pallas")


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------

XSPEC, XHW, XC = "6C3-P2-8C3-P3-10", 12, 2   # tests/test_torch_serving.py's


def _xcfg(pkg, weight_bits):
    return pkg.SNNConfig(spec=XSPEC, input_hw=XHW, input_c=XC, T=3, depth=4,
                         mode="mttfs_cont", input_mode="binary",
                         weight_bits=weight_bits)


def _xregistries(weight_bits):
    params_np, th = dyadic_net(XSPEC, XHW, XC)
    jreg = jserve.ModelRegistry()
    jreg.register("m", [{k: jnp.asarray(v) for k, v in p.items()}
                        for p in params_np], [jnp.asarray(t) for t in th],
                  _xcfg(jengine, weight_bits), backend="queue_pallas")
    treg = tserve.ModelRegistry(device="cpu")
    treg.register("m", params_np, th, _xcfg(engine, weight_bits),
                  backend="queue_pallas")
    return jreg, treg


@pytest.mark.parametrize("weight_bits", [None, 8])
def test_reference_registry_restores_in_the_port(weight_bits, tmp_path):
    """Saved by ``repro.serve.persist`` (``jax_export`` plans): the port
    restores the params under the same key, skips the foreign plans and
    builds them lazily, and serves what the reference serves."""
    jreg, _ = _xregistries(weight_bits)
    imgs = images(7, XHW, XC, seed=5)
    root = str(tmp_path / "registry")
    jpersist.save_registry(jreg, root, buckets=BUCKETS)
    jresp = serve_all(jserve, jreg, imgs)
    manifest = persist.read_manifest(root)
    assert {p["format"] for p in manifest["models"]["m"]["plans"].values()} \
        == {"jax_export"}

    restored = load_registry(root, device="cpu")
    h = restored.get("m")
    assert h.cached_buckets() == () and h.compile_count == 0
    assert h.cfg == _xcfg(engine, weight_bits)
    assert_same_responses(jresp, serve_all(tserve, restored, imgs))


@pytest.mark.parametrize("weight_bits", [None, 8])
def test_port_registry_restores_in_the_reference(weight_bits, tmp_path):
    """Saved by the port (``eager`` plans): the reference restores the
    params under the same key, skips the plans it cannot import and
    serves what the port serves."""
    _, treg = _xregistries(weight_bits)
    imgs = images(7, XHW, XC, seed=6)
    root = str(tmp_path / "registry")
    save_registry(treg, root, buckets=BUCKETS)
    tresp = serve_all(tserve, treg, imgs)

    restored = jpersist.load_registry(root)
    h = restored.get("m")
    assert h.cached_buckets() == () and h.compile_count == 0
    assert jpersist.read_manifest(root)["models"]["m"]["key"] == \
        jpersist.registry_key(h.params, h.thresholds, h.cfg, h.backend)
    assert_same_responses(tresp, serve_all(jserve, restored, imgs))


# ---------------------------------------------------------------------------
# The fleet, on the CPU
# ---------------------------------------------------------------------------

def _fleet(cache_dir, *extra, timeout=240, env=None):
    cmd = [sys.executable, "-m", "repro_torch.serve.fleet", "--replicas", "2",
           "--quick", "--cache-dir", str(cache_dir), *extra]
    env = dict(env or os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=timeout)


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    cache_dir = tmp_path_factory.mktemp("fleet")
    proc = _fleet(cache_dir, "--device", "cpu", "--timeout", "200")
    assert proc.returncode == 0, proc.stderr[-3000:]
    return cache_dir, json.loads(proc.stdout.strip().splitlines()[-1])


def test_fleet_replicas_are_bit_identical_to_the_restored_registry(
        fleet_run):
    cache_dir, report = fleet_run
    a, b = report["replicas"]
    assert a["preds"] == b["preds"] and a["energies"] == b["energies"]
    assert a["n"] == 16 and a["compile_count"] == b["compile_count"] == 0
    assert a["device"] == "cpu"
    assert a["compile_cache"]["dir"] == str(cache_dir / "kernels")
    assert a["compile_cache"]["misses"] == 0   # no kernel build on the CPU
    registry = load_registry(str(cache_dir / "registry"), device="cpu")
    assert registry.get(a["models"][0]).cfg.spec == fleet.QUICK_NET
    imgs = bench.request_images("mnist", 16, seed=2026)
    responses, _ = fleet.serve_requests(registry, imgs, BUCKETS)
    assert a["preds"] == [r.pred for r in responses]
    assert a["energies"] == [float(np.float32(r.energy_j))
                             for r in responses]


def test_fleet_timeout_kills_the_fleet_and_exits_124(fleet_run):
    cache_dir, _ = fleet_run
    proc = _fleet(cache_dir, "--device", "cpu", "--timeout", "0.01")
    assert proc.returncode == 124, proc.stderr[-3000:]
    assert "exceeded --timeout" in proc.stderr


def test_fleet_worker_without_a_gpu_fails(fleet_run):
    """No ``--device cpu`` and no card: the replicas refuse to serve (the
    checkpoint exists, so only the workers run) and the fleet fails."""
    cache_dir, _ = fleet_run
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _fleet(cache_dir, "--timeout", "200", env=env)
    assert proc.returncode not in (0, 124), proc.stdout[-2000:]
    assert "device='cpu'" in proc.stderr
