"""The port's launch tooling (``repro_torch.launch``) against the JAX
package's (``repro.launch``).

- ``costs``: pure arithmetic, so ``cell_cost`` and its helpers equal the
  reference's exactly, for every FULL configuration x every shape x the
  knobs of ``tests/test_dryrun_tools.py::test_mesh_knobs``, the
  ``dp_only`` profile, ``moe_ep`` and two pods.
- the HLO text helpers: equal to the reference's on
  ``test_dryrun_tools.py``'s strings and on the HLO text of a small
  ``jax.jit`` compile.
- ``build_cell`` on two smokes at every shape: the shardings it records
  equal the reference's ``spec_for`` over a stub of the same mesh; its
  traced FLOPs lie within [1.0, 2.1] x the analytic model's total and above
  ``model_flops`` (the trace counts every capacity slot, the remat
  recompute, and attention's whole S x S score blocks where the analytic
  model halves them for causality: at the smokes' width attention
  dominates, ~2x; at moe-14b's ~1.5x); the constrain
  calls are the forward's, once per microbatch, plus the remat recompute's.
- ``mesh``: the virtual production mesh and the host mesh.
"""
import dataclasses
import itertools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import costs as jcosts
from repro.models import model as JM
from repro.sharding import resolver as jres
from repro.training import train_loop as JTL
from repro_torch import configs
from repro_torch.launch import costs, dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

from _smoke_archs import FULL, SMOKES
from _torch_archs import TORCH_FULL, TORCH_SMOKES

KNOBS = [dict(), dict(dp=16, tp=16, microbatches=8),
         dict(dp=64, tp=4, microbatches=2), dict(profile="dp_only"),
         dict(moe_ep=True), dict(multi_pod=True),
         dict(multi_pod=True, profile="dp_only", remat_factor=1.0)]


def test_configs_equal_the_reference():
    from repro import configs as jconfigs

    assert configs.SHAPES == jconfigs.SHAPES
    assert configs.PAPER_SPECS == jconfigs.PAPER_SPECS
    for arch, cfg in FULL.items():
        for shape in configs.SHAPES:
            assert configs.shape_applicable(TORCH_FULL[arch], shape) == \
                jconfigs.shape_applicable(cfg, shape)
    for fn, jfn in ((configs.get, jconfigs.get),
                    (configs.get_smoke, jconfigs.get_smoke)):
        with pytest.raises(LookupError) as ours:
            fn("dense-7b")
        with pytest.raises(LookupError) as theirs:
            jfn("dense-7b")
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: ",".join(
    f"{a}={b}" for a, b in k.items()) or "default")
@pytest.mark.parametrize("arch", sorted(FULL))
def test_cell_cost_equals_the_reference_exactly(arch, knobs):
    for shape in configs.SHAPES:
        got = costs.cell_cost(arch, shape, cfg=TORCH_FULL[arch], **knobs)
        want = jcosts.cell_cost(arch, shape, cfg=FULL[arch], **knobs)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), shape


@pytest.mark.parametrize("arch", sorted(FULL))
def test_cost_helpers_equal_the_reference_exactly(arch):
    t, j = TORCH_FULL[arch], FULL[arch]
    assert costs.active_params(t) == jcosts.active_params(j)
    assert costs.nonemb_active_params(t) == jcosts.nonemb_active_params(j)
    assert costs.active_paramsbytes(t) == jcosts.active_paramsbytes(j)
    for n, train in itertools.product((1, 4096, 32 * 32768), (True, False)):
        assert costs.model_flops(t, n, train=train) == \
            jcosts.model_flops(j, n, train=train)


def test_cell_cost_requires_cfg():
    with pytest.raises(ValueError, match="pass cfg= explicitly"):
        costs.cell_cost("dense-20b", "train_4k")
    with pytest.raises(ValueError, match="pass cfg= explicitly"):
        dryrun.build_cell("dense-20b", "train_4k", multi_pod=False)


# ---------------------------------------------------------------------------
# HLO text helpers
# ---------------------------------------------------------------------------

HLO_TUPLE = """
HloModule m

ENTRY %main (p: f32[8]) -> f32[8] {
  %ar = (f32[4,4]{1,0}, f32[8]{0}) all-reduce-start(%a, %b), replica_groups={}
  %ar.d = (f32[4,4]{1,0}, f32[8]{0}) all-reduce-done(%ar)
  %ag = f32[16,2]{1,0} all-gather(%c), dimensions={0}
}
"""
HLO_LOOP = """
HloModule m

%cond.1 (s: s32[]) -> pred[] {
  %c = s32[] constant(7)
  ROOT %lt = pred[] compare(%s, %c), direction=LT
}

%body.1 (s: s32[]) -> s32[] {
  %ar = f32[10]{0} all-reduce(%x), replica_groups={}
  ROOT %n = s32[] add(%s, %one)
}

ENTRY %main (p: s32[]) -> s32[] {
  %w = s32[] while(%p), condition=%cond.1, body=%body.1
  %ag = f32[5]{0} all-gather(%q), dimensions={0}
}
"""


def _jdryrun():
    """The reference's dry-run module. Importing it sets ``XLA_FLAGS`` to
    force 512 host devices (too late for this process's jax); the
    variable is put back so no process this test run starts inherits
    it."""
    prev = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun

    if prev is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = prev
    return jdryrun


def _compiled_text():
    def f(x):
        return jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=10)[0]

    return jax.jit(f).lower(jnp.ones((16, 16))).compile().as_text()


@pytest.mark.parametrize("text", ["f32[16,128]",
                                  "(f32[4,768,192]{2,1,0}, f32[3072]{0})",
                                  "bf16[2,2]", "pred[]", "s8[3,5] u64[2]",
                                  HLO_TUPLE, HLO_LOOP])
def test_shape_bytes_equals_the_reference(text):
    assert dryrun._shape_bytes(text) == _jdryrun()._shape_bytes(text)


def test_hlo_helpers_equal_the_reference():
    jd = _jdryrun()
    assert dryrun._shape_bytes("f32[16,128]") == 16 * 128 * 4
    assert dryrun.collective_bytes(HLO_TUPLE) == {
        "all-reduce": 4 * 4 * 4 + 8 * 4, "all-gather": 16 * 2 * 4}
    comps, entry = dryrun._parse_computations(HLO_LOOP)
    assert dryrun._loop_multipliers(comps, entry)["%body.1"] == 7.0
    for text in (HLO_TUPLE, HLO_LOOP, _compiled_text()):
        assert dryrun._parse_computations(text) == \
            jd._parse_computations(text)
        comps, entry = dryrun._parse_computations(text)
        assert dryrun._loop_multipliers(comps, entry) == \
            jd._loop_multipliers(comps, entry)
        assert dryrun.collective_bytes(text) == jd.collective_bytes(text)
    comps, entry = dryrun._parse_computations(_compiled_text())
    assert 10.0 in dryrun._loop_multipliers(comps, entry).values()


def test_batch_axes_for_equals_the_reference():
    specs = {"tokens": torch.empty((4, 8), device="meta"),
                        "labels": torch.empty((4, 8), device="meta"),
                        "embeddings": torch.empty((4, 8, 16), device="meta"),
                        "flag": torch.empty((4,), device="meta")}
    jspecs = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
              for k, v in specs.items()}
    assert dryrun.batch_axes_for(specs) == _jdryrun().batch_axes_for(jspecs)


def test_machine_constants_are_the_h100s():
    assert dryrun.PEAK_BF16 == 989e12 and dryrun.HBM_BW == 3.35e12
    assert dryrun.COLL_BW == 50e9
    terms = dryrun.roofline(989e12, 3.35e12, 50e9)
    assert terms == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}


# ---------------------------------------------------------------------------
# build_cell
# ---------------------------------------------------------------------------

def _ref_specs(cfg, shape_name, mesh_shape):
    """The reference's specs of what its build_cell shards, through its
    ``spec_for`` over a stub mesh: params (prefill, decode), the train
    state (train), the caches (decode) and the batch."""
    shape = configs.SHAPES[shape_name]
    r = jres.Resolver(SimpleNamespace(shape=mesh_shape))
    captured = {}

    def init(k):
        p, a = JM.init_model(k, cfg)
        captured["axes"] = a
        return p

    params = jax.eval_shape(init, jax.random.PRNGKey(0))
    axes = captured["axes"]

    def specs(tree, ax):
        return jres.map_with_axes(
            lambda leaf, a: SimpleNamespace(spec=r.spec_for(leaf.shape, a)),
            tree, ax)

    batch = JM.input_specs(cfg, shape_name, batch=shape["batch"],
                           seq=shape["seq"])
    out = {"batch": specs(batch, _jdryrun().batch_axes_for(batch))}
    if shape["kind"] == "train":
        state = jax.eval_shape(JTL.init_state, params)
        out["state"] = specs(state, JTL.state_axes(axes))
    else:
        out["params"] = specs(params, axes)
    if shape["kind"] == "decode":
        out["caches"] = specs(JM.cache_specs(cfg, shape["batch"],
                                             shape["seq"]), JM.cache_axes(cfg))
    return {k: dryrun._specs(v) for k, v in out.items()}


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["moe", "dense-tied"])
def test_build_cell_on_smokes(arch, shape_name):
    cfg, tcfg = SMOKES[arch], TORCH_SMOKES[arch]
    rec = dryrun.build_cell(arch, shape_name, cfg=tcfg, multi_pod=False)
    if shape_name == "long_500k":     # full attention: skipped as there
        assert rec == {"arch": arch, "shape": shape_name,
                       "skipped": configs.shape_applicable(tcfg,
                                                           shape_name)[1]}
        return
    assert rec["n_chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["shardings"] == _ref_specs(cfg, shape_name,
                                          {"data": 16, "model": 16})
    shape = configs.SHAPES[shape_name]
    ac = costs.cell_cost(arch, shape_name, cfg=tcfg,
                         moe_ep=bool(tcfg.moe and tcfg.moe.e_pad % 16 == 0))
    traced = rec["per_device"]["traced_flops"]
    assert 1.0 <= traced / ac.flops_device <= 2.1, traced / ac.flops_device
    assert traced >= rec["model_flops_per_device"]
    assert rec["per_device"]["collective_bytes"] == ac.coll_bytes_device
    assert rec["roofline_terms_s"]["compute_s"] == traced / dryrun.PEAK_BF16
    assert rec["bottleneck"] in rec["roofline_terms_s"]
    n_blocks = 2 * tcfg.n_layers
    per_forward = 2 + n_blocks
    if shape["kind"] == "train":
        assert rec["constrain_calls"] == tcfg.microbatches * per_forward
    else:
        assert rec["constrain_calls"] == n_blocks
    assert sum(d["count"] for d in rec["constrain_distinct"]) == \
        rec["constrain_calls"]
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert "generated_code_size_in_bytes" not in rec["memory_analysis"]


def test_build_cell_knobs_and_multi_pod():
    tcfg = TORCH_SMOKES["moe"]
    rec = dryrun.build_cell("moe", "decode_32k", cfg=tcfg, multi_pod=True,
                            profile="dp_only", dp=4, tp=2,
                            overrides={"microbatches": 2})
    assert rec["mesh"] == "2x4x2" and rec["n_chips"] == 16
    assert rec["knobs"] == {"dp": 4, "tp": 2, "profile": "dp_only",
                            "microbatches": 2, "dp_shard_map": False}
    # dp_only replicates every parameter
    assert all(all(e is None for e in spec)
               for spec in rec["shardings"]["params"].values())
    un = dryrun.build_cell("moe", "train_4k", cfg=tcfg, multi_pod=False,
                           unroll=True)
    assert un["unrolled"] and un["knobs"]["microbatches"] == 1


def test_production_and_host_meshes():
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.devices.size == 256
    assert {str(d) for d in m.devices.flat} == {"meta"}
    p = make_production_mesh(multi_pod=True, dp=4, tp=8, device="cpu")
    assert list(p.shape.items()) == [("pod", 2), ("data", 4), ("model", 8)]
    h = make_host_mesh("cpu")
    assert h.shape == {"data": 1, "model": 1}
    assert h.devices[0, 0] == torch.device("cpu")


def test_host_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()


def test_main_is_the_retired_stub(capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main()
    assert e.value.code == 0
    assert "build_cell" in capsys.readouterr().out
