"""The port's static plan and building blocks against the JAX reference.

Every comparison here is exact: plans field by field, AE formats, TTFS
rasters, occupancy/keep/span maps, quantized weights, pooling, the fire
functions and the procedural datasets. Inputs are made with numpy from a
seed and handed to both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import aeq as jaeq
from repro.core import encoding as jenc
from repro.core import engine as jengine
from repro.core import neuron as jneuron
from repro.core import quantization as jquant
from repro.core import snn_layers as jlayers
from repro.data import synthetic as jsynth
from repro_torch import configs as tconfigs
from repro_torch.core import aeq as taeq
from repro_torch.core import encoding as tenc
from repro_torch.core import engine as tengine
from repro_torch.core import neuron as tneuron
from repro_torch.core import quantization as tquant
from repro_torch.core import snn_layers as tlayers
from repro_torch.data import synthetic as tsynth


def _plan_fields(plan):
    """A LayerPlan as nested plain tuples (AEFormat/ConvPlan are NamedTuples)."""
    return (plan.spec, plan.input_hw, plan.input_c, plan.compressed,
            plan.n_layers, tuple(tuple(cp) for cp in plan.convs),
            tuple(plan.out))


def test_paper_specs_copied():
    assert tconfigs.PAPER_SPECS == jconfigs.PAPER_SPECS


@pytest.mark.parametrize("name", sorted(jconfigs.PAPER_SPECS))
@pytest.mark.parametrize("compressed", [True, False])
def test_compile_plan_matches_field_by_field(name, compressed):
    d = jconfigs.PAPER_SPECS[name]
    pj = jengine.compile_plan(d["spec"], d["hw"], d["c"], compressed)
    pt = tengine.compile_plan(d["spec"], d["hw"], d["c"], compressed)
    assert _plan_fields(pt) == _plan_fields(pj)
    assert tengine.parse_spec(d["spec"]) == jengine.parse_spec(d["spec"])
    assert (tengine.layer_geometry(tengine.parse_spec(d["spec"]), d["hw"],
                                   d["c"])
            == jengine.layer_geometry(jengine.parse_spec(d["spec"]), d["hw"],
                                      d["c"]))


def test_cifar10_fallback_format():
    """The 10x10 CIFAR-10 stages hit the Eq. 7 fallback (no spare pattern)."""
    fmt = tenc.make_format(10, 3)
    assert (fmt.n_win, fmt.bits_coord, fmt.compressed, fmt.invalid_word) == (
        4, 2, False, 16)


@pytest.mark.parametrize("bad", ["", "32C3--10", "P2-10", "32C4-10",
                                 "32C3-10-P2", "32C3-P2-P2-10", "foo"])
def test_parse_spec_rejects_like_reference(bad):
    with pytest.raises(jengine.SpecError) as ej:
        jengine.parse_spec(bad)
    with pytest.raises(tengine.SpecError) as et:
        tengine.parse_spec(bad)
    assert str(et.value) == str(ej.value)


def test_make_format_pack_unpack_match():
    rng = np.random.default_rng(0)
    for width in range(1, 40):
        for kernel in (1, 3, 5):
            for compressed in (True, False):
                fj = jenc.make_format(width, kernel, compressed=compressed)
                ft = tenc.make_format(width, kernel, compressed=compressed)
                assert tuple(ft) == tuple(fj)
                assert tenc.word_nbytes(ft) == jenc.word_nbytes(fj)
                i = rng.integers(0, fj.n_win, 50).astype(np.int32)
                j = rng.integers(0, fj.n_win, 50).astype(np.int32)
                v = rng.random(50) < 0.7
                wj = np.asarray(jenc.pack_events(fj, i, j, v))
                wt = tenc.pack_events(ft, torch.from_numpy(i),
                                      torch.from_numpy(j), torch.from_numpy(v))
                np.testing.assert_array_equal(wt.numpy(), wj)
                for a, b in zip(tenc.unpack_events(ft, wt),
                                jenc.unpack_events(fj, wj)):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("T", [1, 3, 4])
def test_encode_ttfs_matches(T):
    rng = np.random.default_rng(T)
    img = rng.random((5, 7, 7, 3)).astype(np.float32)
    img[0, 0, 0, 0] = np.float32(0.1)           # exactly at theta
    want = np.asarray(jenc.encode_ttfs(jnp.asarray(img), T, 0.1))
    got = tenc.encode_ttfs(torch.from_numpy(img), T, 0.1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,k,depth", [(9, 3, 2), (10, 3, 5), (12, 3, 16),
                                        (32, 3, 64), (8, 5, 1), (7, 1, 20),
                                        (3, 3, 1)])
def test_occupancy_keep_span_match(hw, k, depth):
    fmt = jenc.make_format(hw, k)
    rng = np.random.default_rng(hw * k + depth)
    raster = (rng.random((2, 3, hw, hw, 4)) < 0.3).astype(np.float32)
    oj = np.asarray(jaeq.phase_occupancy(fmt, jnp.asarray(raster)))
    ot = taeq.phase_occupancy(tenc.make_format(hw, k), torch.from_numpy(raster))
    assert ot.dtype == torch.int32 and ot.is_contiguous()  # kernel input
    np.testing.assert_array_equal(ot.numpy(), oj)
    np.testing.assert_array_equal(
        taeq.segment_keep(ot, depth).numpy(),
        np.asarray(jaeq.segment_keep(jnp.asarray(oj), depth)))
    np.testing.assert_array_equal(
        taeq.span_map(tenc.make_format(hw, k), hw).numpy(),
        np.asarray(jaeq.span_map(fmt, hw)))


@pytest.mark.parametrize("bits", [4, 6, 8, 12])
def test_quantize_symmetric_matches(bits):
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(1152, 10)).astype(np.float32)
    qj, sj = jquant.quantize_symmetric(jnp.asarray(x), bits)
    qt, st = tquant.quantize_symmetric(torch.from_numpy(x), bits)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert qt.dtype == (torch.int8 if bits <= 8 else torch.int32)
    assert st.numpy() == np.asarray(sj)


@pytest.mark.parametrize("window,latch_once", [(2, True), (3, True),
                                               (3, False)])
def test_spike_maxpool_hwc_matches(window, latch_once):
    rng = np.random.default_rng(window)
    sp = (rng.random((10, 10, 4)) < 0.3).astype(np.float32)
    latch = rng.random((10 // window, 10 // window, 4)) < 0.3
    fj, lj = jlayers.spike_maxpool_hwc(jnp.asarray(sp), window,
                                       jnp.asarray(latch),
                                       latch_once=latch_once)
    ft, lt = tlayers.spike_maxpool_hwc(torch.from_numpy(sp), window,
                                       torch.from_numpy(latch),
                                       latch_once=latch_once)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_dense_conv_hwc_matches():
    rng = np.random.default_rng(3)
    x = (rng.random((9, 9, 3)) < 0.4).astype(np.float32)
    w = (rng.integers(-64, 64, (3, 3, 3, 5)) / 64).astype(np.float32)
    np.testing.assert_array_equal(
        tlayers.dense_conv_hwc(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jlayers.dense_conv_hwc(jnp.asarray(x), jnp.asarray(w))))


@pytest.mark.parametrize("mode", jneuron.MODES)
def test_fire_functions_match(mode):
    assert tneuron.MODES == jneuron.MODES
    rng = np.random.default_rng(len(mode))
    v = rng.normal(size=(6, 6, 4)).astype(np.float32)
    latch = rng.random((6, 6, 4)) < 0.3
    jm, tm = jneuron.get_neuron_model(mode), tneuron.get_neuron_model(mode)
    assert tm.pool_latch_once == jm.pool_latch_once
    for a, b in zip(tm.fire(torch.from_numpy(v), torch.from_numpy(latch),
                            torch.tensor(0.25)),
                    jm.fire(jnp.asarray(v), jnp.asarray(latch), 0.25)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["mnist", "svhn", "cifar10"])
def test_synthetic_datasets_identical(name):
    ij, lj = jsynth.DATASETS[name](6, seed=5)
    it, lt = tsynth.DATASETS[name](6, seed=5)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(lt, lj)
