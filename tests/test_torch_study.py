"""The port's staged Study API against the JAX package's, on the CPU.

The whole slice — train → convert → collect → price → report — on the
reference's own small study (``SMALL``, ``tests/test_study.py``). The
port's ``train`` draws a torch init, so its trained net differs from the
reference's; parity is held downstream of the reference's trained params,
carried across as the reference's own ``train_*.pkl`` payload through the
port's ``StudyCache(dir=...)`` (the keys are equal). From there the port
converts, collects and prices by itself, and its ``Report`` must equal the
reference's field by field: integer stats equal, SNN energies, latencies
and FPS/W bit-equal, accuracies and agreement equal — on ``dense``,
``queue_pallas`` and ``queue_sparse`` at ``weight_bits=8``.
"""
import glob
import os
import shutil

import numpy as np
import pytest
import torch

from repro import study as jstudy
from repro.configs import PAPER_SPECS
from repro.core.engine import SpecError as JSpecError
from repro.serve import bench as jbench
from repro_torch import study as tstudy
from repro_torch.core import comparison as tcomparison
from repro_torch.core.engine import SpecError as TSpecError
from repro_torch.serve import bench as tbench

from _report_compare import assert_reports_identical

pytestmark = pytest.mark.filterwarnings(
    "ignore:The given NumPy array is not writable")

SMALL_KW = dict(dataset="mnist", net="6C3-P2-8", input_hw=28, input_c=1,
                n_train=256, epochs=2, n_eval=48, eval_seed=99, n_calib=64,
                T=3, depth=64, mode="mttfs_cont", balance=True)
J_SMALL = jstudy.StudySpec(**SMALL_KW)
T_SMALL = tstudy.StudySpec(**SMALL_KW)
BACKENDS = [("dense", 8), ("queue_pallas", 8), ("queue_sparse", 8)]


@pytest.fixture(scope="module")
def ref_disk(tmp_path_factory):
    """The reference's SMALL train (and convert) artifacts on disk."""
    root = tmp_path_factory.mktemp("ref_cache")
    cache = jstudy.StudyCache(dir=str(root))
    trained = jstudy.train(J_SMALL, cache=cache)
    jstudy.convert(J_SMALL, trained, cache=cache)
    return root, trained


def _train_only_dir(ref_root, dst):
    """A cache dir holding only the reference's ``train_*.pkl``."""
    os.makedirs(dst, exist_ok=True)
    for f in glob.glob(os.path.join(ref_root, "train_*.pkl")):
        shutil.copy(f, dst)
    return str(dst)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,weight_bits", BACKENDS)
def test_run_equals_reference_from_its_trained_params(ref_disk, tmp_path,
                                                      backend, weight_bits):
    ref_root, _ = ref_disk
    jspec = J_SMALL.replace(backend=backend, weight_bits=weight_bits)
    tspec = T_SMALL.replace(backend=backend, weight_bits=weight_bits)
    want = jstudy.run(jspec, cache=jstudy.StudyCache(dir=str(ref_root)))

    tstudy.reset_stage_counts()
    cache = tstudy.StudyCache(dir=_train_only_dir(ref_root, tmp_path))
    got = tstudy.run(tspec, cache=cache, device="cpu")
    # the train stage came from the reference's pickle; the port converted
    # and collected by itself
    assert dict(tstudy.stage_counts) == {"convert": 1, "collect": 1}
    assert_reports_identical(got, want)
    assert got.spikes_per_sample.dtype == want.spikes_per_sample.dtype
    assert got.snn_energy_j.dtype == np.float32
    assert got.to_json() == want.to_json()
    assert got.summary_rows() == want.summary_rows()
    assert got.label() == want.label()


def test_collect_record_equals_reference(ref_disk, tmp_path):
    """The collect artifact itself: the eval images, the SNN logits to
    1e-6, the predictions and every stats field equal."""
    ref_root, _ = ref_disk
    jspec = J_SMALL.replace(backend="queue_pallas")
    tspec = T_SMALL.replace(backend="queue_pallas")
    jc = jstudy.collect(jspec, cache=jstudy.StudyCache(dir=str(ref_root)))
    cache = tstudy.StudyCache(dir=_train_only_dir(ref_root, tmp_path))
    tc = tstudy.collect(tspec, cache=cache, device="cpu")
    assert tc.key == jc.key
    np.testing.assert_array_equal(tc.images, np.asarray(jc.images))
    np.testing.assert_allclose(tc.snn_logits, jc.snn_logits, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tc.snn_pred, jc.snn_pred)
    for f in tstudy.StatsRecord._fields:
        a, b = getattr(tc.stats, f), getattr(jc.stats, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# cache: keys and disk payloads shared with the reference
# ---------------------------------------------------------------------------

def test_content_key_equals_reference(ref_disk):
    _, trained = ref_disk
    params_np = [{k: np.asarray(v) for k, v in p.items()}
                 for p in trained.params]
    params_t = [{k: torch.from_numpy(v.copy()) for k, v in p.items()}
                for p in params_np]
    imgs = np.asarray(trained.train_images[:16], np.float32)
    parts = ("convert-v1", J_SMALL.net, 28, 1, 99.0, True, None, 3.5e-3,
             {"b": 2, "a": [1, (2, 3)]}, np.int32(7))
    want = jstudy.content_key(trained.params, imgs, *parts)
    assert tstudy.content_key(params_t, torch.from_numpy(imgs), *parts) \
        == want
    assert tstudy.content_key(params_np, imgs, *parts) == want
    assert tstudy.from_params(params_t).key == \
        jstudy.from_params(trained.params).key
    assert tstudy.content_key(params_t, imgs[:8], *parts) != want


def test_train_pickles_are_interchangeable(ref_disk, tmp_path):
    """The reference's ``train_*.pkl`` loads in the port (no training runs,
    the params equal), and the port's loads in the reference."""
    ref_root, jtrained = ref_disk
    tstudy.reset_stage_counts()
    tcache = tstudy.StudyCache(dir=_train_only_dir(ref_root, tmp_path / "a"))
    t = tstudy.train(T_SMALL, cache=tcache, device="cpu")
    assert tstudy.stage_counts["train"] == 0 and t.key == jtrained.key
    for a, b in zip(t.params, jtrained.params):
        for k in b:
            assert a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))

    # the reverse: a port-trained net (its own torch init) saved by the
    # port, loaded by the reference under the same key
    spec_kw = dict(SMALL_KW, epochs=1, n_train=128)
    port_dir = str(tmp_path / "b")
    tt = tstudy.train(tstudy.StudySpec(**spec_kw),
                      cache=tstudy.StudyCache(dir=port_dir), device="cpu")
    assert tstudy.stage_counts["train"] == 1
    jstudy.reset_stage_counts()
    jt = jstudy.train(jstudy.StudySpec(**spec_kw),
                      cache=jstudy.StudyCache(dir=port_dir))
    assert jstudy.stage_counts["train"] == 0 and jt.key == tt.key
    for a, b in zip(tt.params, jt.params):
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


def test_convert_pickles_are_interchangeable(ref_disk):
    """The reference's ``convert_*.pkl`` (same key) loads in the port."""
    ref_root, jtrained = ref_disk
    jconv = jstudy.convert(J_SMALL, jtrained,
                           cache=jstudy.StudyCache(dir=str(ref_root)))
    tstudy.reset_stage_counts()
    cache = tstudy.StudyCache(dir=str(ref_root))
    tconv = tstudy.convert(T_SMALL, cache=cache, device="cpu")
    assert dict(tstudy.stage_counts) == {} and tconv.key == jconv.key
    for a, b in zip(tconv.snn_params, jconv.snn_params):
        for k in b:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    assert [t.item() for t in tconv.thresholds] == \
        [float(t) for t in jconv.thresholds]


def test_port_convert_equals_reference_artifact(ref_disk, tmp_path):
    """The port's own conversion of the reference's params: the same key,
    and the reference's balanced thresholds."""
    ref_root, jtrained = ref_disk
    jconv = jstudy.convert(J_SMALL, jtrained,
                           cache=jstudy.StudyCache(dir=str(ref_root)))
    cache = tstudy.StudyCache(dir=_train_only_dir(ref_root, tmp_path))
    tconv = tstudy.convert(T_SMALL, cache=cache, device="cpu")
    assert tconv.key == jconv.key
    assert [t.item() for t in tconv.thresholds] == \
        [float(t) for t in jconv.thresholds]
    for a, b in zip(tconv.snn_params, jconv.snn_params):
        for k in b:
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=1e-5)


def test_collect_memory_tier_is_lru_bounded():
    cache = tstudy.StudyCache(mem_caps={"collect": 2})
    for i in range(3):
        cache.get_or_build("collect", f"k{i}", lambda i=i: i)
    cache.get_or_build("collect", "k1", lambda: "rebuilt?")  # hit: refreshes
    cache.get_or_build("collect", "k3", lambda: 3)           # evicts k2
    assert [k for kind, k in cache._mem if kind == "collect"] == ["k1", "k3"]
    assert cache.get_or_build("collect", "k1", lambda: "rebuilt?") == 1
    for i in range(5):
        cache.get_or_build("train", f"t{i}", lambda i=i: i)
    assert sum(1 for kind, _ in cache._mem if kind == "train") == 5


def test_default_cache_reads_the_reference_variable(tmp_path):
    """``DEFAULT_CACHE`` sits where ``REPRO_STUDY_CACHE`` points, as the
    reference's does (read at import, so in a fresh interpreter)."""
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    out = subprocess.run(
        [sys.executable, "-c", "from repro_torch.study import DEFAULT_CACHE;"
         " print(DEFAULT_CACHE.dir)"],
        capture_output=True, text=True, timeout=300, check=True,
        env=dict(os.environ, PYTHONPATH=os.path.abspath(src),
                 REPRO_STUDY_CACHE=str(tmp_path)))
    assert out.stdout.strip() == str(tmp_path)


# ---------------------------------------------------------------------------
# the pricing sweep: one train, one convert, one collect
# ---------------------------------------------------------------------------

def test_pricing_sweep_runs_each_stage_once():
    variants = [
        dict(compressed=True, vmem_resident=True),
        dict(compressed=True, vmem_resident=False),
        dict(compressed=False, vmem_resident=False),
        dict(weight_bits=4),
    ]
    tstudy.reset_stage_counts()
    cache = tstudy.StudyCache()
    reports = tstudy.sweep(T_SMALL, variants, cache=cache, device="cpu")
    assert dict(tstudy.stage_counts) == {"train": 1, "convert": 1,
                                         "collect": 1}
    # the variants reprice one record: spikes equal, energies move
    for r in reports[1:]:
        np.testing.assert_array_equal(r.spikes_per_sample,
                                      reports[0].spikes_per_sample)
    assert np.all(reports[1].snn_energy_j > reports[0].snn_energy_j)
    assert reports[3].spec.weight_bits == 4
    rows = tstudy.sweep_rows(reports)
    assert len(rows) == 4 and len({r[0] for r in rows}) == 4
    jrows = jstudy.sweep_rows(reports)
    assert rows == jrows

    # a depth change re-collects but converts once
    tstudy.reset_stage_counts()
    tstudy.run(T_SMALL.replace(depth=16), cache=cache, device="cpu")
    assert dict(tstudy.stage_counts) == {"collect": 1}


def test_run_study_shim_warns_and_equals_run_with_data(ref_disk):
    _, jtrained = ref_disk
    params = [{k: np.asarray(v) for k, v in p.items()}
              for p in jtrained.params]
    images, labels = J_SMALL.load_eval()
    calib = np.asarray(jtrained.train_images[:64])
    with pytest.deprecated_call():
        shim = tcomparison.run_study(
            params, SMALL_KW["net"], "mnist", images, labels, calib, T=3,
            depth=64, device="cpu")
    direct = tstudy.run_with_data(
        tstudy.StudySpec(dataset="mnist", net=SMALL_KW["net"], input_hw=28,
                         input_c=1, n_eval=48, n_calib=64, T=3, depth=64),
        params, images, labels, calib, cache=tstudy.StudyCache(),
        device="cpu")
    assert_reports_identical(shim, direct)
    assert shim.spec is not None
    want = jstudy.run_with_data(J_SMALL.replace(n_eval=48), jtrained.params,
                                images, labels, calib,
                                cache=jstudy.StudyCache())
    assert_reports_identical(direct, want)
    with pytest.deprecated_call() as caught:
        queued = tcomparison.run_study(
            params, SMALL_KW["net"], "mnist", images[:4], labels[:4], calib,
            T=3, depth=64, use_queues=True, balance=False, device="cpu")
    assert any("use_queues" in str(w.message) for w in caught)
    assert queued.spec.backend == "queue"


def test_convert_requires_calib_for_caller_params(ref_disk):
    _, jtrained = ref_disk
    params = [{k: np.asarray(v) for k, v in p.items()}
              for p in jtrained.params]
    with pytest.raises(ValueError, match="calib_images"):
        tstudy.convert(T_SMALL, tstudy.from_params(params), device="cpu")


# ---------------------------------------------------------------------------
# direct training through collect and run
# ---------------------------------------------------------------------------

def test_direct_training_raises_not_implemented_naming_a6():
    """``training="direct"`` runs: ``collect`` trains the SNN on the device
    it is given (the CPU here, with no card) through ``train_snn``, once
    per cache, and ``run`` then trains the CNN baseline, reuses the trained
    SNN and its collect, and prices them."""
    spec = T_SMALL.replace(training="direct", n_train=64, snn_epochs=1,
                           snn_batch=32)
    tstudy.reset_stage_counts()
    cache = tstudy.StudyCache()
    col = tstudy.collect(spec, cache=cache, device="cpu")
    assert dict(tstudy.stage_counts) == {"train_snn": 1, "collect": 1}
    snn = tstudy.train_snn(spec, cache=cache, device="cpu")
    assert snn.snn_params[0]["w"].device.type == "cpu"
    report = tstudy.run(spec, cache=cache, device="cpu")
    assert dict(tstudy.stage_counts) == {"train_snn": 1, "collect": 1,
                                         "train": 1}
    assert report.snn_energy_j.shape == (spec.n_eval,)
    np.testing.assert_array_equal(
        report.spikes_per_sample, col.stats.spikes_out.sum(-1, dtype=np.int32))


# ---------------------------------------------------------------------------
# StudySpec: the reference's named errors and defaults
# ---------------------------------------------------------------------------

ERRORS = [
    (dict(backend="verilog"), "UnknownBackendError"),
    (dict(mode="lif_nope"), "UnknownNeuronModeError"),
    (dict(input_mode="rate"), "UnknownInputModeError"),
    (dict(T=0), "StudySpecError"),
    (dict(depth=-4), "StudySpecError"),
    (dict(n_eval=0), "StudySpecError"),
    (dict(batch=1.5), "StudySpecError"),
    (dict(training="distill"), "StudySpecError"),
    (dict(surrogate="heaviside"), "StudySpecError"),
    (dict(loss_target="ttfs"), "StudySpecError"),
    (dict(snn_epochs=0), "StudySpecError"),
    (dict(snn_batch=-1), "StudySpecError"),
    (dict(weight_bits=0), "StudySpecError"),
    (dict(dataset=""), "UnknownDatasetError"),
]


@pytest.mark.parametrize("changes,err", ERRORS)
def test_spec_named_errors_match_reference(changes, err):
    kw = dict(dataset="mnist", net="6C3-P2-8", input_hw=28, input_c=1)
    kw.update(changes)
    with pytest.raises(getattr(jstudy, err)) as want:
        jstudy.StudySpec(**kw)
    with pytest.raises(getattr(tstudy, err)) as got:
        tstudy.StudySpec(**kw)
    assert str(got.value) == str(want.value)
    assert issubclass(getattr(tstudy, err), ValueError)


@pytest.mark.parametrize("net", ["6C4-8", "6C31-8"])
def test_spec_bad_net_is_spec_error(net):
    with pytest.raises(JSpecError):
        jstudy.StudySpec(dataset="mnist", net=net, input_hw=28, input_c=1)
    with pytest.raises(TSpecError):
        tstudy.StudySpec(dataset="mnist", net=net, input_hw=28, input_c=1)


def test_spec_unknown_dataset_named_error():
    with pytest.raises(tstudy.UnknownDatasetError, match="imagenet"):
        tstudy.StudySpec(dataset="imagenet")
    spec = tstudy.StudySpec(dataset="my-variant", net="6C3-P2-8",
                            input_hw=28, input_c=1)
    with pytest.raises(tstudy.UnknownDatasetError, match="my-variant"):
        spec.load_eval()
    with pytest.raises(tstudy.UnknownDatasetError, match="my-variant"):
        tstudy.train(spec, device="cpu")


@pytest.mark.parametrize("dataset", sorted(PAPER_SPECS))
def test_spec_defaults_resolve_from_paper_specs(dataset):
    got, want = tstudy.StudySpec(dataset=dataset), jstudy.StudySpec(
        dataset=dataset)
    meta = PAPER_SPECS[dataset]
    assert (got.net, got.input_hw, got.input_c) == (meta["spec"], meta["hw"],
                                                     meta["c"])
    import dataclasses

    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert hash(got) == hash(dataclasses.replace(got))
    assert got.replace(compressed=False) != got
    assert got.snn_config()._asdict() == want.snn_config()._asdict()
    assert got.pricing_label() == want.pricing_label()
    for backend in ("dense", "queue_sparse", "queue_ref"):
        assert got.replace(backend=backend).executed_weight_bits() == \
            want.replace(backend=backend).executed_weight_bits()
    a, b = got.load_eval(), want.load_eval()
    np.testing.assert_array_equal(a[0], b[0])


# ---------------------------------------------------------------------------
# serving the study's net
# ---------------------------------------------------------------------------

def test_register_study_serves_the_converted_net_bit_exact():
    """build_runtime(spec, trained=True): register_study trains and
    converts through the stages (once, shared cache), the handle serves
    exactly the convert artifact, and per-request energies equal a
    one-shot infer_batch + price_record and a one-shot collect + price."""
    spec = tbench.serve_spec("mnist").replace(
        net="6C3-P2-8", n_train=128, epochs=1, n_calib=32, n_balance=16,
        T=3, depth=16)
    assert spec.backend == "queue_pallas" and spec.batch == 64
    jspec = jbench.serve_spec("mnist")
    assert tbench.serve_spec("mnist") == tstudy.StudySpec(
        **{f: getattr(jspec, f) for f in ("dataset", "depth", "T", "batch",
                                           "mode", "backend")})
    tstudy.reset_stage_counts()
    cache = tstudy.StudyCache()
    rt, name = tbench.build_runtime(spec, (1, 4), trained=True, cache=cache,
                                    device="cpu")
    h = rt.registry.get(name)
    assert name == "mnist-queue_pallas" and h.compile_count == 2
    converted = tstudy.convert(spec, cache=cache, device="cpu")
    assert h.source_key == converted.key
    assert dict(tstudy.stage_counts) == {"train": 1, "convert": 1}
    for a, b in zip(h.params, converted.snn_params):
        for k in b:
            assert torch.equal(a[k], b[k])
    assert [t.item() for t in h.thresholds] == \
        [t.item() for t in converted.thresholds]
    imgs = tbench.request_images("mnist", 7)
    res = tbench.closed_loop(rt, name, imgs)
    parity = tbench.verify_energy_parity(rt, name, imgs, res.responses)
    assert parity["elementwise_bitexact"] and parity["sum_bitexact"]
    collected = tstudy.collect(spec, converted, images=imgs,
                               cache=tstudy.StudyCache(), device="cpu")
    one_shot = tstudy.price_record(collected.stats, input_hw=28)
    np.testing.assert_array_equal(tbench.energy_array(res.responses),
                                  one_shot.total_j.numpy())
    # a second runtime over the same cache trains nothing more
    tbench.build_runtime(spec, (1,), trained=True, cache=cache, device="cpu")
    assert dict(tstudy.stage_counts) == {"train": 1, "convert": 1,
                                         "collect": 1}


def test_bench_cli_trained_on_the_cpu(capsys, monkeypatch):
    """``python -m repro_torch.serve.bench --trained --verify`` on the CPU
    (the study's recipe cut to a small train set for the test)."""
    real = tbench.serve_spec
    monkeypatch.setattr(tbench, "serve_spec", lambda *a, **k: real(
        *a, **k).replace(net="6C3-P2-8", n_train=128, epochs=1, n_calib=32,
                         n_balance=16))
    tstudy.reset_stage_counts()
    tbench.main(["--quick", "--verify", "--mode", "closed", "--trained",
                 "--device", "cpu", "--buckets", "1,4,16"])
    out = capsys.readouterr().out
    assert "trained" in out and "device=cpu" in out
    assert "'elementwise_bitexact': True, 'sum_bitexact': True" in out
    assert dict(tstudy.stage_counts) == {"train": 1, "convert": 1}
