"""The port's sweep runner (``repro_torch.study.sweep``) on the CPU, held
against the JAX package's.

The cases of ``tests/test_sweep.py`` at its small sizes, run on a 4-way
virtual CPU mesh where the reference runs on its mesh (``_mesh()``), so the
sharded collect is exercised: a killed sweep resumes with **zero
recomputation** (cell checkpoints, the disk cache and the stage counters),
the consolidated report and grid, ``cell_shard``, ``cell_id``, the grid's
shape, the callable-module shim, the CLI, the direct axis and its pairing
section. Then against the reference:

- ``cell_id`` equal for the same specs, ``paper_grid`` equal field for
  field, and ``markdown_grid`` / ``_pair_trainings`` equal on the same
  cells;
- one small grid run in both packages over a shared train/convert cache
  (the two packages' pickles are interchangeable): the port collects and
  prices on its own, and its cell reports equal the reference's (integers
  exactly, floats to 1e-6 relative), its markdown grid the reference's.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from repro import study as jstudy
from repro.study import sweep as jsweep
from repro_torch import parallel
from repro_torch.study import (StudyCache, StudySpec, reset_stage_counts,
                               stage_counts)
from repro_torch.study.sweep import (cell_id, markdown_grid, paper_grid,
                                     run_sweep)

pytestmark = pytest.mark.filterwarnings(
    "ignore:The given NumPy array is not writable")

BASE_KW = dict(dataset="mnist", net="6C3-P2-8", input_hw=28, input_c=1,
               n_train=96, epochs=1, train_batch=48, n_eval=16, n_calib=24,
               n_balance=12, T=2, depth=32, batch=8)
# tiny-but-real: one conv + fused pool + classifier, procedural mnist
BASE = StudySpec(**BASE_KW)
MESH = parallel.DataMesh(("cpu",) * 4)


def _cells(base=BASE):
    """6 cells, 2 collect groups: 4 pricing variants + 2 at another depth."""
    pricing = [base.replace(compressed=c, vmem_resident=v)
               for c in (True, False) for v in (True, False)]
    return pricing + [c.replace(depth=16) for c in pricing[:2]]


def _run(cells, **kw):
    kw.setdefault("log", lambda *_: None)
    return run_sweep(cells, device="cpu", **kw)


@pytest.fixture
def dirs(tmp_path):
    return str(tmp_path / "out"), str(tmp_path / "cache")


def test_killed_sweep_resumes_with_zero_recomputation(dirs):
    out, cache_dir = dirs
    cells = _cells()

    # phase 1: "kill" after one executed cell
    reset_stage_counts()
    s1 = _run(cells, out_dir=out, cache_dir=cache_dir, mesh=MESH,
              max_cells=1)
    assert s1["executed"] == 1 and not s1["complete"]
    assert dict(stage_counts) == {"train": 1, "convert": 1, "collect": 1}

    # phase 2: a fresh process simulated by a cold-memory cache over the
    # same dirs: the finished cell loads from its checkpoint, its pricing
    # siblings from the DISK collect; only the depth=16 group collects
    reset_stage_counts()
    s2 = _run(cells, out_dir=out, cache_dir=cache_dir, mesh=MESH)
    assert s2["resumed"] == 1 and s2["complete"]
    assert stage_counts["train"] == 0
    assert stage_counts["convert"] == 0
    assert stage_counts["collect"] == 1

    # third run: pure resume, nothing executes at all
    reset_stage_counts()
    s3 = _run(cells, out_dir=out, cache_dir=cache_dir, mesh=MESH)
    assert s3["resumed"] == len(cells) and s3["executed"] == 0
    assert dict(stage_counts) == {}


def test_consolidated_report_and_grid(dirs):
    out, cache_dir = dirs
    cells = _cells()[:2]
    summary = _run(cells, out_dir=out, cache_dir=cache_dir, mesh=MESH)
    assert summary["complete"] and summary["n_completed"] == 2

    with open(summary["report_path"]) as f:
        report = json.load(f)
    assert report["schema"] == "sweep-v1"
    assert [c["cell_id"] for c in report["cells"]] == \
        [cell_id(s) for s in cells]
    for cell in report["cells"]:
        assert cell["spec"]["dataset"] == "mnist"
        assert 0.0 <= cell["report"]["snn_acc"] <= 1.0
    timing = report["timing"]
    assert timing["total_s"] == pytest.approx(
        sum(c["elapsed_s"] for c in report["cells"]))
    assert set(timing["by_cell"]) == {cell_id(s) for s in cells}

    md = markdown_grid(report["cells"])
    assert md.count("| mnist |") == 2
    assert "VMEM" in md and "HBM" in md
    with open(summary["grid_path"]) as f:
        assert f.read() == md


def test_cell_shard_partitions_and_last_worker_consolidates(dirs):
    out, cache_dir = dirs
    cells = _cells()[:4]
    cache = StudyCache(dir=cache_dir,
                       disk_kinds=("train", "convert", "collect"))
    s0 = _run(cells, out_dir=out, cache=cache, cell_shard=(0, 2))
    assert not s0["complete"] and s0["executed"] == 2
    s1 = _run(cells, out_dir=out, cache=cache, cell_shard=(1, 2))
    assert s1["complete"] and s1["executed"] == 2   # disjoint halves
    assert {c["cell_id"] for c in s1["cells"]} == \
        {cell_id(s) for s in cells}
    with pytest.raises(ValueError, match="cell_shard"):
        _run(cells, out_dir=out, cache=cache, cell_shard=(2, 2))


def test_sharded_sweep_rows_equal_unsharded(dirs):
    """The same cells swept on a 2-way mesh and on one device, each
    collecting for itself over shared train/convert artifacts: the cell
    rows are equal, ``elapsed_s`` aside."""
    out, cache_dir = dirs
    cells = _cells()[:2]
    rows = {}
    for name, mesh in (("one", None), ("mesh", parallel.DataMesh(("cpu",) * 2))):
        cache = StudyCache(dir=cache_dir, disk_kinds=("train", "convert"))
        reset_stage_counts()
        s = _run(cells, out_dir=os.path.join(out, name), cache=cache,
                 mesh=mesh, fresh=True)
        assert stage_counts["collect"] == 1
        rows[name] = [{k: v for k, v in r.items() if k != "elapsed_s"}
                      for r in s["cells"]]
    assert rows["one"] == rows["mesh"]


def test_cell_id_is_content_keyed():
    assert cell_id(BASE) == cell_id(BASE.replace())
    assert cell_id(BASE) != cell_id(BASE.replace(compressed=False))
    assert cell_id(BASE) != cell_id(BASE.replace(depth=16))


def test_paper_grid_shape():
    full = paper_grid()
    assert len(full) == 3 * 2 * 8            # datasets x backends x pricing
    assert {s.dataset for s in full} == {"mnist", "svhn", "cifar10"}
    assert {s.backend for s in full} == {"dense", "queue_pallas"}
    pairs = [(s.dataset, s.backend) for s in full]
    assert pairs == sorted(pairs, key=pairs.index)

    quick = paper_grid(quick=True)
    assert len(quick) == 3 * 1 * 2 and all(s.epochs == 1 for s in quick)
    custom = paper_grid(datasets=("mnist",), backends=("dense",),
                        pricing=((True, True, 8),),
                        overrides=dict(n_eval=8))
    assert len(custom) == 1 and custom[0].n_eval == 8


def test_study_sweep_name_shadowing_is_resolved(monkeypatch):
    """``study.sweep(base, variants)`` keeps working though the runner
    module shadows the stage helper on the package attribute."""
    import repro_torch.study as study
    import repro_torch.study.sweep  # noqa: F401, the submodule import

    assert callable(study.sweep)
    assert study.sweep is repro_torch.study.sweep
    assert study.sweep(BASE, [], device="cpu") == []   # empty: no work
    # delegation is late-bound: patching stages.sweep shows through
    monkeypatch.setattr(study.stages, "sweep",
                        lambda base, variants, cache=None, device=None:
                        ("delegated", device))
    assert study.sweep(BASE, [dict()], device="cpu") == ("delegated", "cpu")


@pytest.mark.parametrize("mesh_arg", [[], ["--mesh", "2"]],
                         ids=["one_device", "virtual_mesh"])
def test_cli_main_smoke(dirs, capsys, mesh_arg):
    """``python -m repro_torch.study.sweep`` end to end on a 1-cell grid on
    the CPU, unsharded and on a virtual 2-way CPU mesh."""
    from repro_torch.study.sweep import main

    out, cache_dir = dirs
    argv = ["--quick", "--datasets", "mnist", "--backends", "dense",
            "--out", out, "--cache", cache_dir, "--device", "cpu"] + mesh_arg
    assert main(argv) == 0
    assert os.path.exists(os.path.join(out, "sweep_report.json"))
    captured = capsys.readouterr().out
    assert "Paper grid" in captured and "| mnist | dense |" in captured
    assert ("{'data': 2}" in captured) == bool(mesh_arg)
    # a resumed second invocation exits 0 without executing anything
    reset_stage_counts()
    assert main(argv) == 0
    assert dict(stage_counts) == {}


def test_paper_grid_direct_doubles_along_training_axis():
    plain = paper_grid(quick=True, datasets=("mnist",))
    both = paper_grid(quick=True, datasets=("mnist",), direct=True)
    assert len(both) == 2 * len(plain)
    assert {s.training for s in plain} == {"convert"}
    assert {s.training for s in both} == {"convert", "direct"}
    trainings = [s.training for s in both]
    assert trainings == sorted(trainings, key=trainings.index)
    assert cell_id(both[0]) != cell_id(both[len(plain)])


def test_direct_sweep_grid_emits_pairing_section(dirs):
    """A direct sweep's markdown gains the converted-vs-direct table: its
    columns and one row per (convert, direct) pair, and the direct cell
    resumes like any other.

    The reference's copy of this test also asserts that the direct SNN
    meets its accuracy bar (accuracy >= the converted SNN's at fewer
    events). That bar is the reference's open claim: its direct recipe
    sits near chance in both packages (ROADMAP C4, PERF.md), so it is
    neither asserted here nor copied in a weaker form.
    """
    out, cache_dir = dirs
    cells = [BASE, BASE.replace(training="direct", snn_epochs=6,
                                snn_batch=48, snn_lr=1e-2, rate_reg=3.0)]
    summary = _run(cells, out_dir=out, cache_dir=cache_dir, mesh=MESH)
    assert summary["complete"]

    with open(summary["report_path"]) as f:
        rows = json.load(f)["cells"]
    md = markdown_grid(rows)
    assert "| convert |" in md and "| direct |" in md
    assert "## Converted vs direct" in md
    section = md.split("## Converted vs direct")[1]
    assert ("| dataset | backend | pricing | conv acc | direct acc | Δacc "
            "| direct/conv E med | direct/conv events |") in section
    assert section.count("| mnist | dense | c+VMEM+w8 |") == 1
    assert {r["spec"]["training"] for r in rows} == {"convert", "direct"}

    reset_stage_counts()
    _run(cells, out_dir=out, cache_dir=cache_dir, mesh=MESH)
    assert dict(stage_counts) == {}


def test_pairing_skips_unpaired_cells():
    from repro_torch.study.sweep import _pair_trainings

    row = {"spec": {"dataset": "mnist", "backend": "dense",
                    "training": "convert", "compressed": True,
                    "vmem_resident": True, "weight_bits": 8},
           "report": {}}
    assert _pair_trainings([row]) == []


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

GRIDS = [dict(), dict(quick=True), dict(direct=True),
         dict(quick=True, direct=True, datasets=("svhn",)),
         dict(datasets=("cifar10",), backends=("queue_sparse",),
              pricing=((False, True, 4),), overrides=dict(n_eval=8, T=3))]


@pytest.mark.parametrize("kw", GRIDS, ids=str)
def test_paper_grid_and_cell_ids_equal_the_reference(kw):
    ours, theirs = paper_grid(**kw), jsweep.paper_grid(**kw)
    assert [dataclasses.asdict(s) for s in ours] == \
        [dataclasses.asdict(s) for s in theirs]
    assert [cell_id(s) for s in ours] == [jsweep.cell_id(s) for s in theirs]


def _fake_rows():
    """Reference-built cells with made-up reports: a converted and a
    direct cell per pricing variant, and an unpaired one."""
    specs = jsweep.paper_grid(quick=True, datasets=("mnist",), direct=True)
    specs.append(specs[0].replace(depth=16))
    rng = np.random.default_rng(4)
    rows = []
    for s in specs:
        dec = sorted(rng.uniform(1e-6, 1e-5, 9).tolist())
        fps = sorted(rng.uniform(100, 5000, 9).tolist())
        rows.append({
            "cell_id": jsweep.cell_id(s), "spec": dataclasses.asdict(s),
            "elapsed_s": float(rng.uniform(0, 3)),
            "report": {"snn_acc": float(rng.uniform()),
                       "cnn_acc": float(rng.uniform()),
                       "snn_energy_j_deciles": dec,
                       "cnn_energy_j": float(rng.uniform(1e-7, 1e-6)),
                       "snn_fps_per_w_deciles": fps,
                       "cnn_fps_per_w": float(rng.uniform(1e4, 1e5)),
                       "overflow": int(rng.integers(0, 3)),
                       "snn_events_median": float(rng.uniform(10, 500))}})
    return rows


def test_markdown_grid_and_pairs_equal_the_reference():
    from repro_torch.study.sweep import _pair_trainings, _timing_block

    rows = _fake_rows()
    md = markdown_grid(rows)
    assert md == jsweep.markdown_grid(rows)
    assert "## Converted vs direct" in md
    assert _pair_trainings(rows) == jsweep._pair_trainings(rows)
    assert len(_pair_trainings(rows)) == 2
    _assert_close(_timing_block(rows), jsweep._timing_block(rows))


def _assert_close(a, b, path="report"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-6, abs=0.0), path
    else:
        assert a == b, path


def test_small_grid_equals_the_reference_over_a_shared_cache(tmp_path):
    """The reference sweeps a small grid, its train and convert artifacts
    on disk; the port sweeps the same grid from those artifacts, collecting
    (on a virtual 4-way mesh) and pricing by itself: every cell's report
    equals the reference's, and the markdown grids are equal."""
    cache_dir = str(tmp_path / "cache")
    jbase = jstudy.StudySpec(**BASE_KW)
    jcells = [c.replace(backend=b) for b in ("dense", "queue_pallas")
              for c in _cells(jbase)[:2]]
    tcells = [c.replace(backend=b) for b in ("dense", "queue_pallas")
              for c in _cells()[:2]]
    ref = jsweep.run_sweep(
        jcells, out_dir=str(tmp_path / "ref"), log=lambda *_: None,
        cache=jstudy.StudyCache(dir=cache_dir,
                                disk_kinds=("train", "convert")))
    reset_stage_counts()
    ours = _run(tcells, out_dir=str(tmp_path / "port"), mesh=MESH,
                cache=StudyCache(dir=cache_dir,
                                 disk_kinds=("train", "convert")))
    assert dict(stage_counts) == {"collect": 2}   # train, convert: disk hits
    assert ref["complete"] and ours["complete"]
    for a, b in zip(ours["cells"], ref["cells"]):
        assert a["cell_id"] == b["cell_id"] and a["spec"] == b["spec"]
        _assert_close(a["report"], b["report"])
    with open(ours["grid_path"]) as f, open(ref["grid_path"]) as g:
        assert f.read() == g.read()
