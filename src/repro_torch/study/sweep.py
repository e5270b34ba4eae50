"""The sharded, resumable paper-grid sweep runner (port of
``repro.study.sweep``).

    PYTHONPATH=src python -m repro_torch.study.sweep [--quick] [--out sweep_out] [--device cpu]

The paper's headline result is a *grid*: SNN-vs-CNN energy, latency and
accuracy across MNIST, SVHN and CIFAR-10, per backend, per pricing variant
(compressed encoding x memory residency x CNN bit width). This module fans
the grid out as independent **cells** (one :class:`StudySpec` each) and
runs them through the staged pipeline:

- **Sharded**: each cell runs inside ``parallel.use_mesh(mesh)``, so the
  collect stage's batched SNN inference is split over the mesh (bit-exact
  against one device, which is why the cache below is safe to share).
  Training and conversion run on the mesh's first device.
- **Resumable**: every finished cell is checkpointed as one JSON file
  named by a content hash of its spec (:func:`cell_id`, the reference's
  ids), and the stage artifacts behind it (train, convert, collect)
  persist in a disk-backed :class:`~repro_torch.study.cache.StudyCache`. A
  killed sweep re-run loads finished cells from their checkpoints and
  unfinished ones from whatever stage artifacts exist: zero recomputation.
- **Partitionable**: ``--cell-shard K/N`` runs only the cells with
  ``index % N == K`` against shared cache and output directories; whichever
  worker finishes last writes the consolidated report.

Output: per-cell checkpoints under ``<out>/cells/``, one consolidated
``sweep_report.json`` and a ``sweep_grid.md`` table (:func:`markdown_grid`).

Naming note: importing this module binds ``repro_torch.study.sweep`` (the
package attribute) to the module, shadowing the ``stages.sweep`` helper. So
that ``study.sweep(base, variants)`` keeps working in any import order,
this module's class is swapped for a **callable** module type that
delegates ``__call__`` to ``stages.sweep`` (bottom of the file). Reach the
runner with ``from repro_torch.study.sweep import run_sweep``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import types

from .. import obs
from .cache import StudyCache, content_key
from .spec import StudySpec

DATASETS = ("mnist", "svhn", "cifar10")
BACKENDS = ("dense", "queue_pallas")
# pricing axes: (compressed, vmem_resident, weight_bits), price-stage-only
# fields, so every variant of a (dataset, backend) pair reuses ONE collect
PRICING = tuple((c, v, w) for c in (True, False) for v in (True, False)
                for w in (8, 4))
QUICK_PRICING = ((True, True, 8), (False, True, 8))

# --quick: the same grid shape at smoke scale
QUICK_OVERRIDES = dict(n_train=192, epochs=1, train_batch=64, n_eval=32,
                       n_calib=48, n_balance=24, T=2)


def paper_grid(*, quick: bool = False, datasets=None, backends=None,
               pricing=None, overrides=None,
               direct: bool = False) -> list[StudySpec]:
    """The grid as a cell list, pricing variants of a pair adjacent.

    Cells group by (dataset, backend), all pricing variants of a pair
    consecutive: a kill then strands at most one collect, and the cache
    turns every later variant of a collected pair into repricing.
    ``direct=True`` doubles the grid along the training axis: each pair's
    pricing variants once with the converted SNN and once with the
    surrogate-trained one, so :func:`markdown_grid` can pair them.
    """
    datasets = DATASETS if datasets is None else tuple(datasets)
    backends = (("dense",) if quick else BACKENDS) if backends is None \
        else tuple(backends)
    pricing = (QUICK_PRICING if quick else PRICING) if pricing is None \
        else tuple(pricing)
    trainings = ("convert", "direct") if direct else ("convert",)
    extra = dict(QUICK_OVERRIDES) if quick else {}
    extra.update(overrides or {})
    if quick and direct:
        # smoke-scale direct training: the reference's quick recipe
        extra.setdefault("snn_epochs", 6)
        extra.setdefault("snn_batch", 64)
        extra.setdefault("snn_lr", 1e-2)
        extra.setdefault("rate_reg", 0.02)
    cells = []
    for ds in datasets:
        for backend in backends:
            for training in trainings:
                for compressed, vmem, wbits in pricing:
                    cells.append(StudySpec(
                        dataset=ds, backend=backend, training=training,
                        compressed=compressed, vmem_resident=vmem,
                        weight_bits=wbits, **extra))
    return cells


def cell_id(spec: StudySpec) -> str:
    """Content hash of every spec field: the checkpoint identity (equal to
    the reference's id for the same spec)."""
    return content_key("sweep-cell-v1", dataclasses.asdict(spec))


def _atomic_write(path: str, write) -> None:
    """tmp file + rename, so a killed sweep never leaves a torn checkpoint
    (``write`` receives the open file); the tmp file goes on failure."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _atomic_write_json(path: str, payload: dict) -> None:
    _atomic_write(path, lambda f: json.dump(payload, f, indent=2,
                                            sort_keys=True))


def _cell_path(out_dir: str, spec: StudySpec) -> str:
    return os.path.join(out_dir, "cells",
                        f"cell_{spec.dataset}_{cell_id(spec)}.json")


def _cell_payload(spec: StudySpec, report, elapsed_s: float) -> dict:
    return {
        "schema": "sweep-cell-v1",
        "cell_id": cell_id(spec),
        "spec": dataclasses.asdict(spec),
        "report": report.to_json(),
        "elapsed_s": elapsed_s,
    }


def run_sweep(cells, *, out_dir: str, cache: StudyCache | None = None,
              cache_dir: str | None = None, mesh=None,
              max_cells: int | None = None, fresh: bool = False,
              cell_shard: tuple[int, int] = (0, 1), log=print,
              device=None) -> dict:
    """Run (or resume) the grid; returns the sweep summary dict.

    - ``cache`` / ``cache_dir``: the stage-artifact cache. Given only a
      dir, a :class:`StudyCache` persisting train, convert **and collect**
      is built over it (collect on disk is what lets a kill between pricing
      variants resume without running the SNN again).
    - ``mesh``: a data mesh (``parallel.DataMesh`` / ``data_mesh()``);
      cells run under ``parallel.use_mesh(mesh)``. ``None``: one device.
    - ``device``: where the stages run (``None``: the mesh's first device,
      or the card without a mesh; ``"cpu"`` on purpose).
    - ``max_cells``: stop after executing this many non-resumed cells.
    - ``fresh``: ignore existing cell checkpoints (stage caches still hit).
    - ``cell_shard``: ``(k, n)``, run only cells with ``index % n == k``.

    The consolidated report is written only once every cell's checkpoint
    exists, so N workers sharing ``out_dir`` finish it once.
    """
    from .. import parallel
    from . import stages

    if cache is None:
        cache = StudyCache(dir=cache_dir,
                           disk_kinds=("train", "convert", "collect"))
    if device is None and mesh is not None:
        device = mesh.devices[0]
    k, n = cell_shard
    if not (isinstance(k, int) and isinstance(n, int) and 0 <= k < n):
        raise ValueError(f"cell_shard must be (k, n) with 0 <= k < n, "
                         f"got {cell_shard!r}")

    executed, resumed = [], []
    for idx, spec in enumerate(cells):
        path = _cell_path(out_dir, spec)
        if idx % n != k:
            continue
        if not fresh and os.path.exists(path):
            resumed.append(idx)
            log(f"[sweep] cell {idx + 1}/{len(cells)} resumed: "
                f"{spec.dataset}/{spec.backend}/{spec.pricing_label()}")
            continue
        if max_cells is not None and len(executed) >= max_cells:
            log(f"[sweep] stopping after {max_cells} executed cell(s) "
                f"(--max-cells); resume to continue")
            break
        # audit: allow[host-sync] the per-cell elapsed_s persisted into
        # sweep_report.json, a deliberate measurement boundary
        t0 = time.perf_counter()
        with obs.span("sweep.cell", index=idx, dataset=spec.dataset,
                      backend=spec.backend, pricing=spec.pricing_label()):
            with parallel.use_mesh(mesh):
                report = stages.run(spec, cache=cache, device=device)
        elapsed = time.perf_counter() - t0  # audit: allow[host-sync]
        _atomic_write_json(path, _cell_payload(spec, report, elapsed))
        executed.append(idx)
        log(f"[sweep] cell {idx + 1}/{len(cells)} done in {elapsed:.1f}s: "
            f"{spec.dataset}/{spec.backend}/{spec.pricing_label()} "
            f"snn_acc={report.snn_acc:.3f}")

    rows, missing = [], []
    for spec in cells:
        path = _cell_path(out_dir, spec)
        if os.path.exists(path):
            with open(path) as f:
                rows.append(json.load(f))
        else:
            missing.append(path)

    summary = {
        "schema": "sweep-v1",
        "n_cells": len(cells),
        "n_completed": len(rows),
        "executed": len(executed),
        "resumed": len(resumed),
        "complete": not missing,
        "timing": _timing_block(rows),
        "cells": rows,
    }
    if not missing:
        report_path = os.path.join(out_dir, "sweep_report.json")
        grid_path = os.path.join(out_dir, "sweep_grid.md")
        _atomic_write_json(report_path, summary)
        md = markdown_grid(rows)
        _atomic_write(grid_path, lambda f: f.write(md))
        summary["report_path"] = report_path
        summary["grid_path"] = grid_path
        log(f"[sweep] grid complete: {len(rows)} cells -> {report_path}")
    else:
        log(f"[sweep] {len(missing)} cell(s) still missing; consolidated "
            "report deferred (resume, or let the other cell-shards finish)")
    return summary


def _timing_block(cell_rows) -> dict:
    """Per-cell wall-time summary for ``sweep_report.json``, from the
    checkpoints' recorded ``elapsed_s`` (resumed cells report their original
    execution time); the percentiles are ``obs.percentiles``'."""
    elapsed = [float(r.get("elapsed_s", 0.0)) for r in cell_rows]
    ps = obs.percentiles(elapsed)
    by_cell = {
        r["cell_id"]: {
            "label": (f"{r['spec']['dataset']}/{r['spec']['backend']}"
                      f"/{r['spec'].get('training', 'convert')}"),
            "elapsed_s": float(r.get("elapsed_s", 0.0)),
        }
        for r in cell_rows
    }
    return {
        "total_s": sum(elapsed),
        "max_s": max(elapsed, default=0.0),
        "p50_s": ps[50.0] if elapsed else 0.0,
        "p95_s": ps[95.0] if elapsed else 0.0,
        "by_cell": by_cell,
    }


def _pricing(s: dict) -> str:
    return (("c" if s["compressed"] else "u") + "+"
            + ("VMEM" if s["vmem_resident"] else "HBM")
            + f"+w{s['weight_bits']}")


def markdown_grid(cell_rows) -> str:
    """The consolidated grid as a markdown table, one row per cell.

    When the rows carry both training variants, a second **converted vs
    direct** table pairs cells identical up to ``training`` and gives the
    accuracy delta and the energy and event-count ratios.
    """
    header = ("| dataset | backend | snn | pricing | snn_acc | cnn_acc "
              "| snn E med (J) | cnn E (J) | snn FPS/W med | cnn FPS/W "
              "| overflow |\n"
              "|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for row in cell_rows:
        s, r = row["spec"], row["report"]
        training = s.get("training", "convert")
        lines.append(
            f"| {s['dataset']} | {s['backend']} | {training} | {_pricing(s)} "
            f"| {r['snn_acc']:.3f} | {r['cnn_acc']:.3f} "
            f"| {r['snn_energy_j_deciles'][3]:.3g} | {r['cnn_energy_j']:.3g} "
            f"| {r['snn_fps_per_w_deciles'][3]:.0f} "
            f"| {r['cnn_fps_per_w']:.0f} | {r['overflow']} |")
    md = "# Paper grid — SNN vs CNN\n\n" + header + "\n".join(lines) + "\n"
    pairs = _pair_trainings(cell_rows)
    if pairs:
        md += ("\n## Converted vs direct\n\n"
               "| dataset | backend | pricing | conv acc | direct acc "
               "| Δacc | direct/conv E med | direct/conv events |\n"
               "|---|---|---|---|---|---|---|---|\n")
        plines = []
        for key, conv, direct in pairs:
            ds, backend, pricing = key
            rc, rd = conv["report"], direct["report"]
            e_ratio = (rd["snn_energy_j_deciles"][3]
                       / max(rc["snn_energy_j_deciles"][3], 1e-30))
            ev_c = rc.get("snn_events_median", 0.0)
            ev_d = rd.get("snn_events_median", 0.0)
            ev_ratio = ev_d / max(ev_c, 1e-30)
            plines.append(
                f"| {ds} | {backend} | {pricing} "
                f"| {rc['snn_acc']:.3f} | {rd['snn_acc']:.3f} "
                f"| {rd['snn_acc'] - rc['snn_acc']:+.3f} "
                f"| {e_ratio:.2f} | {ev_ratio:.2f} |")
        md += "\n".join(plines) + "\n"
    return md


def _pair_trainings(cell_rows):
    """Match cells identical up to ``training``: [(key, conv_row,
    direct_row)]. The key is every spec field except ``training`` and the
    train_snn-only recipe fields (inert on convert cells)."""
    inert = {"training", "snn_epochs", "snn_batch", "snn_lr", "surrogate",
             "sg_beta", "loss_target", "rate_reg", "snn_init_seed"}
    by_key: dict = {}
    for row in cell_rows:
        s = row["spec"]
        key = tuple(sorted((k, repr(v)) for k, v in s.items()
                           if k not in inert))
        by_key.setdefault(key, {})[s.get("training", "convert")] = row
    pairs = []
    for variants in by_key.values():
        if "convert" in variants and "direct" in variants:
            s = variants["convert"]["spec"]
            pairs.append(((s["dataset"], s["backend"], _pricing(s)),
                          variants["convert"], variants["direct"]))
    return pairs


def _parse_shard(s: str) -> tuple[int, int]:
    try:
        k, n = s.split("/")
        return int(k), int(n)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--cell-shard wants K/N (e.g. 0/4), got {s!r}") from None


def _mesh_for(n: int | None, device: str | None):
    """--mesh N: 0 disables sharding; N > 0 takes N cards, or with a
    non-CUDA --device a virtual mesh of N shards on that device; unset takes
    every card when there is more than one."""
    from .. import parallel

    if n == 0:
        return None
    if device is not None and not device.startswith("cuda"):
        return None if n is None else parallel.DataMesh((device,) * n)
    if n is not None:
        return parallel.data_mesh(n)
    return parallel.data_mesh() if parallel.device_count() > 1 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.study.sweep",
        description="Run the paper grid as a resumable, sharded sweep.")
    ap.add_argument("--quick", action="store_true",
                    help="smoke-scale grid")
    ap.add_argument("--datasets", default=None,
                    help=f"comma list (default: {','.join(DATASETS)})")
    ap.add_argument("--backends", default=None,
                    help="comma list (default: dense,queue_pallas; "
                         "--quick defaults to dense)")
    ap.add_argument("--out", default="sweep_out",
                    help="output dir: cells/, sweep_report.json, "
                         "sweep_grid.md (default: sweep_out)")
    ap.add_argument("--cache", default=None,
                    help="stage-artifact cache dir (default: <out>/cache)")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="shards in the data mesh (default: every card when "
                         "there is more than one; 0 disables sharding; with "
                         "--device cpu, N virtual shards on the CPU)")
    ap.add_argument("--device", default=None,
                    help="where the stages run (default: the card; 'cpu' "
                         "runs on the CPU)")
    ap.add_argument("--max-cells", type=int, default=None,
                    help="execute at most N cells this run (kill/resume aid)")
    ap.add_argument("--direct", action="store_true",
                    help="add surrogate-gradient-trained cells next to every "
                         "converted one (converted-vs-direct grid)")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore existing cell checkpoints")
    ap.add_argument("--cell-shard", type=_parse_shard, default=(0, 1),
                    metavar="K/N", help="run only cells with index%%N == K")
    args = ap.parse_args(argv)

    mesh = _mesh_for(args.mesh, args.device)
    print(f"[sweep] mesh: "
          f"{'none (single device)' if mesh is None else dict(mesh.shape)}")

    cells = paper_grid(
        quick=args.quick,
        datasets=args.datasets.split(",") if args.datasets else None,
        backends=args.backends.split(",") if args.backends else None,
        direct=args.direct)
    print(f"[sweep] {len(cells)} cells "
          f"({'quick' if args.quick else 'full'} grid)")

    summary = run_sweep(
        cells, out_dir=args.out,
        cache_dir=args.cache or os.path.join(args.out, "cache"),
        mesh=mesh, max_cells=args.max_cells, fresh=args.fresh,
        cell_shard=args.cell_shard, device=args.device)

    if summary["complete"]:
        with open(summary["grid_path"]) as f:
            print(f.read())
        return 0
    print(f"[sweep] incomplete: {summary['n_completed']}/"
          f"{summary['n_cells']} cells checkpointed")
    return 3


class _CallableSweepModule(types.ModuleType):
    """A module type that doubles as the ``stages.sweep`` helper (see the
    naming note above). The signature is ``stages.sweep``'s; delegation is
    late-bound, so monkeypatching ``stages.sweep`` shows through either
    name."""

    def __call__(self, base, variants, *, cache=None, device=None):
        from . import stages

        return stages.sweep(base, variants, cache=cache, device=device)


sys.modules[__name__].__class__ = _CallableSweepModule

if __name__ == "__main__":
    raise SystemExit(main())
