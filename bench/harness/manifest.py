"""The benchmark's files, found by the names in ``BENCHMARK.json``.

A cell names a configuration (``bench/configs/<name>.json``, the file the
manifest gives) and a traffic mix (``bench/traffic/<name>.json``); the
configuration names its runner (``"runner"``: ``bench/runners/<name>.py``),
which builds, drives and judges the program by its reference
(``bench/reference/<name>.py``, of the same name); every metric, end to end or per layer, is read by
``bench/metrics/<name>.py``'s ``read(ctx)``. Adding a cell, a mix, a
runner or a metric adds files and manifest entries and edits no file here.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in manifest['workloads']]}")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "bench" / "traffic" / f"{name}.json")
                      .read_text())


def _listed(metric: dict, cell: str) -> bool | None:
    """True/False where the metric names its cells, None where it does not."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return None


def end_to_end(manifest: dict, cell: str) -> list[dict]:
    """The cell's end-to-end metrics: those that list it, and those that
    list no cells."""
    return [m for m in manifest["end_to_end"]
            if _listed(m, cell) is not False]


def per_layer(manifest: dict, cell: str) -> list[dict]:
    """The cell's per-layer metrics: those that list it, and those that
    list no cells and move an end-to-end metric the cell reports."""
    reports = {m["name"] for m in end_to_end(manifest, cell)}
    out = []
    for m in manifest["per_layer"]:
        listed = _listed(m, cell)
        if listed or (listed is None and m["moves"] in reports):
            out.append(m)
    return out


def load_file(path: Path, kind: str):
    """The module of the file ``path`` (a reader, a mix's driver, a
    runner), loaded under a name of its ``kind`` and its stem."""
    stem = path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """``read(ctx) -> float | None`` of ``bench/metrics/<name>.py``."""
    return load_file(root / "bench" / "metrics" / f"{name}.py", "metric").read


def _named_file(kind: str, folder: str, name: str, root: Path):
    path = Path(root) / "bench" / folder / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"{kind} {name!r}: there is no {path}")
    return load_file(path, kind)


def runner(name: str, root: Path = ROOT):
    """The ``Program`` class of ``bench/runners/<name>.py``, the runner a
    configuration names (``cell.Program``)."""
    return _named_file("runner", "runners", name, root).Program


def reference(name: str, root: Path = ROOT):
    """The module ``bench/reference/<name>.py``: the plain reference that
    the runner of that name judges its program by."""
    return _named_file("reference", "reference", name, root)
