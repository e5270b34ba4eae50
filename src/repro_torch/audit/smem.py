"""Shared-memory footprint estimator: staged buffers x dtype x buffering
(the counterpart of ``repro.audit.vmem``, which models a TPU core's VMEM).

Each kernel module declares the dynamic shared memory a thread block of
its launcher requests via a ``smem_blocks(**geometry)`` helper next to its
``CONTRACT`` — the buffers the CUDA source stages, as data (a module whose
call is two launches lists them in ``SMEM_LAUNCHES`` and takes
``launch=``). The estimator evaluates those at every geometry the paper's
model zoo can launch (each conv stage of each ``PAPER_SPECS`` spec, at the
study's default queue depth) and flags any launch whose bytes exceed one
Hopper block's budget.

This is a *static* gate: it catches an edit that would make a launch fail
without needing the card. On the card, :func:`compare_launchers` holds
each ``smem_blocks`` total to the bytes the compiled launcher requests
(each CUDA source's ``*_smem`` query).
"""
from __future__ import annotations

import importlib
import os

from .contracts import SMEM_BUDGET_BYTES, block_bytes
from .findings import Finding

#: The kernel modules that declare ``CONTRACT`` + ``smem_blocks``.
KERNEL_MODULES = (
    "repro_torch.kernels.spike_pipeline",
    "repro_torch.kernels.spike_sparse",
    "repro_torch.kernels.event_accum",
    "repro_torch.kernels.spike_compact",
)

#: Queue depth the studies run at (SNNConfig default) — the worst case the
#: estimator must clear, since depth sizes the queue encoder's row tile.
DEFAULT_DEPTH = 256


def paper_geometries(depth: int = DEFAULT_DEPTH):
    """Every (dataset, ConvPlan-derived geometry) the zoo can launch."""
    from .. import configs
    from ..core import engine

    for dataset, d in configs.PAPER_SPECS.items():
        plan = engine.compile_plan(d["spec"], d["hw"], d["c"])
        for cp in plan.convs:
            yield dataset, dict(K=cp.kernel, n_win=cp.fmt.n_win,
                                depth=depth, H=cp.in_hw, W=cp.in_hw,
                                C_out=cp.out_c)


def module_anchor(module, root: str) -> tuple[str, int]:
    """(repo-relative file, CONTRACT line) of a kernel module."""
    path = module.__file__
    rel = (os.path.relpath(path, root)
           if path.startswith(root.rstrip(os.sep) + os.sep) else path)
    try:
        with open(path) as fh:
            for i, ln in enumerate(fh, 1):
                if ln.startswith("CONTRACT"):
                    return rel, i
    except OSError:  # pragma: no cover
        pass
    return rel, 1


def launches(module) -> tuple:
    """The launches of a module with their own blocks (None: just one)."""
    return getattr(module, "SMEM_LAUNCHES", (None,))


def module_blocks(module, launch, **geometry):
    kw = {} if launch is None else {"launch": launch}
    return module.smem_blocks(**kw, **geometry)


def check_smem(root: str, depth: int = DEFAULT_DEPTH,
               budget: int = SMEM_BUDGET_BYTES) -> list[Finding]:
    """``smem-budget``: every paper geometry of every launch fits a block."""
    out = []
    geoms = list(paper_geometries(depth))
    for mod_name in KERNEL_MODULES:
        module = importlib.import_module(mod_name)
        rel, line = module_anchor(module, root)
        for launch in launches(module):
            for dataset, geom in geoms:
                total = block_bytes(module_blocks(module, launch, **geom))
                if total > budget:
                    what = mod_name if launch is None else \
                        f"{mod_name} ({launch})"
                    out.append(Finding(
                        "smem-budget", "error", rel, line,
                        f"{what}: {total} bytes of shared memory per block "
                        f"at {dataset} geometry {geom} exceed the {budget}-"
                        "byte budget of one Hopper block"))
    return out


def kernel_footprint(mod_name: str, launch=None, **geometry) -> int:
    """Shared-memory bytes of one launch at an explicit geometry."""
    module = importlib.import_module(mod_name)
    return block_bytes(module_blocks(module, launch, **geometry))


def launcher_cases(gather_shapes=(), compact_shapes=(),
                   depths=(64, DEFAULT_DEPTH), N: int = 64) -> list:
    """``(module name, geometry)`` pairs for :func:`compare_launchers`:
    every kernel module at every paper geometry (``N`` rows, as a serve
    bucket's), then the gathers of B1, B3 and B4 at ``gather_shapes``
    ((hw, C_in, C_out, K, rows, depth) maps) and B5 at ``compact_shapes``
    ((rows, n_win, depth) queues); each pair once."""
    seen, cases = set(), []

    def add(mod, geom):
        key = (mod, tuple(sorted(geom.items())))
        if key not in seen:
            seen.add(key)
            cases.append((mod, geom))

    for depth in depths:
        for _, geom in paper_geometries(depth):
            for mod in KERNEL_MODULES:
                add(mod, dict(geom, N=N))
    for hw, _, c_out, K, rows, depth in gather_shapes:
        for mod in KERNEL_MODULES[:3]:
            add(mod, dict(K=K, n_win=-(-hw // K), H=hw, W=hw, C_out=c_out,
                          N=rows, depth=depth))
    for _, n_win, depth in compact_shapes:
        add(KERNEL_MODULES[3], dict(n_win=n_win, depth=depth))
    return cases


def compare_launchers(cases, sm_count: int) -> list[dict]:
    """On the card: for each ``(module name, geometry)`` case, every
    launch's ``smem_blocks`` total beside the bytes its compiled launcher
    requests (the module's ``launch_smem``). ``sm_count`` picks B4's gather
    cells as its launcher does. Each row has ``python``, ``c`` and
    ``equal``."""
    rows = []
    for mod_name, geom in cases:
        module = importlib.import_module(mod_name)
        c = module.launch_smem(**geom)
        for launch in launches(module):
            kw = dict(geom)
            if launch == "gather":
                kw["cells"] = module.gather_cells(
                    geom["N"], geom["K"], geom["H"], geom["W"], geom["C_out"],
                    sm_count)
            py = block_bytes(module_blocks(module, launch, **kw))
            got = c if launch is None else c[launch]
            rows.append(dict(module=mod_name, launch=launch, geometry=geom,
                             python=py, c=got, equal=py == got))
    return rows
