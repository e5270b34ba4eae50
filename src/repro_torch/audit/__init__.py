"""repro_torch.audit — the port's contract checker (port of ``repro.audit``).

Two layers:

1. **trace auditor** (``probe`` + ``trace_rules`` + ``smem`` +
   ``harness``): records the aten ops of every registered backend's
   batched plan, of ``queue_sparse``'s pieces, of direct training, of the
   int8 paths and of the kernels of B1, B3 and B4 (a ``TorchDispatchMode``
   recorder; kernel launches from the launch counters), then verifies the
   declared ``CONTRACT`` descriptors — dtype discipline, the int8 -> int32
   -> single-dequant quant path, host syncs only where marked and allowed,
   batch-axis purity (the mask contract, structurally), the kernels'
   shared memory against one Hopper block, and cache flatness (on the
   card also graph-capture flatness).
2. **AST lint** (``ast_rules`` + ``reachability``): the repo's source bans
   in torch's spelling — f64, numpy-in-compile, vmap-over-queue, reverse
   imports from tests/benchmarks, unmarked host syncs and clock reads —
   plus an import-reachability graph that flags dead modules.

CLI: ``python -m repro_torch.audit [--strict] [--no-trace] [--device
cpu|cuda]``; findings are ``file:line``-anchored, severity-tagged, and
gated against the committed ``baseline.json`` beside this file (every
accepted finding carries a justification).
"""
from .contracts import (BackendContract, KernelContract, QuantContract,
                        SMEM_BUDGET_BYTES)
from .findings import Baseline, BaselineError, Finding
from .gh_summary import emit, markdown_table, render_report

__all__ = [
    "BackendContract", "KernelContract", "QuantContract",
    "SMEM_BUDGET_BYTES", "Baseline", "BaselineError", "Finding",
    "emit", "markdown_table", "render_report",
]
