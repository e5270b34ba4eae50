"""CONTRACT descriptors: the declared intent the auditor verifies (port of
``repro.audit.contracts``, the same fields and defaults).

Kernels and backends do not get their invariants inferred — they *declare*
them in small pure-data descriptors placed next to the code (``CONTRACT``
module attributes in ``kernels/*.py``, ``BACKEND_CONTRACTS`` in
``core/engine.py``, ``CONTRACT`` in ``serve/registry.py``). The trace
auditor then checks the recorded aten ops against the declaration, so a
drive-by edit that e.g. adds a second dequant or a stray cross-batch
reduction fails the audit even though every runtime test still passes on
the new numerics.

This module is deliberately dependency-free (no torch, no package
imports): engine and the kernels import it at module scope, and the
auditor imports them — any import edge back out of here would be a cycle.
"""
from __future__ import annotations

import dataclasses
import math

#: Shared memory one Hopper thread block may use (227 KB, after opting in
#: past the 48 KB default with ``cudaFuncSetAttribute``). The one copy of
#: the number: the kernel wrappers' shape checks read it, and the CUDA
#: sources get it as ``-DREPRO_SMEM_MAX`` from ``kernels/_cuda.py``.
SMEM_BUDGET_BYTES = 232_448

#: A staged buffer that is double-buffered holds two chunks at once (the
#: gather loads chunk i+1 while it adds chunk i).
DOUBLE_BUFFER_FACTOR = 2


def block_bytes(blocks) -> int:
    """Total bytes of ``smem_blocks`` output: a list of ``(name, shape,
    bytes_per_elem, double_buffered)`` tuples."""
    total = 0
    for _, shape, elem_bytes, double_buffered in blocks:
        n = math.prod(shape) * elem_bytes
        total += n * (DOUBLE_BUFFER_FACTOR if double_buffered else 1)
    return total


@dataclasses.dataclass(frozen=True)
class QuantContract:
    """The int8-weight discipline: quantized weights must accumulate in
    exactly ``accum_dtype`` and convert to float exactly ``dequants`` times
    (the single declared rescale). A trace with an int8->float convert, a
    float accumulate over int operands, or a second int->float convert
    violates the contract even if it happens to be numerically close."""

    weight_dtype: str = "int8"
    accum_dtype: str = "int32"
    dequants: int = 1


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """Declared kernel resource intent, checked by ``audit.smem``.

    Each kernel module exposes a ``smem_blocks(**geometry)`` helper beside
    its ``CONTRACT`` returning the concrete ``(name, shape, bytes per
    element, double_buffered)`` shared-memory buffers its launcher
    requests per thread block; the contract records which module that is
    plus the dtype/quant intent the trace rules verify.
    """

    name: str
    module: str                       # e.g. 'repro_torch.kernels.spike_pipeline'
    accum_dtype: str = "int32"        # accumulator dtype inside the kernel
    quant: QuantContract | None = None
    # host syncs the kernel's *dispatch path* is allowed to perform, by
    # marker name; anything else device->host inside the path is an error
    allowed_host_syncs: tuple = ()


@dataclasses.dataclass(frozen=True)
class BackendContract:
    """Declared per-backend trace intent, checked against the batched plan.

    ``cross_batch_reductions``: number of reductions over the batch axis
    the backend's plan walk is allowed to contain. The mask contract
    (padded rows bit-inert) holds iff every cross-batch reduction is
    declared — queue_sparse's occupancy stats own the only two.
    ``host_dispatch`` backends are traced per piece rather than as one
    batched plan (their plan walk pulls scalars to the host between layers).

    ``train_loss_reductions``: for a backend that owns a differentiable
    training walk (``engine.train_forward`` — dense only), the number of
    batch-axis reductions its *loss forward* contains by design (batch-mean
    loss terms). ``None`` = the backend declares no training path. The
    backward pass is exempted from the count — weight gradients
    legitimately contract the batch axis — but still gets the
    dtype/host-sync rules.
    """

    name: str
    cross_batch_reductions: int = 0
    host_dispatch: bool = False
    quant: QuantContract | None = None
    allowed_host_syncs: tuple = ()
    train_loss_reductions: int | None = None
