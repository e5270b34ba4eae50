"""Layer-1 rules: walk recorded traces and verify the declared contracts.

The counterpart of the reference's ``repro.audit.jaxpr_rules``: the same
five rules and finding texts, over the aten ops that
:class:`~repro_torch.audit.probe.Recorder` recorded instead of jaxpr
equations. Every rule takes a (name, trace) pair produced by
``audit.probe`` and returns :class:`~repro_torch.audit.findings.Finding`
objects anchored at the repo line that dispatched the offending op.

Rules:

- ``dtype-f64``       any f64/c128 tensor in a library trace.
- ``quant-accum``     the int8-weight discipline against a
                      :class:`~repro_torch.audit.contracts.QuantContract`:
                      integer products/scatter-adds must accumulate in the
                      declared dtype, int8 must never convert straight to
                      float, and the trace must contain exactly the
                      declared number of accumulator->float dequants. A
                      convert is an explicit cast (``_to_copy``, ``to``,
                      ``copy_``) or an arithmetic op that promotes an
                      integer tensor to a float result.
- ``quant-dequant``   (whole-plan variant) int8 -> float converts anywhere
                      in a backend trace.
- ``host-sync``       ops that wait for the device and pull its data to
                      the host: ``item``/``_local_scalar_dense``,
                      ``is_nonzero``, ``equal`` anywhere; on a CUDA tensor
                      also a copy to the CPU and the data-sized ops
                      (``nonzero``, ``masked_select``, boolean indexing).
                      One is accepted only where its anchor line carries
                      the ``# audit: allow[host-sync] <reason>`` marker
                      *and* the reason names a sync the path's contract
                      allows (``allowed_host_syncs``).
- ``batch-purity``    reductions that eliminate a batch-sized axis (one
                      whose size a tainted size divides: the port flattens
                      the batch into composite axes), counted against the
                      contract's declared ``cross_batch_reductions`` — the
                      structural form of the mask contract.
"""
from __future__ import annotations

import functools
import os

import torch

from .ast_rules import marker_block
from .contracts import QuantContract
from .findings import Finding

# reductions: the input is args[0], the reduced dims args[1] / ``dim``
# (none, None or [] = every dim)
_REDUCE_OPS = frozenset({
    "sum", "nansum", "mean", "amax", "amin", "max", "min", "argmax",
    "argmin", "prod", "any", "all", "logsumexp", "count_nonzero", "std",
    "var",
})
# products: op -> (index of the left operand, its contracted dim)
_PRODUCT_OPS = {
    "mm": (0, 1), "bmm": (0, 2), "addmm": (1, 1), "baddbmm": (1, 2),
    "matmul": (0, -1), "linear": (0, -1), "dot": (0, 0), "mv": (0, 1),
    "_int_mm": (0, 1),
}
# batch losses: op -> (index of the ``reduction`` argument, its default)
_LOSS_OPS = {
    "nll_loss_forward": (3, 1), "nll_loss": (3, 1), "nll_loss_nd": (3, 1),
    "cross_entropy_loss": (3, 1), "mse_loss": (2, 1), "l1_loss": (2, 1),
}
# integer-accumulating ops: op -> indices of the accumulated operands
_ACCUM_OPS = {
    "mm": (0, 1), "bmm": (0, 1), "matmul": (0, 1), "dot": (0, 1),
    "mv": (0, 1), "_int_mm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2),
    "linear": (0, 1), "conv2d": (0, 1), "convolution": (0, 1),
    "index_add": (0, 3), "index_add_": (0, 3), "scatter_add": (0, 3),
    "scatter_add_": (0, 3),
}
_CAST_OPS = frozenset({"_to_copy", "to", "type_as", "_convert_element_type"})
# arithmetic that promotes an integer tensor to a float result
_PROMOTING_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "true_divide", "where", "maximum",
    "minimum", "fmod", "remainder", "pow", "lerp", "addcmul", "addcdiv",
})
_SYNC_OPS = frozenset({"_local_scalar_dense", "item", "is_nonzero",
                       "equal"})
_CUDA_SYNC_OPS = frozenset({"nonzero", "masked_select", "unique",
                            "_unique2", "unique_consecutive", "unique_dim"})
_BANNED_DTYPES = frozenset({torch.float64, torch.complex128})


def _arg(rec, i, name, default=None):
    if i < len(rec.args):
        return rec.args[i]
    return rec.kwargs.get(name, default)


def _is_int(dt) -> bool:
    return (dt is not None and dt != torch.bool
            and not dt.is_floating_point and not dt.is_complex)


def _is_float(dt) -> bool:
    return dt is not None and dt.is_floating_point


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _is_tensor(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

def check_dtypes(name: str, trace, root: str) -> list[Finding]:
    """``dtype-f64``: no f64/c128 tensor anywhere in the trace — no op
    produces one, and the call's inputs hold none."""
    out = []
    for rec in trace:
        bad = [m.dtype for m in rec.outs if m.dtype in _BANNED_DTYPES]
        if not bad:
            continue
        if rec.op == "input":
            out += [Finding("dtype-f64", "error", "-", 0,
                            f"{name}: trace input/const has dtype "
                            f"{_dtype_name(dt)}") for dt in bad]
        else:
            out.append(Finding(
                "dtype-f64", "error", rec.file, rec.line,
                f"{name}: {rec.op} produces "
                f"{[_dtype_name(m.dtype) for m in rec.outs]} — f64/c128 "
                "must never appear in a library trace"))
    return _dedupe(out)


def _is_sync(rec) -> bool:
    if rec.packet in _SYNC_OPS:
        return True
    ins = list(rec.inputs())
    on_card = any(m.device == "cuda" for m in ins)
    if not on_card:
        return False
    if rec.packet in _CUDA_SYNC_OPS:
        return True
    if any(m.device == "cpu" for m in rec.outs):      # a copy to the host
        return True
    if rec.packet in ("index", "index_put", "index_put_"):
        idx = _arg(rec, 1, "indices", ())
        idx = (idx,) if _is_tensor(idx) else idx
        return any(_is_tensor(i) and i.dtype in (torch.bool, torch.uint8)
                   for i in idx)
    return False


@functools.lru_cache(maxsize=None)
def _source_lines(path: str) -> tuple:
    try:
        with open(path) as fh:
            return tuple(fh.read().splitlines())
    except OSError:
        return ()


def _allowed(rec, allowed, root: str) -> bool:
    """The sync's anchor line carries the marker, and its reason names one
    of the contract's allowed syncs ('occupancy-gate' reads 'occupancy
    gate')."""
    path = rec.file if os.path.isabs(rec.file) else os.path.join(root,
                                                                 rec.file)
    reason = marker_block(_source_lines(path), rec.line)
    if reason is None:
        return False
    reason = reason.replace("-", " ").lower()
    return any(a.replace("-", " ").lower() in reason for a in allowed)


def check_host_sync(name: str, trace, root: str,
                    allowed: tuple = ()) -> list[Finding]:
    """``host-sync``: no device->host pull inside a traced path, but for
    the marked ones the path's contract allows."""
    out = []
    for rec in trace:
        if _is_sync(rec) and not _allowed(rec, allowed, root):
            out.append(Finding(
                "host-sync", "error", rec.file, rec.line,
                f"{name}: {rec.op} inside a traced library path — host "
                "round-trips belong outside it, marked with "
                "'# audit: allow[host-sync]' and allowed by the path's "
                "CONTRACT"))
    return _dedupe(out)


def _dims(shape, dims) -> list[int]:
    if dims is None or dims == () or dims == []:
        return list(shape)
    dims = dims if isinstance(dims, (tuple, list)) else (dims,)
    return [shape[d] for d in dims if -len(shape) <= d < len(shape)]


def eliminated_sizes(rec) -> list[int]:
    """Axis sizes a reduction-like op eliminates (empty if none)."""
    p = rec.packet
    if p in _REDUCE_OPS:
        x, dims = _arg(rec, 0, "self"), _arg(rec, 1, "dim")
        if not _is_tensor(x) or _is_tensor(dims):    # max(a, b): elementwise
            return []
        return _dims(x.shape, dims)
    if p in _PRODUCT_OPS:
        i, d = _PRODUCT_OPS[p]
        x = _arg(rec, i, "self")
        if not _is_tensor(x) or not x.shape:
            return []
        return [x.shape[d]]
    if p in _LOSS_OPS:
        i, default = _LOSS_OPS[p]
        x = _arg(rec, 0, "self")
        if not _is_tensor(x) or _arg(rec, i, "reduction", default) == 0:
            return []
        return list(x.shape[:1]) if p.startswith(("nll", "cross")) \
            else list(x.shape)
    return []


def _tainted(size: int, tainted_sizes) -> bool:
    return size > 0 and any(size % t == 0 for t in tainted_sizes)


def batch_reductions(trace, tainted_sizes) -> list:
    """The records of ``trace`` that eliminate a batch-tainted axis."""
    return [rec for rec in trace
            if any(_tainted(s, tainted_sizes) for s in eliminated_sizes(rec))]


def check_batch_purity(name: str, trace, tainted_sizes, declared: int,
                       root: str) -> list[Finding]:
    """``batch-purity``: cross-batch reductions vs. the declared count.

    ``tainted_sizes`` are axis sizes only the batch (or batch*time) axis can
    have in the probe trace (see ``probe.batch_tainted_sizes``); every
    reduction/contraction eliminating an axis whose size one of them
    divides is a point where one sample's numbers could reach another's.
    The contract declares how many such points exist by design (0 for
    every traced backend; 2 for the sparse backend's occupancy-gate
    stats). More than declared breaks the mask contract; fewer than
    declared means the declaration is stale.
    """
    hits = batch_reductions(trace, tainted_sizes)
    out = []
    if len(hits) > declared:
        for rec in hits:
            out.append(Finding(
                "batch-purity", "error", rec.file, rec.line,
                f"{name}: {rec.op} eliminates a batch-sized "
                f"axis ({len(hits)} cross-batch reduction(s) found, "
                f"{declared} declared) — the mask contract requires every "
                "cross-batch reduction to be declared in the backend "
                "CONTRACT"))
    elif len(hits) < declared:
        out.append(Finding(
            "batch-purity", "warning", "-", 0,
            f"{name}: contract declares {declared} cross-batch "
            f"reduction(s) but the trace contains {len(hits)} — stale "
            "declaration"))
    return _dedupe(out)


def converts(trace):
    """Every (record, source dtype, target dtype) that turns a tensor of
    one dtype into another: explicit casts, ``copy_`` between dtypes, and
    arithmetic that promotes an integer operand to a float result. 0-d
    inputs are skipped (Python-scalar constants, not accumulator data)."""
    for rec in trace:
        p = rec.packet
        if not rec.outs:
            continue
        dst = rec.outs[0].dtype
        if p in _CAST_OPS or p == "copy_":
            src = _arg(rec, 1 if p == "copy_" else 0, "src")
            if _is_tensor(src) and src.shape != () and src.dtype != dst:
                yield rec, src.dtype, dst
        elif p in _PROMOTING_OPS and _is_float(dst):
            for m in rec.inputs():
                if m.shape != () and _is_int(m.dtype):
                    yield rec, m.dtype, dst
                    break


def check_quant(name: str, trace, contract: QuantContract,
                root: str) -> list[Finding]:
    """``quant-accum``: int operands accumulate in the declared dtype, with
    exactly the declared number of accumulator->float dequants and no
    direct int8->float convert anywhere."""
    out = []
    dequants = []
    for rec, src, dst in converts(trace):
        if _is_int(src) and _is_float(dst):
            if _dtype_name(src) == contract.weight_dtype:
                out.append(Finding(
                    "quant-accum", "error", rec.file, rec.line,
                    f"{name}: direct {_dtype_name(src)}->"
                    f"{_dtype_name(dst)} convert — quantized values must "
                    f"pass through the {contract.accum_dtype} accumulator "
                    "before the declared dequant"))
            else:
                dequants.append((rec, src, dst))
    for rec in trace:
        if rec.packet not in _ACCUM_OPS or not rec.outs:
            continue
        ops = [_arg(rec, i, "") for i in _ACCUM_OPS[rec.packet]]
        if any(_is_tensor(m) and _is_int(m.dtype) for m in ops):
            o = _dtype_name(rec.outs[0].dtype)
            if o != contract.accum_dtype:
                out.append(Finding(
                    "quant-accum", "error", rec.file, rec.line,
                    f"{name}: {rec.op} over integer operands "
                    f"accumulates in {o}, contract requires "
                    f"{contract.accum_dtype}"))
    if len(dequants) != contract.dequants:
        where = "; ".join(
            f"{rec.file}:{rec.line} ({_dtype_name(s)}->{_dtype_name(d)})"
            for rec, s, d in dequants) or "none found"
        out.append(Finding(
            "quant-accum", "error", "-", 0,
            f"{name}: {len(dequants)} int->float dequant(s), contract "
            f"declares exactly {contract.dequants} ({where})"))
    return _dedupe(out)


def check_no_int8_dequant(name: str, trace, root: str) -> list[Finding]:
    """``quant-dequant``: whole-plan variant — int8 never converts straight
    to float (stat casts int32->float are incidental and allowed here)."""
    out = []
    for rec, src, dst in converts(trace):
        if src == torch.int8 and _is_float(dst):
            out.append(Finding(
                "quant-dequant", "error", rec.file, rec.line,
                f"{name}: int8->{_dtype_name(dst)} convert — int8 "
                "weights/counts must accumulate in int32 before any float "
                "conversion"))
    return _dedupe(out)


def _dedupe(findings: list[Finding]) -> list[Finding]:
    seen, out = set(), []
    for f in findings:
        key = (f.fingerprint, f.line)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out
