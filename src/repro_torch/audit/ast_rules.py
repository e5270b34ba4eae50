"""Layer-2 rules: AST lint over ``src/repro_torch/`` with the repo's bans
(port of ``repro.audit.ast_rules``: the same seven rules, with the
constructs renamed to torch's).

These rules are purely syntactic (no imports, no tracing), so they run in
milliseconds and catch hazards the trace layer cannot see — code that only
executes on the card, on rare branches, or in modules the probe never
traces, and host pulls that dispatch no op on the CPU (``.cpu()`` of a CPU
tensor, ``.tolist()``, ``.numpy()``).

Rules (all anchored at the offending ``file:line``):

- ``ast-f64``          ``float64``/``double``/``complex128``/``cdouble``
                       anywhere (``torch.float64``, ``torch.double``,
                       ``x.double()``, ``np.float64``) — the repo is strictly
                       single-precision.
- ``ast-np-in-jit``    ``np.``/``numpy.`` calls inside a function decorated
                       with ``torch.compile``, ``torch.jit.script`` or
                       ``torch.jit.trace``: host math inside a compiled
                       path either breaks the compile or is frozen into it.
- ``vmap-over-queue``  ``torch.vmap``/``torch.func.vmap`` applied over the
                       event-queue entry points — the batch axis belongs in
                       the kernel's grid, not an outer vmap.
- ``banned-import``    imports of ``tests``/``benchmarks`` (incl. the
                       retired seed interpreter and the frozen legacy study)
                       from library code.
- ``host-sync-marker`` host-synchronizing constructs (``.item()``,
                       ``.tolist()``, ``.cpu()``, ``.numpy()``,
                       ``torch.cuda.synchronize`` and a stream's or event's
                       ``.synchronize()``, and the reference's
                       ``device_get``/``block_until_ready``/callbacks)
                       without an ``# audit: allow[host-sync] <reason>``
                       marker on the same line or in the comment block
                       directly above. The allowlist is thereby *in the
                       code*, next to each deliberate sync.
- ``obs-in-jit``       ``obs.span/event/counter/gauge/observe`` — or a
                       direct clock read — inside a compiled function:
                       it would run at compile time only. No marker escape.
- ``clock-marker``     direct clock reads (``time.perf_counter`` /
                       ``time.monotonic``) in library code without the
                       marker. Bare references (``clock=time.perf_counter``
                       default args) are the sanctioned indirection and
                       never flag.
"""
from __future__ import annotations

import ast
import os

from .findings import Finding

ALLOW_MARKER = "# audit: allow[host-sync]"

_F64_NAMES = frozenset({"float64", "complex128", "double", "cdouble"})
_NP_ALIASES = frozenset({"np", "numpy"})
_HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy",
                                "synchronize", "device_get",
                                "block_until_ready"})
_HOST_SYNC_CALLS = frozenset({"pure_callback", "io_callback",
                              "debug_callback"})
# the event-queue *dispatch* entry points whose batch axis lives in the
# kernel's grid; vmapping any of them re-creates a per-sample dispatch.
# Host-side queue *builders* are deliberately absent: vmapping a builder is
# data preparation, not dispatch.
QUEUE_ENTRY_POINTS = frozenset({
    "fused_spike_accum", "fused_spike_accum_cuda", "fused_spike_accum_plain",
    "fused_spike_accum_sparse", "fused_spike_accum_sparse_cuda",
    "fused_spike_accum_sparse_plain", "event_accum", "event_accum_cuda",
    "event_accum_plain", "event_conv2d", "conv_layer_batch",
})
_BANNED_IMPORT_ROOTS = frozenset({"tests", "benchmarks"})
_BANNED_IMPORT_NAMES = frozenset({"_seed_reference", "_legacy_study"})
# the public instrumentation surface of repro_torch.obs (obs-in-jit rule)
_OBS_API = frozenset({"span", "event", "counter", "gauge", "observe"})
# direct monotonic-clock reads; ``time.time`` is excluded — wall-of-day
# reads are logging, not measurement
_CLOCK_CALLS = frozenset({"perf_counter", "perf_counter_ns",
                          "monotonic", "monotonic_ns"})
# decorators that compile a function (the port's counterpart of ``jit``)
_COMPILE_DECORATORS = frozenset({
    ("torch", "compile"), ("compile",), ("torch", "jit", "script"),
    ("torch", "jit", "trace"), ("jit", "script"), ("jit", "trace"),
})


def iter_source_files(src_root: str):
    """Every ``.py`` under ``src_root`` except audit packages (the auditor
    names the constructs it bans, so self-linting would flag its own rule
    tables)."""
    for dirpath, dirnames, filenames in os.walk(src_root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "audit"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _dotted(node) -> tuple:
    """``torch.jit.script`` -> ("torch", "jit", "script"); () if not a
    plain dotted name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ()
    return (node.id, *reversed(parts))


def _is_compile_decorator(node) -> bool:
    if isinstance(node, ast.Call):
        return _is_compile_decorator(node.func)
    return _dotted(node) in _COMPILE_DECORATORS


def _names_in(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id
        elif isinstance(sub, ast.Attribute):
            yield sub.attr
        elif isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            yield sub.value


def marker_block(lines, lineno: int) -> str | None:
    """The text of the marker that covers ``lineno`` — on the line itself,
    or anywhere in the contiguous comment block immediately above it
    (markers wrap like any comment) — or None."""
    if 1 <= lineno <= len(lines) and ALLOW_MARKER in lines[lineno - 1]:
        return lines[lineno - 1].split(ALLOW_MARKER, 1)[1]
    block = []
    ln = lineno - 1
    while 1 <= ln <= len(lines) and lines[ln - 1].lstrip().startswith("#"):
        block.insert(0, lines[ln - 1].lstrip().lstrip("#").strip())
        if ALLOW_MARKER in lines[ln - 1]:
            return " ".join(block).split(ALLOW_MARKER[2:], 1)[1]
        ln -= 1
    return None


def _has_marker(lines, lineno: int) -> bool:
    return marker_block(lines, lineno) is not None


def check_file(path: str, root: str) -> list[Finding]:
    """All AST rules over one source file."""
    rel = os.path.relpath(path, root)
    with open(path) as fh:
        source = fh.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("ast-parse", "error", rel, e.lineno or 0,
                        f"file does not parse: {e.msg}")]
    lines = source.splitlines()
    out = []

    compiled = [n for n in ast.walk(tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and any(_is_compile_decorator(d) for d in n.decorator_list)]
    spans = [(n.lineno, max((getattr(s, "end_lineno", s.lineno) or
                             s.lineno) for s in ast.walk(n)
                            if hasattr(s, "lineno")))
             for n in compiled]

    def in_jit(lineno: int) -> bool:
        return any(a <= lineno <= b for a, b in spans)

    for node in ast.walk(tree):
        lineno = getattr(node, "lineno", 0)

        # --- ast-f64 ---------------------------------------------------
        name = (node.attr if isinstance(node, ast.Attribute)
                else node.id if isinstance(node, ast.Name)
                else node.value if isinstance(node, ast.Constant)
                and isinstance(node.value, str) else None)
        if name in _F64_NAMES:
            out.append(Finding(
                "ast-f64", "error", rel, lineno,
                f"{name!r} in library code — the repo is strictly "
                "single-precision (f64 would silently change every "
                "bit-exactness baseline)"))

        # --- ast-np-in-jit ---------------------------------------------
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in _NP_ALIASES and in_jit(lineno)):
            out.append(Finding(
                "ast-np-in-jit", "error", rel, lineno,
                f"numpy call ({node.value.id}.{node.attr}) inside a "
                "compiled function — host math in a compiled path is "
                "frozen into it or breaks the compile; use torch"))

        # --- vmap-over-queue -------------------------------------------
        if (isinstance(node, ast.Call)
                and ((isinstance(node.func, ast.Attribute)
                      and node.func.attr == "vmap")
                     or (isinstance(node.func, ast.Name)
                         and node.func.id == "vmap"))):
            args = [*node.args, *(kw.value for kw in node.keywords)]
            banned = sorted({n for a in args for n in _names_in(a)
                             if n in QUEUE_ENTRY_POINTS})
            if banned:
                out.append(Finding(
                    "vmap-over-queue", "error", rel, lineno,
                    f"vmap over queue entry point(s) {banned} — the event "
                    "path is batch-native (batch axis in the kernel's "
                    "grid); vmapping it re-creates a per-sample dispatch"))

        # --- banned-import ---------------------------------------------
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods = [node.module]
            mods += [f"{node.module}.{a.name}" for a in node.names]
        for mod in mods:
            head = mod.split(".")[0]
            leaf = mod.split(".")[-1]
            if head in _BANNED_IMPORT_ROOTS or leaf in _BANNED_IMPORT_NAMES:
                out.append(Finding(
                    "banned-import", "error", rel, lineno,
                    f"library code imports {mod!r} — tests, benchmarks, "
                    "and the retired seed interpreter must depend on src/, "
                    "never the reverse"))

        # --- host-sync-marker ------------------------------------------
        sync = None
        if isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in
                    (_HOST_SYNC_METHODS | _HOST_SYNC_CALLS)):
                sync = node.func.attr
            elif (isinstance(node.func, ast.Name)
                  and node.func.id in _HOST_SYNC_CALLS):
                sync = node.func.id
        if sync and not _has_marker(lines, lineno):
            out.append(Finding(
                "host-sync-marker", "error", rel, lineno,
                f"host-synchronizing call {sync!r} without an "
                f"'{ALLOW_MARKER} <reason>' marker — deliberate host "
                "pulls must be annotated where they happen"))

        # --- obs-in-jit / clock-marker ---------------------------------
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)):
            owner, attr = node.func.value.id, node.func.attr
            if owner == "obs" and attr in _OBS_API and in_jit(lineno):
                out.append(Finding(
                    "obs-in-jit", "error", rel, lineno,
                    f"obs.{attr} inside a compiled function — "
                    "instrumentation is host-side by contract: in a "
                    "compiled path this fires once at compile time (a lie) "
                    "and never per execution; record around the compiled "
                    "call instead"))
            elif owner == "time" and attr in _CLOCK_CALLS:
                if in_jit(lineno):
                    out.append(Finding(
                        "obs-in-jit", "error", rel, lineno,
                        f"time.{attr}() inside a compiled function is read "
                        "at compile time — the 'measurement' would be a "
                        "constant; time around the compiled call instead"))
                elif not _has_marker(lines, lineno):
                    out.append(Finding(
                        "clock-marker", "error", rel, lineno,
                        f"direct clock read time.{attr}() without an "
                        f"'{ALLOW_MARKER} <reason>' marker — deliberate "
                        "timing sites annotate themselves; everything "
                        "else takes an injectable clock so tests stay "
                        "deterministic"))

    return out


def check_src(src_root: str, root: str) -> list[Finding]:
    out = []
    for path in iter_source_files(src_root):
        out += check_file(path, root)
    return out
