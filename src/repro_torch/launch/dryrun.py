"""Dry run of one LM cell (port of ``repro.launch.dryrun``): the cell's
step traced at its full shapes on ``meta`` stand-ins under the resolver of
a virtual production mesh, and the three-term roofline derived from it.

    from repro_torch.launch.dryrun import build_cell
    rec = build_cell("moe-14b", "train_4k", cfg=cfg, multi_pod=False)

The reference lowers and compiles each cell with XLA on 512 forced host
devices and reads ``cost_analysis``, ``memory_analysis`` and the
collectives of the partitioned HLO. The port has no compiler to ask and
partitions nothing. It runs the step once on ``meta`` tensors (nothing is
allocated, nothing is computed): the train step with its state, ``prefill``,
or ``decode_step`` with its caches, inside ``use_resolver`` so every
``constrain`` call of the model resolves and records its spec. FLOPs come
from ``torch.utils.flop_counter.FlopCounterMode``; bytes from
:class:`ByteCounter`, a dispatch mode that adds each op's input and output
bytes as the eager program moves them (views move nothing). Python loops
over periods and microbatches trace once per trip, so nothing is counted
once for many executions (the reference's scan caveat has no counterpart,
and ``unroll`` only sets the config's knobs).

What the record cannot hold, and leaves out rather than make up: the
compile time; ``memory_analysis``'s output, temp and generated-code sizes;
the per-kind split of the collectives. ``per_device`` is the traced totals
divided by ``n_chips`` (an even split, the port partitions nothing), its
``collective_bytes`` the analytic model's (``launch/costs.py``), and
``memory_analysis.argument_size_in_bytes`` the per-device bytes of the
step's inputs under the resolver's shardings.

The HLO text helpers (``collective_bytes`` and its parsers) are the
reference's, copied: pure text functions, so each package reads HLO dumps
and records of the other.

B6 (``ops.moe_gather``) runs as its plain version here: ``meta`` tensors
take the dispatcher's non-CUDA branch. That is shape tracing, not a kernel
fallback.
"""
from __future__ import annotations

import dataclasses
import math
import re
import time

import torch
import torch.utils._pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .. import configs
from ..checkpoint.checkpoint import _flatten
from ..models import model as M
from ..sharding.resolver import Resolver, map_with_axes, use_resolver
from ..training import train_loop
from .costs import active_params, cell_cost, model_flops
from .mesh import make_production_mesh

# --- H100 SXM machine constants -------------------------------------------
# dense bf16 tensor-core peak, no sparsity (NVIDIA H100 datasheet: 989.4
# TFLOP/s for SXM5); HBM3 bandwidth (the same datasheet, 3.35 TB/s, the
# figure the kernels' bounds use); the collective bandwidth a chip gets on
# the inter-node fabric, one 400 Gb/s NDR InfiniBand port per GPU (DGX H100:
# eight ConnectX-7 ports for eight GPUs) = 50 GB/s. A 16 x 16 cell spans 32
# eight-GPU nodes, so its collectives cross that fabric (inside a node,
# NVLink 4 would give 450 GB/s each way).
PEAK_BF16 = 989e12       # FLOP/s per chip
HBM_BW = 3.35e12         # bytes/s per chip
COLL_BW = 50e9           # bytes/s per chip, inter-node (InfiniBand NDR)

COLLECTIVE_RE = re.compile(
    r"=\s*(?:\([^)]*\)|\S+)\s+(all-gather|all-reduce|reduce-scatter|"
    r"all-to-all|collective-permute)", re.IGNORECASE)
SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|s32|u32|s8|u8|s64|u64|pred|s16|u16)"
                      r"\[([0-9,]*)\]")
DTYPE_BYTES = {"f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
               "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
               "s8": 1, "u8": 1, "pred": 1}


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in SHAPE_RE.findall(text):
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def _parse_computations(hlo_text: str):
    """Split post-optimization HLO text into {name: [lines]} + entry name."""
    comps, cur, entry = {}, None, None
    for line in hlo_text.splitlines():
        if not line.startswith(" ") and "{" in line and (
                line.startswith("%") or line.startswith("ENTRY")):
            m = re.match(r"^(ENTRY\s+)?(%[^\s(]+)", line)
            if m:
                cur = m.group(2)
                comps[cur] = []
                if m.group(1):
                    entry = cur
                continue
        if cur is not None:
            comps[cur].append(line.strip())
    return comps, entry


_WHILE_RE = re.compile(r"while\(.*?\).*?condition=(%[^\s,}]+).*?body=(%[^\s,}]+)")
_CONST_RE = re.compile(r"constant\((\d+)\)")


def _loop_multipliers(comps, entry):
    """Execution-count multiplier per computation: while bodies inherit the
    caller's multiplier x the loop trip count (read from the largest integer
    constant in the loop's condition computation — exact for counted loops,
    an upper bound otherwise)."""
    mult = {entry: 1.0}
    frontier = [entry]
    while frontier:
        comp = frontier.pop()
        for line in comps.get(comp, ()):
            m = _WHILE_RE.search(line)
            if not m:
                continue
            cond, body = m.group(1), m.group(2)
            consts = [int(c) for cl in comps.get(cond, ())
                      for c in _CONST_RE.findall(cl)]
            trip = max(consts) if consts else 1
            new_mult = mult[comp] * max(trip, 1)
            if mult.get(body, 0) < new_mult:
                mult[body] = new_mult
                frontier.append(body)
    return mult


_COLL_OP_RE = re.compile(
    r"=\s*(.*?)\s*(all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(-start|-done)?\(")


def collective_bytes(hlo_text: str, loop_trip_factor: int = 1) -> dict:
    """Loop-aware collective byte accounting of the partitioned HLO.

    Each collective's result bytes are multiplied by the execution count of
    its enclosing computation (while bodies run trip_count times but appear
    once in the text; trip counts are parsed from loop-condition constants).
    Tuple results and async -start/-done pairs are handled.
    ``loop_trip_factor`` is kept for API compat (unused; exact counts now).
    """
    comps, entry = _parse_computations(hlo_text)
    if entry is None:
        return {}
    mult = _loop_multipliers(comps, entry)
    out: dict[str, int] = {}
    for comp, lines in comps.items():
        m_c = mult.get(comp)
        if m_c is None:
            continue  # computation never reached from entry via loops: pure
            # helper (reduction adders, fusions) — collectives don't live there
        for line in lines:
            m = _COLL_OP_RE.search(line)
            if not m or m.group(3) == "-done":
                continue
            kind = m.group(2).lower()
            out[kind] = out.get(kind, 0) + int(_shape_bytes(m.group(1)) * m_c)
    return out


def batch_axes_for(specs: dict) -> dict:
    """Logical axes of the input batch."""
    ax = {}
    for k, v in specs.items():
        if v.ndim == 2:
            ax[k] = ("batch", None)
        elif v.ndim == 3:
            ax[k] = ("batch", None, "act_embed")
        else:
            ax[k] = tuple([None] * v.ndim)
    return ax



# ops that allocate or alias and move no bytes
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "detach", "lift_fresh",
                         "alias"})


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Inside ``with ByteCounter() as bc``: ``bc.bytes``, the input plus
    output bytes of every dispatched op that moves data (views and bare
    allocations excluded), and ``bc.ops``, their count."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (func.is_view
                or func._overloadpacket.__name__ in _NO_TRAFFIC):
            self.ops += 1
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def _specs(shardings) -> dict:
    """{checkpoint path: spec entries} of a tree of NamedShardings."""
    return {path: tuple(s.spec) for path, s in _flatten(shardings).items()}


def _sharded_bytes(tree, shardings) -> int:
    """Per-device bytes of a tree of tensors laid out by ``shardings``."""
    return sum(math.prod(s.shard_shape(tuple(t.shape))) * t.element_size()
               for t, s in zip(_flatten(tree).values(),
                               _flatten(shardings).values()))


def trace_step(cfg, kind: str, *, batch: int, seq: int, resolver: Resolver):
    """Run one step of ``kind`` ("train", "prefill" or "decode") at
    (batch, seq) on ``meta`` stand-ins under ``resolver``. Returns the
    traced FLOPs and bytes (whole step, every device's work together),
    the op count, the per-device argument bytes, the specs of the step's
    inputs, the constrain calls and the trace's seconds."""
    params, params_axes = M.init_model(None, cfg, device="meta")
    specs = M.input_specs(cfg, kind, batch=batch, seq=seq)
    batch_sh = map_with_axes(lambda v, ax: resolver.sharding_for(v.shape, ax),
                             specs, batch_axes_for(specs))
    shardings = {"batch": batch_sh}
    if kind == "train":
        state = train_loop.init_state(params)
        shardings["state"] = resolver.tree_shardings(
            state, train_loop.state_axes(params_axes))
        step_fn = train_loop.make_train_step(cfg)
        args, arg_sh = (state, specs), (shardings["state"], batch_sh)

        def run():
            return step_fn(state, specs)
    else:
        shardings["params"] = resolver.tree_shardings(params, params_axes)
        if kind == "prefill":
            args, arg_sh = (params, specs), (shardings["params"], batch_sh)

            def run():
                return M.prefill(params, cfg, specs)
        else:
            caches = M.cache_specs(cfg, batch, seq)
            shardings["caches"] = resolver.tree_shardings(caches,
                                                          M.cache_axes(cfg))
            args = (params, caches, specs)
            arg_sh = (shardings["params"], shardings["caches"], batch_sh)

            def run():
                return M.decode_step(params, cfg, caches, specs)

    n_constrain = len(resolver.constraints)
    t0 = time.perf_counter()  # audit: allow[host-sync] the trace's seconds
    with use_resolver(resolver), FlopCounterMode(display=False) as fc, \
            ByteCounter() as bc:
        run()
    seconds = time.perf_counter() - t0  # audit: allow[host-sync] as above
    calls = resolver.constraints[n_constrain:]
    distinct: dict = {}
    for shape, logical, spec in calls:
        key = (shape, logical, tuple(spec))
        distinct[key] = distinct.get(key, 0) + 1
    return dict(
        flops=float(fc.get_total_flops()), bytes=float(bc.bytes), ops=bc.ops,
        argument_bytes=_sharded_bytes(args, arg_sh),
        shardings={k: _specs(v) for k, v in shardings.items()},
        constrain_calls=len(calls),
        constrain_distinct=[dict(shape=list(k[0]), logical=list(k[1]),
                                 spec=list(k[2]), count=n)
                            for k, n in distinct.items()],
        seconds=seconds)


def roofline(flops: float, nbytes: float, coll_bytes: float) -> dict:
    """The three terms of one device's step, in seconds, on the H100
    constants above."""
    return {"compute_s": flops / PEAK_BF16, "memory_s": nbytes / HBM_BW,
            "collective_s": coll_bytes / COLL_BW}


def build_cell(arch: str, shape_name: str, *, multi_pod: bool,
               unroll: bool = False, overrides: dict | None = None,
               dp: int = 16, tp: int = 16, profile: str = "auto",
               dp_shard_map: bool = False, cfg=None):
    """Trace one cell; returns the result record.

    ``cfg`` is required (``arch`` only labels the record — the config zoo
    the name used to resolve against was removed as dead code).
    ``unroll=True`` sets ``scan_layers=False`` and ``microbatches=1`` as
    the reference does (the port's trace counts every trip either way).
    ``overrides``: ``dataclasses.replace`` overrides applied to the config.
    ``dp_shard_map`` (the reference's manual data parallelism) is recorded
    as a knob: the port's one-device step does the same total work."""
    if cfg is None:
        raise ValueError(
            f"build_cell({arch!r}, {shape_name!r}): pass cfg= explicitly — "
            "the LM config zoo was removed (dead code, flagged by "
            "`python -m repro.audit`)")
    if unroll:
        cfg = dataclasses.replace(cfg, scan_layers=False, microbatches=1)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    ok, reason = configs.shape_applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}

    shape = configs.SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, dp=dp, tp=tp)
    resolver = Resolver(mesh, profile=profile)
    n_chips = mesh.devices.size
    tr = trace_step(cfg, shape["kind"], batch=shape["batch"],
                    seq=shape["seq"], resolver=resolver)

    moe_ep = bool(cfg.moe and cfg.moe.e_pad % tp == 0)
    ac = cell_cost(arch, shape_name, multi_pod=multi_pod, dp=dp, tp=tp,
                   profile=profile, microbatches=cfg.microbatches,
                   moe_ep=moe_ep, cfg=cfg)
    flops_dev = tr["flops"] / n_chips
    bytes_dev = tr["bytes"] / n_chips
    coll_dev = ac.coll_bytes_device
    n_tokens = (shape["batch"] * shape["seq"]
                if shape["kind"] in ("train", "prefill") else shape["batch"])
    mflops = model_flops(cfg, n_tokens, train=shape["kind"] == "train")
    terms = roofline(flops_dev, bytes_dev, coll_dev)
    analytic = dict(roofline(ac.flops_device, ac.hbm_bytes_device,
                             ac.coll_bytes_device), notes=ac.notes)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(n) for n in mesh.shape.values()),
        "n_chips": int(n_chips),
        "trace_s": tr["seconds"],
        "traced_ops": tr["ops"],
        "per_device": {
            "traced_flops": flops_dev,
            "traced_bytes": bytes_dev,
            "collective_bytes": coll_dev,
            "split": "even: the traced totals / n_chips (the port "
                     "partitions nothing)",
            "collectives_from": "launch/costs.py cell_cost (no partitioned "
                                "program exists to read them from)",
        },
        "memory_analysis": {"argument_size_in_bytes": tr["argument_bytes"]},
        "shardings": tr["shardings"],
        "constrain_calls": tr["constrain_calls"],
        "constrain_distinct": tr["constrain_distinct"],
        "model_flops_total": mflops,
        "model_flops_per_device": mflops / n_chips,
        "useful_flops_ratio": ((mflops / n_chips) / flops_dev
                               if flops_dev else None),
        "roofline_terms_s": terms,
        "analytic_terms_s": analytic,
        "unrolled": unroll,
        "bottleneck": max(terms, key=terms.get),
        "params_total": cfg.param_count(),
        "params_active": active_params(cfg),
        "knobs": {"dp": dp, "tp": tp, "profile": profile,
                  "microbatches": cfg.microbatches,
                  "dp_shard_map": dp_shard_map},
    }


def main():
    """CLI stub: the zoo-driven sweep is retired.

    The per-cell sweep iterated the 10-architecture LM config zoo, which
    was removed as dead code (flagged by `python -m repro.audit`). The
    HLO-accounting helpers above (collective_bytes, _loop_multipliers,
    _shape_bytes) and build_cell with an explicit cfg remain the library
    API for roofline analysis.
    """
    print("repro_torch.launch.dryrun: the LM config zoo this sweep iterated "
          "was removed (dead code, flagged by `python -m repro.audit`).\n"
          "Use build_cell(arch_label, shape, cfg=<ArchConfig>, ...) from "
          "Python for single-cell roofline records.")
    raise SystemExit(0)


if __name__ == "__main__":
    main()
