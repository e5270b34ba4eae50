"""Probe traces: tiny, collision-free recordings of every engine path
(port of ``repro.audit.probe``, with the reference's probe geometry).

PyTorch has no jaxpr: a trace here is the list of aten ops a call
dispatches, recorded by :class:`Recorder` (a ``TorchDispatchMode``) — each
op's name, its arguments (tensors as :class:`TensorMeta`: shape, dtype,
device), its tensor outputs, and its anchor: the first stack frame under
``src/repro_torch/`` outside ``audit/`` (else the first caller frame
outside torch, e.g. a test's). The CUDA kernels are launched through
ctypes and are invisible to dispatch, so the recorder adds one
``kernel:<name>`` record per launch from the ``kernels._cuda.launch_counts``
deltas around the call.

The trace rules reason about *sizes* (e.g. "a reduction eliminated a
batch-sized axis"), so the probe geometry is chosen so no program dimension
can collide with a batch dimension:

- spec ``4C3-P2-6`` at 8x8x1 input, T=4, depth=8 — every static dim the
  trace can contain is in {1, 2, 3, 4, 6, 8, 9, 16, 64};
- batch size ``B_PROBE = 13`` (prime), so an axis whose size 13 divides
  *must* hold the batch (alone, as B*T = 52, or flattened with program
  axes, as the port's kept-bit words N·C_in·K²·⌈P/32⌉ are).

All probe inputs are zeros; each path runs once on them (under inference
mode where the engine runs it so: there the recorder sees composite ops
whole, ``aten.matmul``, ``aten.item``; elsewhere their decompositions,
``aten.mm``, ``aten._local_scalar_dense``).
"""
from __future__ import annotations

import functools
import os
import sys
from typing import NamedTuple

import torch
import torch.utils._pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..core import engine
from ..device import resolve_device
from ..kernels import _cuda
from .cli import repo_root

B_PROBE = 13
PROBE_SPEC = "4C3-P2-6"
PROBE_HW = 8
PROBE_C = 1
PROBE_T = 4
PROBE_DEPTH = 8

_AUDIT_DIR = os.path.dirname(os.path.abspath(__file__)) + os.sep
_PORT_DIR = os.path.dirname(_AUDIT_DIR.rstrip(os.sep)) + os.sep
_SKIP_DIRS = (os.path.dirname(os.path.abspath(torch.__file__)) + os.sep,
              os.path.dirname(os.path.abspath(os.__file__)) + os.sep,
              _AUDIT_DIR)


class TensorMeta(NamedTuple):
    """What the rules need of a tensor: its shape, dtype and device type."""
    shape: tuple
    dtype: torch.dtype
    device: str


class OpRecord(NamedTuple):
    """One dispatched aten op (or one kernel launch, ``kernel:<name>``)."""
    op: str            # overload, e.g. 'sum.dim_IntList'
    args: tuple        # tensors as TensorMeta, sequences as tuples
    kwargs: dict
    outs: tuple        # TensorMeta of every tensor output
    file: str          # repo-relative anchor ('-' for none)
    line: int

    @property
    def packet(self) -> str:
        """The op without its overload: 'sum' for 'sum.dim_IntList'."""
        return self.op.split(".")[0]

    def inputs(self):
        """Every TensorMeta among the arguments, in order."""
        for a in (*self.args, *self.kwargs.values()):
            if isinstance(a, TensorMeta):
                yield a
            elif isinstance(a, tuple):
                yield from (x for x in a if isinstance(x, TensorMeta))


def _meta(x):
    if isinstance(x, torch.Tensor):
        return TensorMeta(tuple(x.shape), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_meta(v) for v in x)
    return x


def _outs(out):
    if isinstance(out, torch.Tensor):
        return (_meta(out),)
    if isinstance(out, (list, tuple)):
        return tuple(m for o in out for m in _outs(o))
    return ()


def _anchor(root: str) -> tuple[str, int]:
    """The op's source line: the first frame under ``src/repro_torch/``
    outside ``audit/``, else the first frame outside torch, the standard
    library and the auditor."""
    fallback = None
    frame = sys._getframe(1)    # autograd's worker threads have no deeper
    while frame is not None:
        fn = os.path.abspath(frame.f_code.co_filename)
        if not fn.startswith(_SKIP_DIRS):
            if fn.startswith(_PORT_DIR):
                fallback = (fn, frame.f_lineno)
                break
            if fallback is None:
                fallback = (fn, frame.f_lineno)
        frame = frame.f_back
    if fallback is None:
        return "-", 0
    fn, line = fallback
    if fn.startswith(root.rstrip(os.sep) + os.sep):
        fn = os.path.relpath(fn, root)
    return fn, line


class Recorder(TorchDispatchMode):
    """Record every aten op dispatched inside ``with Recorder(root) as r``
    into ``r.records``, then one ``kernel:<name>`` record per CUDA kernel
    launched meanwhile (``kernels._cuda.launch_counts``)."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        self.records: list[OpRecord] = []

    def __enter__(self):
        self._launches = dict(_cuda.launch_counts)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        for name, n in _cuda.launch_counts.items():
            for _ in range(n - self._launches[name]):
                self.records.append(OpRecord(f"kernel:{name}", (), {}, (),
                                             "-", 0))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        file, line = _anchor(self.root)
        op = f"{func._overloadpacket.__name__}.{func._overloadname}"
        rec_args = _meta(tuple(args))
        rec_kwargs = {k: _meta(v) for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        self.records.append(OpRecord(op, rec_args, rec_kwargs, _outs(out),
                                     file, line))
        return out


def record(root: str, fn, *args, **kwargs) -> list[OpRecord]:
    """The trace of one call ``fn(*args, **kwargs)``: first an ``input``
    record whose outputs are the call's tensor arguments (the counterpart
    of a jaxpr's input variables), then the call's ops."""
    tensors = [x for x in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(x, torch.Tensor)]
    with Recorder(root) as rec:
        fn(*args, **kwargs)
    return [OpRecord("input", (), {}, _outs(tensors), "-", 0), *rec.records]


# ---------------------------------------------------------------------------
# Probe inputs
# ---------------------------------------------------------------------------

def probe_config(**overrides) -> engine.SNNConfig:
    cfg = engine.SNNConfig(spec=PROBE_SPEC, input_hw=PROBE_HW,
                           input_c=PROBE_C, T=PROBE_T, depth=PROBE_DEPTH)
    return cfg._replace(**overrides) if overrides else cfg


def batch_tainted_sizes(cfg: engine.SNNConfig, B: int = B_PROBE) -> frozenset:
    """Axis sizes that can only come from the batch (or batch*time) axis;
    the rules also count any size they divide (a flattened batch)."""
    return frozenset({B, B * cfg.T})


def _plan(cfg):
    return engine.compile_plan(cfg.spec, cfg.input_hw, cfg.input_c,
                               cfg.compressed)


def probe_params(plan: engine.LayerPlan, device=None):
    """Zero params matching the plan (pool slots are empty dicts)."""
    device = resolve_device(device)
    z = functools.partial(torch.zeros, dtype=torch.float32, device=device)
    params: list[dict] = [{} for _ in range(plan.n_layers)]
    for cp in plan.convs:
        params[cp.index] = {"w": z((cp.kernel, cp.kernel, cp.in_c, cp.out_c)),
                            "b": z((cp.out_c,))}
    params[plan.out.index] = {"w": z((plan.out.n_in, plan.out.n_out)),
                              "b": z((plan.out.n_out,))}
    return params


def probe_thresholds(plan: engine.LayerPlan, device=None):
    device = resolve_device(device)
    return tuple(torch.ones((), dtype=torch.float32, device=device)
                 for _ in range(plan.n_layers))


def probe_images(cfg: engine.SNNConfig, B: int = B_PROBE, device=None):
    device = resolve_device(device)
    return torch.zeros((B, cfg.input_hw, cfg.input_hw, cfg.input_c),
                       dtype=torch.float32, device=device)


def _geometry(cp, cfg):
    return dict(K=cp.kernel, n_win=cp.fmt.n_win, bits=cp.fmt.bits_coord,
                depth=cfg.depth, H=cp.in_hw, W=cp.in_hw)


# ---------------------------------------------------------------------------
# Probes
# ---------------------------------------------------------------------------

def trace_backend(backend_name: str, cfg: engine.SNNConfig | None = None,
                  B: int = B_PROBE, device=None, root: str | None = None):
    """The trace of the engine's batched plan (``engine.batch_runner``)
    for one traced backend."""
    cfg = cfg or probe_config()
    device = resolve_device(device)
    plan = _plan(cfg)
    runner = engine.batch_runner(cfg, backend_name)
    return record(root or repo_root(), runner, probe_params(plan, device),
                  probe_thresholds(plan, device), probe_images(cfg, B, device))


def trace_sparse_pieces(cfg: engine.SNNConfig | None = None,
                        B: int = B_PROBE, device=None,
                        root: str | None = None) -> dict:
    """The host-dispatch backend's per-stage pieces, each traced alone.

    ``queue_sparse`` cannot be traced as one batched plan (its plan walk
    pulls the occupancy total to the host between layers), so the audit
    walks each piece of ``SparseQueueBackend.conv_layer_batch``: the stats
    (which own the only two declared cross-batch reductions), the gate
    (the declared 'occupancy-gate' host pulls), the sparse layer at a fixed
    event bucket (``e_cap`` 64; on the card its ragged grid over every
    row), and the analog first-layer body — the reference's
    ``_sparse_stats_fn``, ``_sparse_layer_fn`` and ``_sparse_analog_fn``,
    and the gate between them.
    """
    cfg = cfg or probe_config()
    device = resolve_device(device)
    root = root or repo_root()
    cp = _plan(cfg).convs[0]
    K2 = cp.kernel * cp.kernel
    P = cp.fmt.n_win * cp.fmt.n_win
    z = functools.partial(torch.zeros, dtype=torch.float32, device=device)
    raster = z((B, cfg.T, cp.in_hw, cp.in_hw, cp.in_c))
    occ = torch.zeros((B, cfg.T, cp.in_c, K2, P), dtype=torch.int32,
                      device=device)
    w = z((cp.kernel, cp.kernel, cp.in_c, cp.out_c))
    b = z((cp.out_c,))
    vth = torch.ones((), dtype=torch.float32, device=device)
    analog = z((B, cp.in_hw, cp.in_hw, cp.in_c))
    with torch.inference_mode():
        _, _, _, _, total, n_act = engine._sparse_stats(cp, cfg.depth, raster)
        return {
            "engine._sparse_stats": record(
                root, engine._sparse_stats, cp, cfg.depth, raster),
            "engine._sparse_gate": record(
                root, engine._sparse_gate, cfg, occ.shape, total, n_act),
            "engine._sparse_event_layer": record(
                root, engine._sparse_event_layer, cp, cfg, occ, w, b, vth,
                64, None),
            "engine._analog_layer": record(
                root, engine._analog_layer, cp, cfg, analog, w, b, vth),
        }


def trace_train_step(cfg: engine.SNNConfig | None = None,
                     B: int = B_PROBE, device=None,
                     root: str | None = None) -> dict:
    """Traces of the direct-training path (``training.surrogate``).

    Two programs at the probe geometry:

    - ``training.loss_fn`` — the loss *forward* (surrogate spike dynamics +
      count target + rate regularizer). Batch purity runs against
      ``BackendContract.train_loss_reductions`` on this one: the loss's own
      batch-mean reductions are the only legal batch eliminations.
    - ``training.train_step`` — the full step: the forward, autograd's
      backward and the AdamW update. Only dtype/host-sync rules apply: the
      backward pass legitimately contracts the batch axis into every
      weight gradient.
    """
    from ..training.optimizer import adamw_init
    from ..training.surrogate import make_snn_train_step

    cfg = cfg or probe_config()
    device = resolve_device(device)
    root = root or repo_root()
    plan = _plan(cfg)
    params = probe_params(plan, device)
    step, loss_fn = make_snn_train_step(
        cfg, probe_thresholds(plan, device), target="count", rate_reg=0.01)
    images = probe_images(cfg, B, device)
    labels = torch.zeros((B,), dtype=torch.int32, device=device)
    opt = adamw_init(params)
    return {
        "training.loss_fn[count+rate_reg]": record(
            root, loss_fn, params, images, labels),
        "training.train_step": record(root, step, params, opt, images,
                                      labels),
    }


def trace_quant_kernels(cfg: engine.SNNConfig | None = None, device=None,
                        root: str | None = None) -> dict:
    """Traces of every int8-weight path, checked against QuantContract:
    B3's int path (``ops.fused_spike_accum(impl="sparse", weight_bits=8)``:
    its plain version on the CPU, its kernel's wrapper on the card) and
    the engine's quantized head (B2's plain version or wrapper) on
    ``device``; the two oracles of ``kernels/ref.py`` on the CPU, where
    they are the parity anchors (CUDA has no integer ``torch.matmul``)."""
    from ..kernels import ops as kops
    from ..kernels import ref as kref

    cfg = cfg or probe_config(weight_bits=8)
    device = resolve_device(device)
    root = root or repo_root()
    plan = _plan(cfg)
    cp = plan.convs[0]
    K2 = cp.kernel * cp.kernel
    P = cp.fmt.n_win * cp.fmt.n_win
    N = B_PROBE * cfg.T
    geo = _geometry(cp, cfg)
    cpu = torch.device("cpu")

    def occ(dev):
        return torch.zeros((N, cp.in_c, K2, P), dtype=torch.int32,
                           device=dev)

    def w(dev):
        return torch.zeros((cp.kernel, cp.kernel, cp.in_c, cp.out_c),
                           dtype=torch.float32, device=dev)

    a_q = torch.zeros((B_PROBE, plan.out.n_in), dtype=torch.int8)
    b_q = torch.zeros((plan.out.n_in, plan.out.n_out), dtype=torch.int8)
    one = torch.ones((), dtype=torch.float32)
    ref_geo = {k: v for k, v in geo.items() if k != "bits"}
    with torch.inference_mode():
        return {
            "kernels.fused_spike_accum_sparse[q8]": record(
                root, functools.partial(kops.fused_spike_accum, impl="sparse",
                                        e_cap=64, weight_bits=8, **geo),
                occ(device), w(device)),
            "kernels.ref.fused_spike_accum_quant_ref": record(
                root, functools.partial(kref.fused_spike_accum_quant_ref,
                                        weight_bits=8, **ref_geo),
                occ(cpu), w(cpu)),
            "kernels.ref.quant_matmul_ref": record(
                root, kref.quant_matmul_ref, a_q, b_q, one, one),
            "engine._quant_head[q8]": record(
                root, functools.partial(engine._quant_head, weight_bits=8),
                torch.zeros((B_PROBE, plan.out.n_in), dtype=torch.float32,
                            device=device),
                torch.zeros((plan.out.n_in, plan.out.n_out),
                            dtype=torch.float32, device=device)),
        }


def trace_kernels(cfg: engine.SNNConfig | None = None, device=None,
                  root: str | None = None) -> dict:
    """The counterpart of the reference's ``trace_pallas_kernels``: each
    kernel of B1, B3 and B4 through its dispatcher (``kernels.ops``) — its
    plain version on the CPU, the wrapper around the launch on the card
    (where the trace also holds the ``kernel:<name>`` launch)."""
    from ..kernels import ops as kops

    cfg = cfg or probe_config()
    device = resolve_device(device)
    root = root or repo_root()
    cp = _plan(cfg).convs[0]
    K = cp.kernel
    K2 = K * K
    P = cp.fmt.n_win * cp.fmt.n_win
    N = B_PROBE * cfg.T
    geo = _geometry(cp, cfg)
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    occ = torch.zeros((N, cp.in_c, K2, P), **i32)
    w = torch.zeros((K, K, cp.in_c, cp.out_c), **f32)
    words = torch.zeros((B_PROBE, cp.in_c, K2, cfg.depth), **i32)
    counts = torch.zeros((B_PROBE, cp.in_c, K2), **i32)
    vm = torch.zeros((B_PROBE, cp.in_hw, cp.in_hw, cp.out_c), **f32)
    with torch.inference_mode():
        return {
            "kernels.spike_pipeline.fused_spike_accum": record(
                root, functools.partial(kops.fused_spike_accum, **geo),
                occ, w),
            "kernels.spike_sparse.fused_spike_accum_sparse": record(
                root, functools.partial(kops.fused_spike_accum, impl="sparse",
                                        e_cap=64, **geo), occ, w),
            "kernels.event_accum.event_accum": record(
                root, functools.partial(kops.event_accum, K=K,
                                        n_win=cp.fmt.n_win,
                                        bits=cp.fmt.bits_coord),
                words, counts, w, vm),
        }


def launches(trace) -> dict[str, int]:
    """Kernel launches a trace holds, by kernel name."""
    out: dict[str, int] = {}
    for r in trace:
        if r.op.startswith("kernel:"):
            out[r.op[7:]] = out.get(r.op[7:], 0) + 1
    return out

