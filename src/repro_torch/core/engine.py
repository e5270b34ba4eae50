"""The SNN execution engine (port of ``repro.core.engine``).

Static half: ``parse_spec`` / ``layer_geometry`` / ``compile_plan`` turn a
spec string ("32C3-32C3-P3-...-10") into a hashable :class:`LayerPlan`,
identical field by field to the reference's.

Dynamic half: :func:`infer_batch` walks the plan over a (B, H, W, C) batch
through one of three registered backends:

- ``queue_pallas`` (:class:`QueueBackend`, the serving default): each
  event-driven conv stage splits the incoming spike raster into per-phase
  window occupancy, derives the integer stats from it, and runs the fused
  compact+accumulate kernel (``kernels.ops.fused_spike_accum`` — the Hopper
  kernel on a CUDA tensor);
- ``queue_ref``: the same plan through the scatter oracles of
  ``kernels/ref.py``, honouring ``cfg.weight_bits`` — the parity anchor of
  ``queue_sparse``;
- ``queue_sparse`` (:class:`SparseQueueBackend`): the occupancy-gated
  sparse kernel, sized per layer from two scalars pulled to the host, with
  the int-quantized accumulate when ``cfg.weight_bits`` is set.

The analog first layer is a plain conv. The neuron fire and the fused
spike max-pool then run over T in a Python loop (``_conv_step``). The output
layer accumulates over T, through the int8 ``quant_matmul`` kernel when
``cfg.weight_bits`` is set.

Where the reference uses ``jax.vmap`` the batch axis is written out; where
it uses ``lax.scan(unroll=True)`` there is a Python loop over T; ``jit`` and
the runner cache have no counterpart (PyTorch runs eagerly).

Layouts match the reference at every public function: rasters are
channels-last (B, T, H, W, C), conv weights HWIO (K, K, C_in, C_out),
occupancy (N, C_in, K², P). Integer stats are int32.
"""
from __future__ import annotations

import functools
import re
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from . import encoding
from .aeq import phase_occupancy, segment_keep, span_map
from .encoding import AEFormat, encode_ttfs
from .neuron import NeuronModel, get_neuron_model
from .quantization import quantize_symmetric
from .snn_layers import conv_same_nhwc, spike_maxpool_hwc


class SpecError(ValueError):
    """A malformed or structurally invalid model spec string."""


# ---------------------------------------------------------------------------
# Spec parsing + validation (paper Table 6 grammar)
# ---------------------------------------------------------------------------

_CONV_RE = re.compile(r"^(\d+)C(\d+)$")
_POOL_RE = re.compile(r"^P(\d+)$")
_DENSE_RE = re.compile(r"^(\d+)$")


def parse_spec(spec: str) -> list[tuple]:
    """'32C3-32C3-P3-10C3-10' -> [('conv',32,3), ..., ('pool',3), ('dense',10)].

    Grammar (paper Table 6): ``nCk`` conv (n kernels of k x k, SAME, stride
    1), ``Pn`` max-pool (n x n, stride n, fused into the preceding conv's
    emission), trailing ``n`` fully connected. Raises :class:`SpecError` with
    the offending token on malformed input instead of failing deep inside
    inference.
    """
    if not isinstance(spec, str) or not spec.strip():
        raise SpecError(f"empty model spec {spec!r}")
    tokens = spec.split("-")
    layers: list[tuple] = []
    seen_conv = False
    for pos, tok in enumerate(tokens):
        if tok == "":
            where = ("leading" if pos == 0 else
                     "trailing" if pos == len(tokens) - 1 else "doubled")
            raise SpecError(f"{where} '-' in spec {spec!r}")
        if layers and layers[-1][0] == "dense":
            raise SpecError(
                f"token {tok!r} after the dense output layer in {spec!r} "
                "(the classifier must be the final token)")
        if m := _CONV_RE.match(tok):
            n, k = int(m.group(1)), int(m.group(2))
            if n < 1 or k < 1:
                raise SpecError(f"conv token {tok!r} in {spec!r}: "
                                "channels and kernel must be >= 1")
            if k % 2 == 0:
                raise SpecError(
                    f"conv token {tok!r} in {spec!r}: even kernels are not "
                    "supported (SAME padding and the AEQ phase interlacing "
                    "assume an odd kernel)")
            layers.append(("conv", n, k))
            seen_conv = True
        elif m := _POOL_RE.match(tok):
            if not seen_conv:
                raise SpecError(
                    f"pool token {tok!r} in {spec!r} before any conv layer "
                    "(pooling is fused into a preceding conv's emission)")
            if layers[-1][0] != "conv":
                raise SpecError(
                    f"pool token {tok!r} in {spec!r} must directly follow a "
                    "conv layer (back-to-back pools cannot be fused)")
            win = int(m.group(1))
            if win < 1:
                raise SpecError(f"pool token {tok!r} in {spec!r}: "
                                "window must be >= 1")
            layers.append(("pool", win))
        elif m := _DENSE_RE.match(tok):
            n = int(m.group(1))
            if n < 1:
                raise SpecError(f"dense token {tok!r} in {spec!r}: "
                                "width must be >= 1")
            layers.append(("dense", n))
        else:
            raise SpecError(
                f"malformed token {tok!r} in spec {spec!r} "
                "(expected nCk, Pn, or a trailing integer)")
    return layers


def layer_geometry(spec_layers, input_hw: int, input_c: int):
    """Static shape walk: per layer -> (type, in_hw, in_c, out_hw, out_c)."""
    hw, c = input_hw, input_c
    geo = []
    for ly in spec_layers:
        if ly[0] == "conv":
            geo.append(("conv", hw, c, hw, ly[1], ly[2]))
            c = ly[1]
        elif ly[0] == "pool":
            out = hw // ly[1]
            geo.append(("pool", hw, c, out, c, ly[1]))
            hw = out
        else:
            n_in = hw * hw * c
            geo.append(("dense", n_in, ly[1]))
    return geo


# ---------------------------------------------------------------------------
# The compiled layer plan
# ---------------------------------------------------------------------------

class ConvPlan(NamedTuple):
    """One conv stage (with its optional fused pool) of the pipeline."""

    index: int          # token index in the spec == params/thresholds slot
    in_hw: int          # input (== conv output) feature-map side
    in_c: int
    out_c: int
    kernel: int
    pool: int           # fused pool window (0 = no pool)
    out_hw: int         # side after the fused pool
    fmt: AEFormat       # AE word format of the *incoming* event queue


class OutPlan(NamedTuple):
    """The final fully-connected classifier (accumulates Vm, no threshold)."""

    index: int
    n_in: int
    n_out: int


class LayerPlan(NamedTuple):
    """Static execution plan for a spec — hashable, cached, backend-agnostic."""

    spec: str
    input_hw: int
    input_c: int
    compressed: bool
    n_layers: int                  # spec token count == len(params)
    convs: tuple[ConvPlan, ...]
    out: OutPlan


@functools.lru_cache(maxsize=None)
def compile_plan(
    spec: str, input_hw: int, input_c: int, compressed: bool = True
) -> LayerPlan:
    """Compile + validate ``spec`` for a given input geometry, once.

    The result is a pure-static NamedTuple (ints and formats only), so it is
    hashable and safely shared across backends and modules.
    """
    layers = parse_spec(spec)
    if layers[-1][0] != "dense":
        raise SpecError(
            f"spec {spec!r} must end with a dense classifier layer")
    if layers[0][0] != "conv":
        raise SpecError(f"spec {spec!r} must start with a conv layer")

    hw, c = input_hw, input_c
    convs: list[ConvPlan] = []
    li = 0
    while li < len(layers) - 1:
        ly = layers[li]
        # parse_spec guarantees only conv (+ directly-following pool) here
        cout, k = ly[1], ly[2]
        if k > hw:
            raise SpecError(
                f"spec {spec!r} layer {li}: kernel {k} exceeds the "
                f"{hw}x{hw} feature map")
        pool = 0
        if li + 1 < len(layers) - 1 and layers[li + 1][0] == "pool":
            pool = layers[li + 1][1]
            if pool > hw:
                raise SpecError(
                    f"spec {spec!r} layer {li + 1}: pool window {pool} "
                    f"exceeds the {hw}x{hw} feature map")
        out_hw = hw // pool if pool else hw
        convs.append(ConvPlan(
            index=li, in_hw=hw, in_c=c, out_c=cout, kernel=k,
            pool=pool, out_hw=out_hw,
            fmt=encoding.make_format(hw, k, compressed=compressed),
        ))
        c = cout
        hw = out_hw
        li += 2 if pool else 1

    n_in = hw * hw * c
    out = OutPlan(index=len(layers) - 1, n_in=n_in, n_out=layers[-1][1])
    return LayerPlan(
        spec=spec, input_hw=input_hw, input_c=input_c, compressed=compressed,
        n_layers=len(layers), convs=tuple(convs), out=out,
    )


# ---------------------------------------------------------------------------
# Configuration + statistics
# ---------------------------------------------------------------------------

class SNNConfig(NamedTuple):
    spec: str
    input_hw: int
    input_c: int
    T: int = 4                 # algorithmic time steps (paper: T=4)
    mode: str = "mttfs"        # neuron model variant (core/neuron.py registry)
    depth: int = 256           # AEQ depth D per (t, c, phase) segment
    compressed: bool = True    # compressed AE encoding (Sec. 5.2)
    input_mode: str = "analog" # 'analog' (constant current) | 'binary' (TTFS)
    input_theta: float = 0.1   # threshold for binary input encoding
    v_init_frac: float = 0.5   # initial charge as a fraction of V_t
    weight_bits: int | None = None
                               # None = fp32 everywhere; when set, the output
                               # layer runs the int8 quant_matmul head, and
                               # the queue_sparse / queue_ref conv stages
                               # accumulate int-quantized weights (the
                               # queue_pallas conv stages stay fp32)


class SNNStats(NamedTuple):
    """Per-sample accounting used by the energy model (int32 tensors)."""

    events_in: torch.Tensor    # (B, L) events consumed per weighted layer
    spikes_out: torch.Tensor   # (B, L) spikes emitted per layer
    add_ops: torch.Tensor      # (B, L) scalar accumulations performed
    overflow: torch.Tensor     # (B,)  dropped events across all AEQs
    queue_words: torch.Tensor  # (B, L) peak words resident per layer queue


class LayerStats(NamedTuple):
    """One stats row (one weighted layer); stacked into :class:`SNNStats`."""

    events_in: torch.Tensor
    spikes_out: torch.Tensor
    add_ops: torch.Tensor
    queue_words: torch.Tensor
    overflow: torch.Tensor


# ---------------------------------------------------------------------------
# Shared per-step body
# ---------------------------------------------------------------------------

def _conv_step(cp: ConvPlan, model: NeuronModel, vth):
    """Per-time-step body: integrate -> fire -> (fused) pool.

    Returns ``step(carry, current) -> (carry, spikes)`` over (B, H, W, C_out)
    tensors, where ``current`` already includes the bias term.
    """

    def step(carry, cur_t):
        if cp.pool:
            v, latch, p_latch = carry
        else:
            v, latch = carry
        v = v + cur_t
        v, sp, latch = model.fire(v, latch, vth)
        sp = sp.to(v.dtype)
        if cp.pool:
            sp, p_latch = spike_maxpool_hwc(
                sp, cp.pool, p_latch, latch_once=model.pool_latch_once)
            return (v, latch, p_latch), sp
        return (v, latch), sp

    return step


def _init_carry_batch(cp: ConvPlan, cfg: SNNConfig, vth, dtype, B: int):
    """(v, latch[, pool latch]) with a leading batch axis.

    The membrane starts at ``v_init_frac * vth``, computed in fp32 like the
    reference's weakly typed product.
    """
    dev = vth.device
    v = (cfg.v_init_frac * vth.to(dtype)).expand(B, cp.in_hw, cp.in_hw,
                                                 cp.out_c)
    latch = torch.zeros((B, cp.in_hw, cp.in_hw, cp.out_c), dtype=torch.bool,
                        device=dev)
    if cp.pool:
        p_latch = torch.zeros((B, cp.out_hw, cp.out_hw, cp.out_c),
                              dtype=torch.bool, device=dev)
        return (v, latch, p_latch)
    return (v, latch)


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

class QueueBackend:
    """Event-driven conv stages through the fused spike pipeline.

    Faithful points (paper Sec. 3.1/4): spike-once latches via the neuron
    registry, no reset, bias as constant input current each step, pooling
    fused into emission, segmented fixed-depth queues. The batch axis is
    native: all B*T queue-segment sets go through one kernel launch.

    ``accum="kernel"`` (the ``queue_pallas`` backend) runs the fused
    kernel B1; ``accum="ref"`` (the ``queue_ref`` backend) routes the same
    plan through the scatter oracles — slow, but the engine-level parity
    anchor ``queue_sparse`` is pinned against, and, like it, it executes
    ``cfg.weight_bits`` in the conv stages.
    """

    supports_batch = True

    def __init__(self, accum: str = "kernel"):
        if accum not in ("kernel", "ref"):
            raise ValueError(
                f"accum must be 'kernel' or 'ref', got {accum!r}")
        self.accum = accum
        self.name = {"kernel": "queue_pallas", "ref": "queue_ref"}[accum]

    def conv_layer_batch(self, cp, w, b, vth, cfg, raster, analog):
        """raster (B, T, H, W, C) 0/1 or analog (B, H, W, C) -> the emitted
        (B, T, H', W', C_out) raster and a per-sample :class:`LayerStats`."""
        if raster is None:
            return _analog_layer(cp, cfg, analog, w, b, vth)
        occ, _, _, ev, ovf, ops = _queue_stats(cp, cfg.depth, raster)
        if self.accum == "ref":
            out = _event_layer(cp, cfg, occ, w, b, vth, impl="ref",
                               weight_bits=cfg.weight_bits)
        else:
            out = _event_layer(cp, cfg, occ, w, b, vth)
        return out, _event_stats(out, ev, ovf, ops)


# The reference jits one program per stage (and per event bucket for the
# sparse backend); PyTorch runs eagerly, so the per-stage bodies are plain
# functions shared by all three backends.

def _queue_stats(cp: ConvPlan, depth: int, raster):
    """One event-driven stage's occupancy (B, T, C, K2, P), its per-queue
    totals (B, T, C, K2) uncapped and capped at ``depth``, and the per-sample
    stats (B,): events kept, events dropped, scalar adds."""
    occ = phase_occupancy(cp.fmt, raster)
    keep = segment_keep(occ, depth)
    tot = (occ > 0).sum(-1)
    capped = torch.clamp(tot, max=depth)
    ev = capped.sum((1, 2, 3)).to(torch.int32)
    ovf = (tot - capped).sum((1, 2, 3)).to(torch.int32)
    spans = span_map(cp.fmt, cp.in_hw, raster.device)      # (K2, P)
    ops = ((keep * spans).sum((1, 2, 3, 4)) * cp.out_c).to(torch.int32)
    return occ, tot, capped, ev, ovf, ops


def _event_stats(out, ev, ovf, ops):
    """The stats row of an event-driven stage; its queue words are its
    kept events."""
    return LayerStats(ev, out.sum((1, 2, 3, 4)).to(torch.int32), ops, ev,
                      ovf)


def _run_steps(cp: ConvPlan, cfg: SNNConfig, vth, cur):
    """The time loop: (B, T, H, W, C_out) currents -> (B, T, H', W', C')
    emitted raster."""
    step = _conv_step(cp, get_neuron_model(cfg.mode), vth)
    carry = _init_carry_batch(cp, cfg, vth, cur.dtype, cur.shape[0])
    frames = []
    for t in range(cfg.T):
        carry, sp = step(carry, cur[:, t])
        frames.append(sp)
    return torch.stack(frames, dim=1)


def _event_layer(cp: ConvPlan, cfg: SNNConfig, occ, w, b, vth, **accum):
    """Accumulate the (B, T, C, K2, P) occupancy through
    ``kernels.ops.fused_spike_accum`` (``accum`` picks the realization:
    the fused kernel, the sparse one or the oracles) and run the time loop
    on it plus the bias."""
    from ..kernels import ops as kops

    B = occ.shape[0]
    K2, P = occ.shape[-2:]
    cur = kops.fused_spike_accum(
        occ.reshape(B * cfg.T, cp.in_c, K2, P), w,
        K=cp.kernel, n_win=cp.fmt.n_win, bits=cp.fmt.bits_coord,
        depth=cfg.depth, H=cp.in_hw, W=cp.in_hw, **accum)
    cur = cur.reshape(B, cfg.T, cp.in_hw, cp.in_hw, cp.out_c) + b
    return _run_steps(cp, cfg, vth, cur)


def _analog_layer(cp: ConvPlan, cfg: SNNConfig, analog, w, b, vth):
    """The analog (constant-current) first layer — no events yet: one dense
    conv, the same current every step. Returns the raster and its stats."""
    B, H, W, C = analog.shape
    c1 = conv_same_nhwc(analog, w) + b                 # (B, H, W, C_out)
    out = _run_steps(cp, cfg, vth,
                     c1[:, None].expand(B, cfg.T, *c1.shape[1:]))
    z = torch.zeros((B,), dtype=torch.int32, device=w.device)
    ops = torch.full((B,), cfg.T * H * W * C * cp.out_c * cp.kernel
                     * cp.kernel, dtype=torch.int32, device=w.device)
    return out, LayerStats(z, out.sum((1, 2, 3, 4)).to(torch.int32), ops, z,
                           z)


class SparseQueueBackend:
    """Occupancy-gated sparse realization: the work drops with the rate.

    Same queue semantics (drop rule, stats, neuron registry) as
    ``queue_pallas``, but each event-driven stage pulls two scalars to the
    host — its surviving-event total and its active-row count — and sizes
    the sparse accumulate by them (``host_dispatch = True``): on the card
    the active-row count is B3's ragged grid (``n_rows``), on the CPU the
    bucketed event total is the plain version's list (``e_cap``).

    ``cfg.weight_bits`` selects the int-quantized accumulate (int8 weights,
    exact integer sums, one fp32 dequant) in the conv stages and the shared
    output head. Logits and stats are pinned bit-exact against
    ``queue_ref`` (``tests/test_torch_sparse.py``).
    """

    name = "queue_sparse"
    supports_batch = True
    host_dispatch = True

    def conv_layer_batch(self, cp, w, b, vth, cfg, raster, analog):
        from ..kernels.spike_sparse import event_bucket, max_kept_events

        if raster is None:
            return _analog_layer(cp, cfg, analog, w, b, vth)
        occ, tot, capped, ev, ovf, ops = _queue_stats(cp, cfg.depth, raster)
        total = capped.sum()                       # the occupancy gate ...
        n_act = (tot > 0).flatten(2).any(-1).sum()  # ... and active (b, t)
        N = raster.shape[0] * cfg.T
        K2, P = occ.shape[-2:]
        # audit: allow[host-sync] the occupancy gate: one scalar per layer
        # sizes the event list
        total_host = total.item()
        # audit: allow[host-sync] same gate: the active-row count sizes the
        # ragged grid
        n_rows = n_act.item()
        e_cap = event_bucket(
            total_host, max_kept_events((N, cp.in_c, K2, P), cfg.depth))
        out = _event_layer(cp, cfg, occ, w, b, vth, impl="sparse",
                           e_cap=e_cap, n_rows=n_rows,
                           weight_bits=cfg.weight_bits)
        return out, _event_stats(out, ev, ovf, ops)


_BACKENDS: dict[str, QueueBackend] = {}


def register_backend(name: str, backend, *, overwrite: bool = False):
    if name in _BACKENDS and not overwrite:
        raise ValueError(f"backend {name!r} already registered")
    _BACKENDS[name] = backend
    return backend


def get_backend(name: str):
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered backends: "
            f"{sorted(_BACKENDS)}") from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


# ---------------------------------------------------------------------------
# Shared execution driver
# ---------------------------------------------------------------------------

def _quant_head(counts, w, weight_bits: int):
    """int-quantized output matmul: (B, F) spike counts -> (B, N) fp32.

    Spike counts are exact small integers (scale 1); only the weights are
    quantized. Bias and stats are left to the caller.
    """
    from ..kernels import ops as kops

    w_q, w_scale = quantize_symmetric(w, weight_bits)
    one = torch.ones((), dtype=torch.float32, device=w.device)
    return kops.quant_matmul(counts.to(torch.int8).contiguous(),
                             w_q.contiguous(), one, w_scale)


_HEAD_TILE = 256  # rows of every fp32 head product: 64 samples x T=4


def _fp32_head(flat, w):
    """(B, T, F) spikes -> (B, N): a product per time step, then the sum
    over T, with row ``i`` independent of the batch it came in.

    The (B*T, F) rows are zero-padded to whole tiles of ``_HEAD_TILE`` and
    multiplied one fixed-shape tile at a time: cuBLAS picks its algorithm
    by M, so a product over all rows would sum a row's K terms in an order
    that depends on B. The sum over T is an explicit chain of adds, in
    ``t`` order, for the same reason.
    """
    B, T, F = flat.shape
    rows = flat.reshape(B * T, F)
    n_pad = -(-rows.shape[0] // _HEAD_TILE) * _HEAD_TILE
    if n_pad != rows.shape[0]:
        rows = torch.cat([rows, rows.new_zeros((n_pad - rows.shape[0], F))])
    prod = torch.cat([rows[i:i + _HEAD_TILE] @ w
                      for i in range(0, n_pad, _HEAD_TILE)])
    prod = prod[:B * T].reshape(B, T, -1)
    out = prod[:, 0]
    for t in range(1, T):
        out = out + prod[:, t]
    return out


def _output_layer_batch(params_out, T: int, raster, weight_bits=None):
    """Final dense layer: accumulate Vm over all T steps, no threshold.

    ``raster`` is (B, T, H, W, C), so the flatten is (H, W, C) order, as in
    the reference. fp32: a product per time step, then the sum over T
    (:func:`_fp32_head`); the quantized head sums the counts over T first.
    """
    w, b = params_out["w"], params_out["b"]
    B = raster.shape[0]
    flat = raster.reshape(B, T, -1)
    if weight_bits is not None and T <= 127:
        logits = _quant_head(flat.sum(1), w, weight_bits) + b * T
    else:
        logits = _fp32_head(flat, w) + b * T
    ev = (flat > 0).sum((1, 2)).to(torch.int32)
    z = torch.zeros((B,), dtype=torch.int32, device=raster.device)
    row = LayerStats(ev, z, ev * w.shape[1], z, z)
    return logits, row


def _encode_input_batch(cfg: SNNConfig, images):
    """(B, H, W, C) -> (raster (B, T, H, W, C), None) or (None, analog)."""
    if cfg.input_mode == "binary":
        raster = encode_ttfs(images, cfg.T, cfg.input_theta)   # (T, B, ...)
        return raster.movedim(0, 1), None
    if cfg.input_mode == "analog":
        return None, images
    raise ValueError(
        f"unknown input_mode {cfg.input_mode!r} (expected 'analog' or 'binary')")


def _execute_batch(plan: LayerPlan, backend, cfg: SNNConfig, params,
                   thresholds, images):
    """One plan walk over (B, ...) activity; stats with a leading (B,) axis."""
    if len(params) != plan.n_layers:
        raise ValueError(
            f"params list has {len(params)} layers but spec "
            f"{plan.spec!r} has {plan.n_layers}")
    if len(thresholds) != plan.n_layers:
        raise ValueError(
            f"thresholds list has {len(thresholds)} entries but spec "
            f"{plan.spec!r} has {plan.n_layers} layers")

    raster, analog = _encode_input_batch(cfg, images)
    rows: list[LayerStats] = []
    for cp in plan.convs:
        w, b = params[cp.index]["w"], params[cp.index]["b"]
        raster, row = backend.conv_layer_batch(
            cp, w, b, thresholds[cp.index], cfg, raster, analog)
        analog = None
        rows.append(row)

    logits, row = _output_layer_batch(params[plan.out.index], cfg.T, raster,
                                      cfg.weight_bits)
    rows.append(row)

    overflow = rows[0].overflow
    for r in rows[1:]:
        overflow = overflow + r.overflow
    stats = SNNStats(
        events_in=torch.stack([r.events_in for r in rows], dim=1),
        spikes_out=torch.stack([r.spikes_out for r in rows], dim=1),
        add_ops=torch.stack([r.add_ops for r in rows], dim=1),
        overflow=overflow,
        queue_words=torch.stack([r.queue_words for r in rows], dim=1),
    )
    return logits, stats


def to_device(params, thresholds, device):
    """Params (list of {'w', 'b'}) and thresholds as fp32 tensors on ``device``."""
    params = [{k: torch.as_tensor(v, dtype=torch.float32, device=device)
               for k, v in layer.items()} for layer in params]
    thresholds = tuple(torch.as_tensor(t, dtype=torch.float32, device=device)
                       for t in thresholds)
    return params, thresholds


@torch.inference_mode()
def infer_batch(params, thresholds, cfg: SNNConfig, images, *,
                backend: str = "queue_pallas", device=None):
    """Run a (B, H, W, C) batch; returns ``(logits (B, n_out), SNNStats)``.

    Runs on CUDA unless ``device="cpu"`` is passed (see
    ``device.resolve_device``); params and images are moved there.

    **Mask contract**: rows are independent — the convs batch over B, the
    time loop is elementwise per row, the fused and sparse kernels give
    each row its own blocks with a fixed summation order, and the fp32
    head multiplies fixed-shape tiles — so row ``i`` does not depend on
    which other rows share the batch. Padding a bucket and slicing the
    valid prefix (:func:`infer_batch_masked`) equals the unpadded call.
    """
    device = resolve_device(device)
    be = get_backend(backend)
    plan = compile_plan(cfg.spec, cfg.input_hw, cfg.input_c, cfg.compressed)
    params, thresholds = to_device(params, thresholds, device)
    images = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images)
                             else images, dtype=torch.float32, device=device)
    return _execute_batch(plan, be, cfg, params, thresholds, images)


def _check_n_valid(n_valid, B: int) -> None:
    if not isinstance(n_valid, int) or not 0 < n_valid <= B:
        raise ValueError(
            f"n_valid must be an int in [1, {B}], got {n_valid!r}")


def slice_valid(logits, stats, n_valid: int):
    """Drop padded slots: keep the first ``n_valid`` rows of batched output."""
    _check_n_valid(n_valid, logits.shape[0])
    if n_valid == logits.shape[0]:
        return logits, stats
    return logits[:n_valid], SNNStats(*(a[:n_valid] for a in stats))


def infer_batch_masked(params, thresholds, cfg: SNNConfig, images, n_valid, *,
                       backend: str = "queue_pallas", device=None):
    """Run a padded (B, H, W, C) bucket; return only the valid prefix."""
    _check_n_valid(n_valid, images.shape[0])
    logits, stats = infer_batch(params, thresholds, cfg, images,
                                backend=backend, device=device)
    return slice_valid(logits, stats, n_valid)


register_backend("queue_pallas", QueueBackend())
register_backend("queue_ref", QueueBackend(accum="ref"))
register_backend("queue_sparse", SparseQueueBackend())
