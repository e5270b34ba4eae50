"""The SNN execution engine (port of ``repro.core.engine``).

Static half: ``parse_spec`` / ``layer_geometry`` / ``compile_plan`` turn a
spec string ("32C3-32C3-P3-...-10") into a hashable :class:`LayerPlan`,
identical field by field to the reference's.

Dynamic half: :func:`infer_batch` walks the plan over a (B, H, W, C) batch
(:func:`infer` over one (H, W, C) sample) through one of the registered
backends:

- ``dense`` (:class:`DenseBackend`, the default of ``infer``,
  ``infer_batch`` and ``infer_batch_masked``, as in the reference): one
  SAME conv of each stage's whole spike raster, every queue statistic
  derived from the raster, nothing dropped; ``dense_unrolled`` convolves
  step by step;
- ``queue`` (``QueueBackend(accum="word")``): the word-level reference
  path — each stage's raster becomes packed address-event queues
  (``aeq.aeq_from_raster_batch``: the queue-encoder kernel on a CUDA
  tensor), accumulated into the membrane one time step at a time
  (``snn_layers.event_conv2d``: the event-accumulate kernel);
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

:func:`train_forward` is the differentiable walk of the dense plan for
direct training: the same time loop under a surrogate neuron model
(straight-through spikes), returning per-step output contributions and
per-stage spike rates for autograd.

Where the reference uses ``jax.vmap`` the batch axis is written out; where
it uses ``lax.scan(unroll=True)`` there is a Python loop over T; ``jit`` has
no counterpart (PyTorch runs eagerly), and the serving registry captures
:func:`batch_runner` in one CUDA graph per bucket where the reference
AOT-compiles it.

Tracing (``repro_torch.obs``): the first call of a ``(cfg, backend, B)``
key counts ``engine.jit_miss`` and runs inside an ``engine.jit_compile``
span (where the reference compiles; here the kernel libraries load and
cuDNN picks its algorithms), every later one ``engine.jit_hit``. A registry
change (``register_backend``, or any neuron or surrogate registry write,
through ``neuron._on_registry_change``) restarts that tracking and empties
the plan cache, as the reference's does.

``parallel.use_mesh`` installs :data:`_batch_dispatch`, through which
:func:`infer_batch` runs sharded over a device mesh.

Layouts match the reference at every public function: rasters are
channels-last (B, T, H, W, C), conv weights HWIO (K, K, C_in, C_out),
occupancy (N, C_in, K², P). Integer stats are int32.
"""
from __future__ import annotations

import functools
import re
from typing import NamedTuple, Protocol

import numpy as np
import torch
import torch.nn.functional as F

from .. import obs
from ..audit.contracts import BackendContract, QuantContract
from ..device import resolve_device
from . import encoding
from .aeq import (aeq_from_raster_batch, kernel_span, phase_occupancy,
                  segment_keep, span_map)
from .encoding import AEFormat, encode_ttfs
from .neuron import (NeuronModel, _on_registry_change, get_neuron_model,
                     surrogate_model)
from .quantization import quantize_symmetric
from .snn_layers import conv_same_nhwc, event_conv2d, spike_maxpool_hwc


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
                sp, cp.pool, p_latch, latch_once=model.pool_latch_once,
                straight_through=model.straight_through)
            return (v, latch, p_latch), sp
        return (v, latch), sp

    return step


def _init_carry(cp: ConvPlan, cfg: SNNConfig, vth, dtype):
    """One sample's (v, latch[, pool latch]).

    The membrane starts at ``v_init_frac * vth``, computed in fp32 like the
    reference's weakly typed product.
    """
    dev = vth.device
    v = (cfg.v_init_frac * vth.to(dtype)).expand(cp.in_hw, cp.in_hw, cp.out_c)
    latch = torch.zeros((cp.in_hw, cp.in_hw, cp.out_c), dtype=torch.bool,
                        device=dev)
    if cp.pool:
        p_latch = torch.zeros((cp.out_hw, cp.out_hw, cp.out_c),
                              dtype=torch.bool, device=dev)
        return (v, latch, p_latch)
    return (v, latch)


def _init_carry_batch(cp: ConvPlan, cfg: SNNConfig, vth, dtype, B: int):
    """The per-sample carry with a leading batch axis (same init values)."""
    return tuple(a.expand(B, *a.shape)
                 for a in _init_carry(cp, cfg, vth, dtype))


# ---------------------------------------------------------------------------
# Shared stat helpers of the dense backends
# ---------------------------------------------------------------------------

def _valid_offsets_map(hw: int, K: int, device=None) -> torch.Tensor:
    """(hw, hw) int32 map: in-bounds kernel offsets per spike position."""
    span = kernel_span(torch.arange(hw, dtype=torch.int32, device=device), K,
                       hw)
    return span[:, None] * span[None, :]


def _segment_occupancy(fmt: AEFormat, raster: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) raster -> (..., K, K, C) int32 per-(phase, channel)
    event counts.

    A spike at (y, x) lands in phase (y mod K)*K + (x mod K), so the segment
    occupancy is one pad + reshape + sum over the window grid.
    """
    K, n = fmt.kernel, fmt.n_win
    *lead, H, W, C = raster.shape
    m = F.pad(raster, (0, 0, 0, n * K - W, 0, n * K - H))
    m = m.reshape(*lead, n, K, n, K, C)
    return (m > 0).sum((-5, -3), dtype=torch.int32)


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

# A backend whose plan walk can be captured in a CUDA graph (no host sync,
# no host-sized tensor) has ``capture_refusal`` None; one that cannot says
# why, and serving refuses it on the card at registration. (Serving refuses
# ``host_dispatch`` backends, i.e. queue_sparse, on every device.)

class Backend(Protocol):
    """A compute unit for one conv stage of the layer pipeline (the
    reference's ``Backend``, in its batched form: the port runs batched
    plans only).

    ``conv_layer_batch`` receives the static :class:`ConvPlan`, the
    layer's weights, bias and threshold, and the incoming activity: a
    (B, T, H, W, C) spike ``raster`` or a (B, H, W, C) ``analog``
    constant-current image (exactly one is not None). It returns the
    emitted (B, T, H', W', C_out) raster and the per-sample
    :class:`LayerStats`. Neuron dynamics come from
    ``neuron.get_neuron_model(cfg.mode)`` so every backend stays in step.
    """

    name: str
    supports_batch: bool
    capture_refusal: str | None

    def conv_layer_batch(self, cp, w, b, vth, cfg, raster, analog):
        ...


class DenseBackend:
    """Dense-dynamics reference: one SAME conv of a stage's spike raster.

    The same mathematics as the queue paths (event-driven accumulation of
    a spike raster == dense convolution of it), with nothing dropped: every
    statistic is derived from the rasters — events_in = every spike,
    add_ops = in-bounds kernel offsets x C_out per spike, queue_words = the
    uncapped per-(step, phase, channel) segment occupancy, overflow = the
    occupancy past ``depth`` (counted, not dropped).

    ``dense`` convolves all B*T frames at once; ``dense_unrolled``
    (``unroll=True``) convolves step by step, as the reference's seed
    interpreter did. Both then run the shared time loop.
    """

    supports_batch = True
    capture_refusal = None

    def __init__(self, unroll: bool = False):
        self.unroll = unroll
        self.name = "dense_unrolled" if unroll else "dense"

    def conv_layer_batch(self, cp, w, b, vth, cfg, raster, analog):
        """raster (B, T, H, W, C) 0/1 or analog (B, H, W, C) -> the emitted
        (B, T, H', W', C_out) raster and a per-sample :class:`LayerStats`."""
        if raster is None:
            return _analog_layer(cp, cfg, analog, w, b, vth)
        B, T, H, W, C = raster.shape
        occ = _segment_occupancy(cp.fmt, raster)          # (B, T, K, K, C)
        q_words = occ.sum((1, 2, 3, 4), dtype=torch.int32)
        ovf = torch.clamp(occ - cfg.depth, min=0).sum((1, 2, 3, 4),
                                                      dtype=torch.int32)
        fired = raster > 0
        ev = fired.sum((1, 2, 3, 4), dtype=torch.int32)
        per_spike = _valid_offsets_map(cp.in_hw, cp.kernel, raster.device)
        ops = ((fired * per_spike[:, :, None]).sum((1, 2, 3, 4))
               * cp.out_c).to(torch.int32)
        if self.unroll:
            cur = torch.stack([conv_same_nhwc(raster[:, t], w)
                               for t in range(T)], dim=1)
        else:
            cur = conv_same_nhwc(raster.reshape(B * T, H, W, C), w)
            cur = cur.reshape(B, T, *cur.shape[1:])
        out = _run_steps(cp, cfg, vth, cur + b)
        return out, LayerStats(ev, out.sum((1, 2, 3, 4)).to(torch.int32),
                               ops, q_words, ovf)


class QueueBackend:
    """Event-driven conv stages through address-event queues.

    Faithful points (paper Sec. 3.1/4): spike-once latches via the neuron
    registry, no reset, bias as constant input current each step, pooling
    fused into emission, segmented fixed-depth queues. The batch axis is
    native: every kernel launch covers all B samples.

    ``accum="kernel"`` (the ``queue_pallas`` backend) runs the fused
    kernel B1; ``accum="ref"`` (the ``queue_ref`` backend) routes the same
    plan through the scatter oracles — slow, but the engine-level parity
    anchor ``queue_sparse`` is pinned against, and, like it, it executes
    ``cfg.weight_bits`` in the conv stages. ``accum="word"`` (the ``queue``
    backend) is the word-level reference path (:func:`_word_layer`).
    """

    supports_batch = True
    capture_refusal = None

    def __init__(self, accum: str = "kernel"):
        if accum not in ("kernel", "ref", "word"):
            raise ValueError(
                f"accum must be 'kernel', 'ref' or 'word', got {accum!r}")
        self.accum = accum
        self.name = {"kernel": "queue_pallas", "ref": "queue_ref",
                     "word": "queue"}[accum]
        if accum == "ref":
            self.capture_refusal = (
                "its scatter oracles find the surviving events with "
                "torch.nonzero, which waits for the device and sizes a "
                "tensor on the host (kernels/ref.py)")

    def conv_layer_batch(self, cp, w, b, vth, cfg, raster, analog):
        """raster (B, T, H, W, C) 0/1 or analog (B, H, W, C) -> the emitted
        (B, T, H', W', C_out) raster and a per-sample :class:`LayerStats`."""
        if raster is None:
            return _analog_layer(cp, cfg, analog, w, b, vth)
        if self.accum == "word":
            return _word_layer(cp, cfg, raster, w, b, vth)
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


def _run_steps(cp: ConvPlan, cfg: SNNConfig, vth, cur, model=None):
    """The time loop: (B, T, H, W, C_out) currents -> (B, T, H', W', C')
    emitted raster, under ``model`` (default: ``cfg.mode``'s hard fire)."""
    if model is None:
        model = get_neuron_model(cfg.mode)
    step = _conv_step(cp, model, vth)
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


def _word_layer(cp: ConvPlan, cfg: SNNConfig, raster, w, b, vth):
    """The word-level queue path of one event-driven stage.

    The (B, T, H, W, C) raster becomes every (sample, step, channel, phase)
    queue at once (``aeq_from_raster_batch``: one queue-encoder launch on
    the card); then each step adds its queued events into the carried
    membrane (``event_conv2d``: one event-accumulate launch over the B
    samples) and steps the neuron with the bias as the step's current — the
    reference's order of adds, not ``queue_pallas``'s single ``charge + b``
    current.
    """
    q = aeq_from_raster_batch(cp.fmt, raster.movedim(-1, 2), cfg.depth)
    ev = q.counts.sum((1, 2, 3), dtype=torch.int32)
    step = _conv_step(cp, get_neuron_model(cfg.mode), vth)
    carry = _init_carry_batch(cp, cfg, vth, w.dtype, raster.shape[0])
    ops = torch.zeros_like(ev)
    frames = []
    for t in range(cfg.T):
        v, n = event_conv2d(carry[0].contiguous(), w, q, cp.fmt, t)
        carry, sp = step((v, *carry[1:]), b)
        ops = ops + n
        frames.append(sp)
    out = torch.stack(frames, dim=1)
    return out, LayerStats(ev, out.sum((1, 2, 3, 4)).to(torch.int32), ops,
                           ev, q.overflow)


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

    A stage is three pieces, as the reference's three jitted ones
    (``_sparse_stats_fn``, ``_sparse_layer_fn``, ``_sparse_analog_fn``):
    :func:`_sparse_stats` (the stats and the gate's two device scalars,
    the only two cross-batch reductions of the backend), the gate
    :func:`_sparse_gate` (the host pulls) and :func:`_sparse_event_layer`;
    the analog first layer is :func:`_analog_layer`. ``gate_keys`` holds
    every (stage, ``e_cap``, ``n_rows``) the gate has produced: the
    counterpart of the reference's per-bucket jit caches, which the audit's
    recompilation harness holds flat on identical inputs.

    ``cfg.weight_bits`` selects the int-quantized accumulate (int8 weights,
    exact integer sums, one fp32 dequant) in the conv stages and the shared
    output head. Logits and stats are pinned bit-exact against
    ``queue_ref`` (``tests/test_torch_sparse.py``).
    """

    name = "queue_sparse"
    supports_batch = True
    host_dispatch = True

    def __init__(self):
        self.gate_keys: set = set()

    def conv_layer_batch(self, cp, w, b, vth, cfg, raster, analog):
        if raster is None:
            return _analog_layer(cp, cfg, analog, w, b, vth)
        occ, ev, ovf, ops, total, n_act = _sparse_stats(cp, cfg.depth, raster)
        e_cap, n_rows = _sparse_gate(cfg, occ.shape, total, n_act)
        self.gate_keys.add((cp, cfg, e_cap, n_rows))
        out = _sparse_event_layer(cp, cfg, occ, w, b, vth, e_cap, n_rows)
        return out, _event_stats(out, ev, ovf, ops)


def _sparse_stats(cp: ConvPlan, depth: int, raster):
    """One stage's queue stats plus the gate's two device scalars: the
    surviving-event total and the count of active (sample, step) rows —
    the backend's only two reductions over the batch (declared in
    :data:`BACKEND_CONTRACTS`); they size the work, never the numbers."""
    occ, tot, capped, ev, ovf, ops = _queue_stats(cp, depth, raster)
    total = capped.sum()                       # the occupancy gate ...
    n_act = (tot > 0).flatten(2).any(-1).sum()  # ... and active (b, t)
    return occ, ev, ovf, ops, total, n_act


def _sparse_gate(cfg: SNNConfig, occ_shape, total, n_act):
    """The occupancy gate: ``(e_cap, n_rows)`` of a stage from its two
    device scalars, pulled to the host."""
    from ..kernels.spike_sparse import event_bucket, max_kept_events

    B, T, C, K2, P = occ_shape
    # audit: allow[host-sync] the occupancy gate: one scalar per layer
    # sizes the event list
    total_host = total.item()
    # audit: allow[host-sync] the occupancy gate: the active-row count
    # sizes the ragged grid
    n_rows = n_act.item()
    e_cap = event_bucket(total_host,
                         max_kept_events((B * T, C, K2, P), cfg.depth))
    return e_cap, n_rows


def _sparse_event_layer(cp: ConvPlan, cfg: SNNConfig, occ, w, b, vth, e_cap,
                        n_rows):
    """The sparse accumulate of a stage's (B, T, C, K2, P) occupancy at the
    gate's sizes, then the time loop."""
    return _event_layer(cp, cfg, occ, w, b, vth, impl="sparse", e_cap=e_cap,
                        n_rows=n_rows, weight_bits=cfg.weight_bits)


_BACKENDS: dict[str, object] = {}


def register_backend(name: str, backend, *, overwrite: bool = False):
    if name in _BACKENDS and not overwrite:
        raise ValueError(f"backend {name!r} already registered")
    _BACKENDS[name] = backend
    _jit_seen.clear()      # a new backend may shadow a name already run
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


# ---------------------------------------------------------------------------
# Differentiable plan walk (direct SNN training — training.surrogate)
# ---------------------------------------------------------------------------

def _execute_diff(plan: LayerPlan, model: NeuronModel, cfg: SNNConfig,
                  params, thresholds, images):
    """The batched, grad-capable walk of the dense plan.

    The dynamics of :class:`DenseBackend` (one conv of a stage's B*T
    frames, the shared time loop) under a surrogate :class:`NeuronModel`,
    without the integer stats. Returns ``(step_logits (B, T, n_out), rates
    (B, n_convs))``: the output layer's per-step contribution ``flat @ w +
    b`` (its sum over T is the inference logits; the ``train`` and
    ``latency`` targets need the steps), and each conv stage's mean float
    spike rate, the differentiable event count behind the rate
    regularizer. The mean is the count times f32(1/n), as the reference's
    compiled ``jnp.mean`` rounds it.
    """
    raster, analog = _encode_input_batch(cfg, images)
    B = images.shape[0]
    rates = []
    for cp in plan.convs:
        w, b = params[cp.index]["w"], params[cp.index]["b"]
        if raster is not None:
            _, T, H, W, C = raster.shape
            cur = conv_same_nhwc(raster.reshape(B * T, H, W, C), w)
            cur = cur.reshape(B, T, *cur.shape[1:]) + b
        else:
            c1 = conv_same_nhwc(analog, w) + b
            cur = c1[:, None].expand(B, cfg.T, *c1.shape[1:])
        raster = _run_steps(cp, cfg, thresholds[cp.index], cur, model)
        analog = None
        recip = np.float32(1) / np.float32(raster[0].numel())
        rates.append(raster.sum((1, 2, 3, 4)) * float(recip))
    out = params[plan.out.index]
    step_logits = raster.reshape(B, cfg.T, -1) @ out["w"] + out["b"]
    return step_logits, torch.stack(rates, dim=1)


def train_forward(params, thresholds, cfg: SNNConfig, images, *,
                  surrogate: str = "superspike", beta: float = 10.0):
    """Batched differentiable forward through the engine's dense plan.

    Autograd of any scalar built from the outputs flows back through the
    time loop via the surrogate spike derivative registered for
    ``cfg.mode`` (``neuron.surrogate_model``); the forward values are the
    hard dynamics', so the net being trained is the net ``infer_batch``
    executes. Runs on the params' device (``images`` are moved there; on
    the card with TF32 off, as ``device.resolve_device`` sets it).

    Returns ``(step_logits (B, T, n_out), rates (B, n_convs))``.
    """
    plan = compile_plan(cfg.spec, cfg.input_hw, cfg.input_c, cfg.compressed)
    model = surrogate_model(cfg.mode, surrogate, beta)
    device = resolve_device(params[plan.out.index]["w"].device)
    images = torch.as_tensor(images, dtype=torch.float32, device=device)
    return _execute_diff(plan, model, cfg, params, tuple(thresholds), images)


def to_device(params, thresholds, device):
    """Params (list of {'w', 'b'}) and thresholds as fp32 tensors on ``device``."""
    params = [{k: torch.as_tensor(v, dtype=torch.float32, device=device)
               for k, v in layer.items()} for layer in params]
    thresholds = tuple(torch.as_tensor(t, dtype=torch.float32, device=device)
                       for t in thresholds)
    return params, thresholds


def batch_runner(cfg: SNNConfig, backend: str = "dense"):
    """The batched plan walk behind :func:`infer_batch`, for one (config,
    backend): ``run(params, thresholds, images) -> (logits, SNNStats)`` over
    tensors already on one device (see :func:`to_device`), under inference
    mode, with the plan compiled once here.

    The reference's ``batch_runner`` is the jit executable that its serving
    registry AOT-compiles per bucket; here the serving registry captures one
    CUDA graph of this call per bucket (``serve/registry.py``).
    """
    be = get_backend(backend)
    plan = compile_plan(cfg.spec, cfg.input_hw, cfg.input_c, cfg.compressed)

    @torch.inference_mode()
    def run(params, thresholds, images):
        return _execute_batch(plan, be, cfg, params, thresholds, images)

    return run


def infer_batch(params, thresholds, cfg: SNNConfig, images, *,
                backend: str = "dense", device=None):
    """Run a (B, H, W, C) batch; returns ``(logits (B, n_out), SNNStats)``.

    Runs on CUDA unless ``device="cpu"`` is passed (see
    ``device.resolve_device``); params and images are moved there.

    **Mask contract**: rows are independent — the convs batch over B, the
    time loop is elementwise per row, the kernels give each row its own
    blocks with a fixed summation order, and the fp32 head multiplies
    fixed-shape tiles — so row ``i`` does not depend on which other rows
    share the batch. Padding a bucket and slicing the valid prefix
    (:func:`infer_batch_masked`) equals the unpadded call, and so does
    splitting the batch over a device mesh (``repro_torch.parallel``).
    Inside ``parallel.use_mesh(mesh)`` this call runs sharded over ``mesh``
    (whose devices then decide placement, whatever ``device`` says).
    """
    if _batch_dispatch is not None:
        return _batch_dispatch(params, thresholds, cfg, images,
                               backend=backend)
    return _traced_call(cfg, backend, True, params, thresholds, images,
                        device)


# Batch dispatch override, installed and restored by ``parallel.use_mesh``:
# when set, ``infer_batch`` routes through the sharded executor. It must be
# bit-exact against the local path (the mask contract makes it so), which is
# why callers above the engine, the study's collect cache in particular,
# never need to know whether a mesh was active.
_batch_dispatch = None


# (cfg, backend, B) keys already run once in this process; B is None for
# ``infer`` (the reference's per-sample jit key)
_jit_seen: set = set()


def _first_call(key) -> bool:
    if key in _jit_seen:
        return False
    _jit_seen.add(key)
    return True


def images_on(images, device):
    """A batch (numpy or tensor) as a float32 tensor on ``device``; a
    tensor already in place is not copied."""
    return torch.as_tensor(np.asarray(images) if not torch.is_tensor(images)
                           else images, dtype=torch.float32, device=device)


def _traced_call(cfg, backend, batched, params, thresholds, images, device):
    """The batched call, counted as a first call or a repeat of its key
    (``infer``'s calls, ``batched=False``, have a key of their own)."""
    device = resolve_device(device)
    run = batch_runner(cfg, backend)
    params, thresholds = to_device(params, thresholds, device)
    images = images_on(images, device)
    B = images.shape[0] if batched else None
    if _first_call((cfg, backend, B)):
        obs.counter("engine.jit_miss")
        with obs.span("engine.jit_compile", backend=backend, B=B or 0,
                      spec=cfg.spec):
            return run(params, thresholds, images)
    obs.counter("engine.jit_hit")
    return run(params, thresholds, images)


def infer(params, thresholds, cfg: SNNConfig, image, *,
          backend: str = "dense", device=None):
    """Run one (H, W, C) sample; returns ``(logits (n_out,), SNNStats)``
    with per-sample stats ((L,) per field, overflow ()).

    The batch of one through :func:`infer_batch`, its batch axis stripped,
    so the result equals that sample's row of any batch it is part of.
    """
    logits, stats = _traced_call(cfg, backend, False, params, thresholds,
                                 image[None], device)
    return logits[0], SNNStats(*(a[0] for a in stats))


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
                       backend: str = "dense", device=None):
    """Run a padded (B, H, W, C) bucket; return only the valid prefix."""
    _check_n_valid(n_valid, images.shape[0])
    logits, stats = infer_batch(params, thresholds, cfg, images,
                                backend=backend, device=device)
    return slice_valid(logits, stats, n_valid)


register_backend("dense", DenseBackend())
register_backend("dense_unrolled", DenseBackend(unroll=True))
register_backend("queue", QueueBackend(accum="word"))
register_backend("queue_pallas", QueueBackend())
register_backend("queue_ref", QueueBackend(accum="ref"))
register_backend("queue_sparse", SparseQueueBackend())

# Declared trace intent per backend, verified by ``python -m
# repro_torch.audit`` (the reference's values). ``cross_batch_reductions``
# is the mask contract stated structurally: the number of reductions over
# the batch axis the backend's plan walk may contain — zero for every
# traced backend (padded rows must be bit-inert), and exactly two for the
# sparse backend's occupancy-gate stats (the global event total and the
# active-row count, both feeding the gate, never the numerics). A backend
# registered without a contract is an audit error.
BACKEND_CONTRACTS: dict[str, BackendContract] = {
    # dense additionally owns the differentiable training walk
    # (``train_forward``); its loss forward reduces over the batch exactly
    # twice by design — the batch-mean classification loss and the
    # batch-mean spike-rate regularizer (``audit.probe.trace_train_step``)
    "dense": BackendContract(name="dense", train_loss_reductions=2),
    "dense_unrolled": BackendContract(name="dense_unrolled"),
    "queue": BackendContract(name="queue"),
    "queue_pallas": BackendContract(name="queue_pallas"),
    "queue_ref": BackendContract(name="queue_ref", quant=QuantContract()),
    "queue_sparse": BackendContract(
        name="queue_sparse", cross_batch_reductions=2, host_dispatch=True,
        quant=QuantContract(), allowed_host_syncs=("occupancy-gate",)),
}

# a neuron or surrogate registry change restarts first-call tracking and
# drops the compiled plans, as a backend registration does
_on_registry_change.append(_jit_seen.clear)
_on_registry_change.append(compile_plan.cache_clear)
