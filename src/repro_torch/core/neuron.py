"""Integrate-and-Fire neuron dynamics (paper Eq. 1-2) as a pluggable registry.

Port of ``repro.core.neuron``: the fire functions of the three built-in
modes and the registry the engine dispatches through, the surrogate
registry (names, primals and exact gradients as plain tensor functions),
and for direct training (``repro_torch.training.surrogate``) the
straight-through spike and a differentiable fire builder per mode:
:func:`surrogate_model` returns a forward-identical :class:`NeuronModel`
whose float spikes carry the surrogate's gradient through autograd.
Every registry write runs the :data:`_on_registry_change` hooks, through
which the engine and the data-parallel runner cache reset what they keep
per mode. The per-step API (:class:`IFState`, :func:`if_init`,
:func:`if_step`, :func:`if_run`) runs one population of neurons step by
step.

- ``if_reset``   : classic IF: reset to 0 after a spike.
- ``mttfs``      : spike-once latch, no reset (the paper's accelerator model).
- ``mttfs_cont`` : continuous emission once the threshold has been crossed.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

# fire(v_mem_after_input, latch, v_thresh) -> (v_mem, spikes_bool, latch)
FireFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                  tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


class NeuronModel(NamedTuple):
    """A registered neuron variant.

    ``fire`` consumes the membrane *after* the step's input has been
    integrated and returns ``(new_v, spike_mask, new_latch)``.
    ``pool_latch_once`` tells the fused max-pool whether a pooled output may
    fire only once (spike-once codes) or passes the OR every step.
    ``straight_through`` marks the surrogate models, whose spikes are
    float 0/1 values carrying a gradient: the fused max-pool then uses its
    differentiable form too.
    """

    name: str
    fire: FireFn
    pool_latch_once: bool
    straight_through: bool = False


_REGISTRY: dict[str, NeuronModel] = {}

# Callbacks run whenever a registry here changes: the engine's first-call
# tracking and plan cache, and the data-parallel runner cache, register
# their resets (they import this module, not the other way round)
_on_registry_change: list[Callable[[], None]] = []


def _changed() -> None:
    for hook in _on_registry_change:
        hook()


def register_neuron_model(name: str, fire: FireFn, *,
                          pool_latch_once: bool = False,
                          overwrite: bool = False) -> NeuronModel:
    """Register a neuron variant under ``name`` for use as ``SNNConfig.mode``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"neuron mode {name!r} already registered")
    model = NeuronModel(name=name, fire=fire, pool_latch_once=pool_latch_once)
    _REGISTRY[name] = model
    _changed()
    return model


def unregister_neuron_model(name: str) -> None:
    """Remove a registered variant (no-op if absent); runs the hooks only
    when something was removed."""
    if _REGISTRY.pop(name, None) is not None:
        _changed()


def get_neuron_model(name: str) -> NeuronModel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown neuron mode {name!r}; registered modes: "
            f"{sorted(_REGISTRY)}") from None


def available_modes() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _fire_if_reset(v, latch, vth):
    crossed = v > vth
    v = torch.where(crossed, torch.zeros_like(v), v)
    return v, crossed, latch | crossed


def _fire_mttfs(v, latch, vth):
    # spike at most once, no reset; the membrane keeps integrating
    crossed = v > vth
    return v, crossed & ~latch, latch | crossed


def _fire_mttfs_cont(v, latch, vth):
    crossed = v > vth
    return v, crossed, latch | crossed


register_neuron_model("if_reset", _fire_if_reset)
register_neuron_model("mttfs", _fire_mttfs, pool_latch_once=True)
register_neuron_model("mttfs_cont", _fire_mttfs_cont)

MODES = tuple(_REGISTRY)


# ---------------------------------------------------------------------------
# Surrogate derivatives (direct SNN training)
# ---------------------------------------------------------------------------

class Surrogate(NamedTuple):
    """A registered surrogate derivative for the spike nonlinearity.

    ``primal(x, beta)`` is a smooth relaxation of the Heaviside step and
    ``grad`` its exact derivative; outside ``|x| > clamp_width / beta`` the
    gradient is exactly zero (``None``: unbounded support).
    """

    name: str
    primal: Callable
    grad: Callable
    clamp_width: float | None


_SURROGATES: dict[str, Surrogate] = {}


def register_surrogate(name: str, primal: Callable, grad: Callable, *,
                       clamp_width: float | None = None,
                       overwrite: bool = False) -> Surrogate:
    """Register a surrogate derivative for use as a training ``surrogate=``."""
    if name in _SURROGATES and not overwrite:
        raise ValueError(f"surrogate {name!r} already registered")
    sg = Surrogate(name=name, primal=primal, grad=grad,
                   clamp_width=clamp_width)
    _SURROGATES[name] = sg
    _changed()
    return sg


def get_surrogate(name: str) -> Surrogate:
    try:
        return _SURROGATES[name]
    except KeyError:
        raise ValueError(
            f"unknown surrogate {name!r}; registered surrogates: "
            f"{sorted(_SURROGATES)}") from None


def available_surrogates() -> tuple[str, ...]:
    return tuple(sorted(_SURROGATES))


def _triangle_primal(x, beta):
    # piecewise-quadratic hard sigmoid: the antiderivative of the triangle
    # window, so grad is exactly zero outside |x| >= 1/beta. The clip is
    # jnp.clip's maximum-then-minimum, not torch.clamp: at a tie (an inner
    # value that rounds to exactly 1.0) both give half the gradient, where
    # clamp passes all of it
    bx = beta * x
    inner = 0.5 + bx - torch.sign(x) * 0.5 * bx * bx
    y = torch.where(torch.abs(bx) >= 1.0, (torch.sign(x) + 1.0) * 0.5, inner)
    return torch.minimum(torch.maximum(y, torch.zeros_like(y)),
                         torch.ones_like(y))


def _triangle_grad(x, beta):
    return beta * torch.clamp(1.0 - torch.abs(beta * x), min=0.0)


def _superspike_primal(x, beta):
    # fast sigmoid (Zenke & Ganguli SuperSpike): x/(1+|x|) rescaled to (0,1)
    bx = beta * x
    return 0.5 * (1.0 + bx / (1.0 + torch.abs(bx)))


def _superspike_grad(x, beta):
    denom = 1.0 + torch.abs(beta * x)
    return 0.5 * beta / (denom * denom)


def _stable_sigmoid(x):
    # the reference's tanh form, which avoids exp overflow on large |x|
    return 0.5 * (torch.tanh(0.5 * x) + 1.0)


def _sigmoid_primal(x, beta):
    return _stable_sigmoid(beta * x)


def _sigmoid_grad(x, beta):
    s = _stable_sigmoid(beta * x)
    return beta * s * (1.0 - s)


register_surrogate("triangle", _triangle_primal, _triangle_grad,
                   clamp_width=1.0)
register_surrogate("superspike", _superspike_primal, _superspike_grad)
register_surrogate("sigmoid", _sigmoid_primal, _sigmoid_grad)

SURROGATES = tuple(_SURROGATES)


def spike_fn(surrogate: str, beta: float) -> Callable:
    """The straight-through spike ``x -> heaviside(x)`` for one surrogate.

    Forward is bit-exactly ``(x > 0)`` in ``x``'s dtype — ``soft -
    soft.detach()`` is an exact float zero — so a surrogate model runs the
    same dynamics as the hard one; autograd differentiates the primal,
    as ``jax.grad`` does the reference's.
    """
    sg = get_surrogate(surrogate)

    def spike(x):
        soft = sg.primal(x, beta)
        hard = (x > 0).to(x.dtype)
        return hard + (soft - soft.detach())

    return spike


# mode name -> builder(spike) -> differentiable FireFn. The spikes come out
# float (exact 0/1 values) instead of bool; the latches stay bool and carry
# no gradient.
_SURROGATE_FIRE: dict[str, Callable] = {}


def register_surrogate_fire(mode: str, builder: Callable, *,
                            overwrite: bool = False) -> None:
    """Register the differentiable fire builder for neuron ``mode``:
    ``builder(spike)`` returns a :data:`FireFn` forward-identical to the
    mode's hard fire."""
    if mode in _SURROGATE_FIRE and not overwrite:
        raise ValueError(f"surrogate fire for mode {mode!r} already registered")
    _SURROGATE_FIRE[mode] = builder
    _changed()


def surrogate_model(mode: str, surrogate: str = "superspike",
                    beta: float = 10.0) -> NeuronModel:
    """A forward-identical, differentiable variant of neuron ``mode``: its
    spikes, membranes and latches equal the hard model's bit for bit, and
    autograd sees the surrogate derivative at every fire."""
    base = get_neuron_model(mode)
    try:
        builder = _SURROGATE_FIRE[mode]
    except KeyError:
        raise ValueError(
            f"neuron mode {mode!r} has no surrogate fire registered; "
            f"modes with one: {sorted(_SURROGATE_FIRE)}") from None
    return NeuronModel(
        name=f"{mode}~{surrogate}", fire=builder(spike_fn(surrogate, beta)),
        pool_latch_once=base.pool_latch_once, straight_through=True)


def _sg_fire_if_reset(spike):
    def fire(v, latch, vth):
        sp = spike(v - vth)
        # reset-to-zero as a multiplicative gate: value-identical to
        # where(crossed, 0, v), and the reset contributes -v * d(sp)/dv to
        # the membrane gradient
        v = v * (1.0 - sp)
        return v, sp, latch | (sp > 0)

    return fire


def _sg_fire_mttfs(spike):
    def fire(v, latch, vth):
        sp = spike(v - vth)
        # spike-once gate: the bool latch carries no gradient (the
        # first-spike selection is treated as constant), the crossing does
        sp = sp * (1.0 - latch.to(v.dtype))
        return v, sp, latch | (v > vth)

    return fire


def _sg_fire_mttfs_cont(spike):
    def fire(v, latch, vth):
        sp = spike(v - vth)
        return v, sp, latch | (sp > 0)

    return fire


register_surrogate_fire("if_reset", _sg_fire_if_reset)
register_surrogate_fire("mttfs", _sg_fire_mttfs)
register_surrogate_fire("mttfs_cont", _sg_fire_mttfs_cont)


# ---------------------------------------------------------------------------
# Stateful per-step API
# ---------------------------------------------------------------------------

class IFState(NamedTuple):
    """State of a population of IF neurons (any tensor shape)."""

    v_mem: torch.Tensor        # membrane potentials V_m
    has_spiked: torch.Tensor   # bool latch: the neuron has crossed threshold


def if_init(shape, dtype=torch.float32, device=None) -> IFState:
    return IFState(v_mem=torch.zeros(shape, dtype=dtype, device=device),
                   has_spiked=torch.zeros(shape, dtype=torch.bool,
                                          device=device))


def if_step(state: IFState, input_current: torch.Tensor, v_thresh, *,
            mode: str = "mttfs",
            leak: float = 0.0) -> tuple[IFState, torch.Tensor]:
    """One time step of Eq. (1)-(2): integrate ``input_current``, subtract
    ``leak`` (the leaky-IF extension; 0 in the paper), fire through the
    registered ``mode``. Returns ``(new_state, spikes)`` with ``spikes``
    0/1 in the membrane's dtype."""
    model = get_neuron_model(mode)
    v = state.v_mem + input_current
    if leak:
        v = v - torch.as_tensor(leak, dtype=v.dtype, device=v.device)
    vth = torch.as_tensor(v_thresh, dtype=v.dtype, device=v.device)
    v, spikes, latch = model.fire(v, state.has_spiked, vth)
    return IFState(v_mem=v, has_spiked=latch), spikes.to(v.dtype)


def if_run(input_currents: torch.Tensor, v_thresh, *, mode: str = "mttfs",
           leak: float = 0.0) -> torch.Tensor:
    """Run T steps of (T, *shape) input currents from a zero state; returns
    the (T, *shape) spike raster."""
    state = if_init(input_currents.shape[1:], input_currents.dtype,
                    input_currents.device)
    spikes = []
    for cur in input_currents:
        state, s = if_step(state, cur, v_thresh, mode=mode, leak=leak)
        spikes.append(s)
    return torch.stack(spikes)
