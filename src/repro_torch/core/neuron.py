"""Integrate-and-Fire neuron dynamics (paper Eq. 1-2) as a pluggable registry.

Port of the inference half of ``repro.core.neuron``: the fire functions of
the three built-in modes and the registry the engine dispatches through,
plus the surrogate-derivative registry (names, primals and exact
gradients as plain tensor functions) that ``StudySpec`` validates against.
The straight-through spike built from a surrogate and the differentiable
fire functions belong to the direct-training slice.

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
    """

    name: str
    fire: FireFn
    pool_latch_once: bool


_REGISTRY: dict[str, NeuronModel] = {}


def register_neuron_model(name: str, fire: FireFn, *,
                          pool_latch_once: bool = False,
                          overwrite: bool = False) -> NeuronModel:
    """Register a neuron variant under ``name`` for use as ``SNNConfig.mode``."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"neuron mode {name!r} already registered")
    model = NeuronModel(name=name, fire=fire, pool_latch_once=pool_latch_once)
    _REGISTRY[name] = model
    return model


def get_neuron_model(name: str) -> NeuronModel:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown neuron mode {name!r}; registered modes: "
            f"{sorted(_REGISTRY)}") from None


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
# Surrogate derivatives (the registry; training through them is not ported)
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
    # window, so grad is exactly zero outside |x| >= 1/beta
    bx = beta * x
    inner = 0.5 + bx - torch.sign(x) * 0.5 * bx * bx
    return torch.clamp(torch.where(torch.abs(bx) >= 1.0,
                                   (torch.sign(x) + 1.0) * 0.5, inner),
                       0.0, 1.0)


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
