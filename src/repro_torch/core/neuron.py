"""Integrate-and-Fire neuron dynamics (paper Eq. 1-2) as a pluggable registry.

Port of the inference half of ``repro.core.neuron``: the fire functions of
the three built-in modes and the registry the engine dispatches through.
Surrogate gradients belong to the training slice.

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
