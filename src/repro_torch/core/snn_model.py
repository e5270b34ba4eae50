"""Parameters of the CNN/SNN shared layer list (port of ``repro.core.snn_model``).

Params are a list with one dict per spec token: ``{'w', 'b'}`` for conv
(HWIO weights) and dense layers, ``{}`` for pools — the reference's pytree
layout, with fp32 tensors in place of jax arrays.
"""
from __future__ import annotations

import math

import torch

from ..device import resolve_device
from .engine import compile_plan, to_device


def init_params(generator: torch.Generator, spec: str, input_hw: int,
                input_c: int, scale: float = 0.1, *, device=None):
    """He-style init drawn from ``generator`` (a CPU ``torch.Generator``).

    Same distributions as the reference's ``init_params`` (the numbers
    differ: torch and jax generators give different streams for one seed).
    ``scale`` is accepted for signature parity and unused, as there.
    """
    device = resolve_device(device)
    plan = compile_plan(spec, input_hw, input_c)
    params: list[dict] = [{} for _ in range(plan.n_layers)]
    for cp in plan.convs:
        fan_in = cp.kernel * cp.kernel * cp.in_c
        w = torch.randn((cp.kernel, cp.kernel, cp.in_c, cp.out_c),
                        generator=generator) * math.sqrt(2.0 / fan_in)
        if cp.out_c < 4:
            # ultra-narrow bottlenecks (the SVHN spec's 1C3): positive
            # weights, so the layer is not ReLU-dead from the start
            w = w.abs()
        params[cp.index] = {"w": w.to(device),
                            "b": torch.full((cp.out_c,), 0.05, device=device)}
    w = torch.randn((plan.out.n_in, plan.out.n_out), generator=generator)
    w = w * math.sqrt(2.0 / plan.out.n_in)
    params[plan.out.index] = {"w": w.to(device),
                              "b": torch.zeros((plan.out.n_out,),
                                               device=device)}
    return params


def params_from_numpy(params_np, thresholds, device=None):
    """The weight bridge: the reference's parameter list -> the port's.

    ``params_np`` is the JAX package's list of per-layer dicts of numpy
    ``w``/``b`` arrays (HWIO conv weights, (n_in, n_out) dense weights), as
    ``np.asarray`` of the jax pytree gives them. Layouts are shared, so
    this is a copy onto ``device``; returns ``(params, thresholds)`` with
    fp32 tensors and 0-d fp32 thresholds.
    """
    return to_device(params_np, thresholds, resolve_device(device))


def count_params(params) -> int:
    return sum(int(x.numel()) for p in params for x in p.values())
