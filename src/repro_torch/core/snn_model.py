"""Parameters of the CNN/SNN shared layer list, and the inference wrappers
(port of ``repro.core.snn_model``).

Params are a list with one dict per spec token: ``{'w', 'b'}`` for conv
(HWIO weights) and dense layers, ``{}`` for pools — the reference's pytree
layout, with fp32 tensors in place of jax arrays. ``params_from_numpy`` /
``params_to_numpy`` carry them across to and from the reference's numpy
lists; ``snn_infer`` / ``snn_dense_infer`` (and their batch forms) are the
engine's ``queue`` and ``dense`` calls.
"""
from __future__ import annotations

import math

import torch

from ..device import resolve_device
from .engine import compile_plan, infer, infer_batch, to_device


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


def params_to_numpy(params):
    """The inverse bridge: the port's parameter list -> the reference's
    list of per-layer dicts of float32 numpy arrays (host copies)."""
    # audit: allow[host-sync] the bridge's purpose: host copies
    return [{k: v.detach().cpu().numpy() for k, v in layer.items()}
            for layer in params]


def count_params(params) -> int:
    return sum(int(x.numel()) for p in params for x in p.values())


# ---------------------------------------------------------------------------
# Inference wrappers (one engine, two backends)
# ---------------------------------------------------------------------------

def snn_infer(params, thresholds, cfg, image, *, device=None):
    """One (H, W, C) sample through the word-level queue path (the
    accelerator-faithful AEQ execution); returns ``(logits, SNNStats)``."""
    return infer(params, thresholds, cfg, image, backend="queue",
                 device=device)


def snn_infer_batch(params, thresholds, cfg, images, *, device=None):
    return infer_batch(params, thresholds, cfg, images, backend="queue",
                       device=device)


def snn_dense_infer(params, thresholds, cfg, image, *, device=None):
    """One sample through the dense-dynamics reference path; its stats
    equal the queue path's whenever no queue overflows."""
    return infer(params, thresholds, cfg, image, backend="dense",
                 device=device)


def snn_dense_infer_batch(params, thresholds, cfg, images, *, device=None):
    return infer_batch(params, thresholds, cfg, images, backend="dense",
                       device=device)
