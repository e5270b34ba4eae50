"""Dense CNN baseline — the FINN counterpart (port of
``repro.core.cnn_baseline``).

The forward walks the same compiled :class:`~repro_torch.core.engine.LayerPlan`
the SNN backends execute. Activations are NHWC and conv weights HWIO at the
interface, as in the reference; inside, each conv is the engine's SAME conv
(``snn_layers.conv_same_nhwc``: ``F.conv2d`` with padding ``K // 2``). The
same forward serves float training, fake-quant (Brevitas-style) training
and the quantized pricing forward.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .engine import compile_plan, parse_spec  # noqa: F401  (re-export)
from .quantization import fake_quant, fake_quant_unsigned
from .snn_layers import conv_same_nhwc


class CNNCosts(NamedTuple):
    macs: int                 # multiply-accumulates (static per spec)
    weight_bytes: int
    act_bytes: int


def cnn_forward(params, spec: str, image: torch.Tensor, *,
                weight_bits: int | None = None, act_bits: int | None = None,
                return_acts: bool = False):
    """Forward pass of ``image`` (H, W, C) or (B, H, W, C). ReLU after every
    conv; the final dense layer has no activation. ``return_acts`` also
    returns every conv's (post-ReLU, post-quant) activation and the logits,
    the list conversion calibrates on."""
    batched = image.dim() == 4
    x = image if batched else image[None]
    plan = compile_plan(spec, int(x.shape[1]), int(x.shape[-1]))

    acts = []
    for cp in plan.convs:
        w, b = params[cp.index]["w"], params[cp.index]["b"]
        if weight_bits:
            w = fake_quant(w, weight_bits)
        x = F.relu(conv_same_nhwc(x, w) + b)
        if act_bits:
            x = fake_quant_unsigned(x, act_bits)
        acts.append(x)
        if cp.pool:
            p = cp.pool
            B, H, W, C = x.shape
            Ho, Wo = H // p, W // p
            x = x[:, : Ho * p, : Wo * p, :].reshape(
                B, Ho, p, Wo, p, C).amax(dim=(2, 4))

    w, b = params[plan.out.index]["w"], params[plan.out.index]["b"]
    if weight_bits:
        w = fake_quant(w, weight_bits)
    x = x.reshape(x.shape[0], -1) @ w + b
    acts.append(x)

    logits = x if batched else x[0]
    if return_acts:
        return logits, acts
    return logits


def cnn_costs(params, spec: str, input_hw: int, input_c: int,
              weight_bits: int = 8, act_bits: int = 8) -> CNNCosts:
    """Static MAC/byte counts for the dense pipeline (input-independent),
    in Python ints."""
    plan = compile_plan(spec, input_hw, input_c)
    macs = 0
    act_bytes = input_hw * input_hw * input_c * act_bits // 8
    weight_bytes = 0
    for cp in plan.convs:
        k = cp.kernel
        macs += cp.in_hw * cp.in_hw * k * k * cp.in_c * cp.out_c
        weight_bytes += (k * k * cp.in_c * cp.out_c * weight_bits) // 8 \
            + cp.out_c * 4
        act_bytes += cp.in_hw * cp.in_hw * cp.out_c * act_bits // 8
        if cp.pool:
            act_bytes += cp.out_hw * cp.out_hw * cp.out_c * act_bits // 8
    macs += plan.out.n_in * plan.out.n_out
    weight_bytes += (plan.out.n_in * plan.out.n_out * weight_bits) // 8 \
        + plan.out.n_out * 4
    return CNNCosts(macs, weight_bytes, act_bytes)


# ---------------------------------------------------------------------------
# Training (AdamW through autograd)
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels):
    """Mean negative log-likelihood of ``labels`` (class ids in [0, n)).

    An id past the net's ``n`` outputs (a net narrower than its dataset's
    classes, as the reference's small test nets are) makes the loss NaN
    and adds nothing to the gradient, as the reference's
    ``take_along_axis`` fill does.
    """
    logp = F.log_softmax(logits, dim=-1)
    n = logits.shape[-1]
    labels = labels.long()
    picked = torch.gather(logp, 1, labels.clamp(0, n - 1)[:, None])[:, 0]
    picked = torch.where(labels < n, picked,
                         torch.full_like(picked, float("nan")))
    return -picked.mean()


def make_train_step(spec: str, weight_bits=None, act_bits=None, lr=1e-3):
    """Returns ``(init_opt, step)``: ``step(params, opt_state, batch) ->
    (params, opt_state, loss)``, one AdamW step on the CNN params with
    gradients from autograd. Params go in and come out as plain tensors
    (no autograd history)."""
    from ..training.optimizer import adamw_init, adamw_update

    def step(params, opt_state, batch):
        leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                  for p in params]
        with torch.enable_grad():
            logits = cnn_forward(leaves, spec, batch["image"],
                                 weight_bits=weight_bits, act_bits=act_bits)
            loss = cross_entropy(logits, batch["label"])
            flat = [v for p in leaves for v in p.values()]
            grads_flat = torch.autograd.grad(loss, flat)
        it = iter(grads_flat)
        grads = [{k: next(it) for k in p} for p in leaves]
        params, opt_state = adamw_update(
            [{k: v.detach() for k, v in p.items()} for p in leaves], grads,
            opt_state, lr=lr)
        return params, opt_state, loss.detach()

    return adamw_init, step


def fraction_f32(mask: torch.Tensor) -> torch.Tensor:
    """The share of True in ``mask`` as a 0-d float32 tensor, rounded as
    the reference's compiled ``jnp.mean`` of a bool array: the count times
    float32 ``1 / n`` (its division by the constant ``n`` becomes a
    multiplication by the reciprocal), not the correctly rounded count/n."""
    recip = np.float32(1) / np.float32(mask.numel())
    return mask.sum(dtype=torch.float32) * torch.tensor(recip,
                                                        device=mask.device)


def accuracy(params, spec, images, labels, **quant):
    """Fraction of ``images`` whose argmax matches ``labels`` (a 0-d
    float32 tensor)."""
    logits = cnn_forward(params, spec, images, **quant)
    return fraction_f32(torch.argmax(logits, -1) == labels)
