"""Direct SNN training with surrogate gradients (port of
``repro.training.surrogate``).

The spiking network is trained *through the engine's own plan*:
``engine.train_forward`` walks the dense backend's batched program under a
forward-identical surrogate neuron model (``core/neuron.surrogate_model``),
so autograd flows through the time loop and the net that comes out is the
net every inference backend executes. Thresholds stay at the unit values
conversion would normalize to, and the learned weights drop into
``collect`` / ``price`` / ``serve`` unchanged.

Loss targets (:data:`VALID_TARGETS`):

- ``count``   — cross-entropy on the time-summed output membrane (the
                spike-count readout; the default).
- ``train``   — per-step cross-entropy on the running (cumulative) membrane,
                averaged over T: the output must be right at every step.
- ``latency`` — cross-entropy on an early-weighted membrane sum (weights
                decay linearly over t), pushing decisions earlier.

Plus a spike-rate regularizer, ``rate_reg * mean(layer spike rates)``.

``step_counts["steps"]`` tallies executed optimizer steps, as
``study.stages.stage_counts`` tallies stage executions: a cache hit of
``train_snn`` runs zero.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..checkpoint import checkpoint
from ..core import engine
from ..core.cnn_baseline import cross_entropy
from ..core.snn_model import init_params
from ..device import resolve_device
from .optimizer import adamw_init, adamw_update

# the loss-target menu; StudySpec validation and make_snn_train_step both
# check against it
VALID_TARGETS = ["count", "train", "latency"]

step_counts: collections.Counter = collections.Counter()


def reset_step_counts() -> None:
    step_counts.clear()


def unit_thresholds(net: str, input_hw: int, input_c: int, *,
                    device=None) -> list:
    """Per-layer V_t = 1.0 as 0-d float32 tensors on ``device`` — the values
    a freshly trained net deploys with, one per spec layer (pool and output
    slots included), as ``conversion.convert``'s threshold list."""
    device = resolve_device(device)
    plan = engine.compile_plan(net, input_hw, input_c)
    return [torch.ones((), dtype=torch.float32, device=device)
            for _ in range(plan.n_layers)]


def target_loss(target: str, step_logits, labels):
    """One fp32 scalar from the (B, T, n_out) per-step output
    contributions."""
    if target == "count":
        return cross_entropy(step_logits.sum(1), labels)
    if target == "train":
        cum = torch.cumsum(step_logits, dim=1)           # running membrane
        T = step_logits.shape[1]
        return sum(cross_entropy(cum[:, t], labels) for t in range(T)) / T
    if target == "latency":
        T = step_logits.shape[1]
        w = torch.arange(T, 0, -1, dtype=step_logits.dtype,
                         device=step_logits.device)       # T, T-1, ..., 1
        w = w * (T / w.sum())                             # count's total mass
        return cross_entropy((step_logits * w[None, :, None]).sum(1), labels)
    raise ValueError(
        f"unknown loss target {target!r}; valid targets: {VALID_TARGETS}")


def make_snn_train_step(cfg: engine.SNNConfig, thresholds, *,
                        target: str = "count", rate_reg: float = 0.0,
                        surrogate: str = "superspike", beta: float = 10.0,
                        lr: float = 5e-3):
    """Build ``(step, loss_fn)`` for one training configuration.

    ``loss_fn(params, images, labels)`` is the differentiable loss forward;
    ``step(params, opt, images, labels)`` is one AdamW update with the
    gradients from autograd, returning ``(params, opt, loss)``. Params go
    in and come out as plain tensors (no autograd history).
    """
    if target not in VALID_TARGETS:
        raise ValueError(
            f"unknown loss target {target!r}; valid targets: {VALID_TARGETS}")
    thresholds = tuple(thresholds)

    def loss_fn(params, images, labels):
        step_logits, rates = engine.train_forward(
            params, thresholds, cfg, images, surrogate=surrogate, beta=beta)
        loss = target_loss(target, step_logits, labels)
        if rate_reg:
            loss = loss + rate_reg * rates.mean()
        return loss

    def step(params, opt, images, labels):
        leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                  for p in params]
        with torch.enable_grad():
            loss = loss_fn(leaves, images, labels)
            flat = [v for p in leaves for v in p.values()]
            grads_flat = torch.autograd.grad(loss, flat)
        it = iter(grads_flat)
        grads = [{k: next(it) for k in p} for p in leaves]
        params, opt = adamw_update(
            [{k: v.detach() for k, v in p.items()} for p in leaves], grads,
            opt, lr=lr)
        return params, opt, loss.detach()

    return step, loss_fn


def fit_snn(net: str, images, labels, *, T: int = 4, mode: str = "mttfs_cont",
            input_mode: str = "analog", input_theta: float = 0.1,
            v_init_frac: float = 0.5, epochs: int = 4, batch: int = 128,
            lr: float = 5e-3, target: str = "count", rate_reg: float = 0.0,
            surrogate: str = "superspike", beta: float = 10.0,
            init_seed: int = 0, ckpt_dir: str | None = None, device=None):
    """Train the SNN directly; returns ``(params, thresholds, final_loss)``,
    the loss a 0-d tensor of the last step.

    ``stages.fit_cnn``'s structure: the init from ``torch.Generator().
    manual_seed(init_seed)``, the reference's epoch shuffles
    (``np.random.default_rng(epoch)``), the training set moved to
    ``device`` once, and cuDNN's deterministic algorithms inside the loop
    (the previous setting restored after it), so one recipe trains one net.

    ``ckpt_dir`` turns on per-epoch fault tolerance: after each epoch the
    (params, opt) tree is committed with the epoch as the step number, and
    a restart restores the newest intact checkpoint and continues from the
    next epoch — bit-identical to the uninterrupted run, because the only
    loop state is (params, opt, epoch) and the shuffles are epoch-seeded.
    """
    device = resolve_device(device)
    images = np.asarray(images)
    labels = np.asarray(labels)
    hw, c = images.shape[1], images.shape[-1]
    params = init_params(torch.Generator().manual_seed(init_seed), net, hw, c,
                         device=device)
    thresholds = unit_thresholds(net, hw, c, device=device)
    cfg = engine.SNNConfig(
        spec=net, input_hw=hw, input_c=c, T=T, mode=mode,
        input_mode=input_mode, input_theta=input_theta,
        v_init_frac=v_init_frac)
    step, _ = make_snn_train_step(
        cfg, thresholds, target=target, rate_reg=rate_reg,
        surrogate=surrogate, beta=beta, lr=lr)
    opt = adamw_init(params)

    start_epoch = 0
    if ckpt_dir is not None and checkpoint.latest_step(ckpt_dir) is not None:
        (params, opt), start_epoch = checkpoint.restore(
            ckpt_dir, (params, opt))

    x = torch.as_tensor(images, dtype=torch.float32, device=device)
    y = torch.as_tensor(labels, device=device)
    loss = None
    # cuDNN's fastest backward convs add with atomics: without its
    # deterministic algorithms one recipe trains two nets, and a resume is
    # not bit-exact
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for epoch in range(start_epoch, epochs):
            perm = torch.as_tensor(np.random.default_rng(epoch).permutation(
                len(images)), device=device)
            for i in range(0, len(images), batch):
                idx = perm[i : i + batch]
                params, opt, loss = step(params, opt, x[idx], y[idx])
                step_counts["steps"] += 1
            if ckpt_dir is not None:
                checkpoint.save(ckpt_dir, epoch + 1, (params, opt))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return params, thresholds, loss
