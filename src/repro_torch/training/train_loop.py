"""The LM train step: microbatch gradient accumulation, mixed precision,
optional int8 gradient compression, AdamW (port of
``repro.training.train_loop``).

The reference scans over microbatches with the gradient sum as the carry;
the port loops over them and adds each microbatch's gradients into one
fp32 sum in place, in the same order. Data parallelism: the reference's
``dp_shard_map_mesh`` (per-shard ``value_and_grad``, then one ``pmean``)
is a :class:`~repro_torch.parallel.mesh.DataMesh` here: each shard's loss
and gradients are computed on its own device, then averaged on the first,
in one process (no ``torch.distributed``; ROADMAP §A).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models import model as model_lib
from .grad_compress import compress_decompress
from .optimizer import (AdamWState, _leaves, _map, adamw_init, adamw_update,
                        cosine_schedule, global_norm)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor      # 0-d int32


def init_state(params) -> TrainState:
    device = _leaves(params)[0].device
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def state_axes(params_axes):
    """Logical axes for the full TrainState (opt moments mirror params)."""
    return TrainState(
        params=params_axes,
        opt=AdamWState(step=(), mu=params_axes, nu=params_axes),
        step=(),
    )


def value_and_grad(cfg, params, batch):
    """(loss, grads) of ``model.loss_fn`` at ``params`` (unchanged; the
    gradient of a parameter the loss does not reach is zeros, as
    ``jax.grad`` gives)."""
    leaves = []

    def track(t):
        leaves.append(t.detach().requires_grad_(True))
        return leaves[-1]

    with torch.enable_grad():
        loss, _ = model_lib.loss_fn(_map(track, params), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    it = iter(grads)            # _map visits the leaves in one fixed order
    return loss.detach(), _map(lambda _: next(it), params)


def _shards(batch, n):
    """``n`` shards of the batch along its first axis when ``n`` divides
    it, else ``n`` copies (every shard computes the whole batch, as the
    reference replicates over mesh axes that do not divide it)."""
    bdim = next(iter(batch.values())).shape[0]
    if bdim % n:
        return [batch] * n
    return [{k: v[i * (bdim // n):(i + 1) * (bdim // n)]
             for k, v in batch.items()} for i in range(n)]


def make_train_step(cfg, *, base_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, weight_decay: float = 0.1,
                    grad_compression: str | None = None, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``mesh``: a ``DataMesh``; each shard of the batch (see :func:`_shards`)
    is differentiated on its own device with the parameters copied there,
    and the loss and gradients are averaged on the first device (the
    reference's one ``pmean`` per step)."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"grad_compression must be None or 'int8', got "
                         f"{grad_compression!r}")

    def grads_of(params, batch):
        if mesh is None:
            return value_and_grad(cfg, params, batch)
        home = _leaves(params)[0].device
        losses, grads = [], None
        for dev, shard in zip(mesh.devices, _shards(batch, len(mesh.devices))):
            p = _map(lambda t: t.to(dev), params)
            l, g = value_and_grad(cfg, p, {k: v.to(dev)
                                           for k, v in shard.items()})
            losses.append(l.to(home))
            g = _map(lambda t: t.to(home), g)
            grads = g if grads is None else _map(torch.add, grads, g)
        n = len(mesh.devices)
        return (torch.stack(losses).sum() / n,
                _map(lambda t: t / n, grads))

    def train_step(state: TrainState, batch):
        m = cfg.microbatches
        lr = cosine_schedule(state.step, base_lr=base_lr, warmup=warmup,
                             total=total_steps)
        if m > 1:
            grads = _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), state.params)
            losses = []
            for i in range(m):
                mb = {k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                l, g = grads_of(state.params, mb)
                _map(lambda acc, x: acc.add_(x), grads, g)
                losses.append(l)
                del g
            grads = _map(lambda g: g / m, grads)
            loss_val = torch.stack(losses).mean()
        else:
            loss_val, grads = grads_of(state.params, batch)

        if grad_compression == "int8":
            grads = compress_decompress(grads)

        params, opt = adamw_update(state.params, grads, state.opt, lr=lr,
                                   weight_decay=weight_decay)
        new_state = TrainState(params=params, opt=opt, step=state.step + 1)
        metrics = {"loss": loss_val, "lr": lr, "grad_norm": global_norm(grads)}
        return new_state, metrics

    return train_step
