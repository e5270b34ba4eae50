"""AdamW on parameter trees (port of ``repro.training.optimizer``).

Written as the reference writes it, not as ``torch.optim.AdamW``: the
gradients are clipped by their global norm first, the bias corrections are
``1 - b ** step`` in float32, the denominator is ``sqrt(v / bc2) + eps``,
and weight decay defaults to 0. (``torch.optim.AdamW`` decays by 1e-2 by
default, has no clip and rounds its bias corrections differently.)
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch


def _map(fn, *trees):
    """``fn`` over the tensors of a parameter tree (nested dicts, lists,
    tuples and named tuples: the layer list of the SNN nets, the nested
    dicts of the LM stack), keeping the layout."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    """The tensors in the reference's leaf order (dict keys sorted, as
    ``jax.tree.leaves`` walks a dict)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    mu: Any
    nu: Any


def adamw_init(params) -> AdamWState:
    device = _leaves(params)[0].device
    zeros = _map(torch.zeros_like, params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros, nu=_map(torch.zeros_like, params))


def global_norm(tree) -> torch.Tensor:
    total = None
    for leaf in _leaves(tree):
        s = torch.sum(torch.square(leaf.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr=1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_clip: float | None = 1.0):
    """One AdamW step -> (new_params, new_state)."""
    step = state.step + 1

    if grad_clip is not None:
        gnorm = global_norm(grads)
        scale = torch.clamp(torch.full_like(gnorm, grad_clip) / (gnorm + 1e-12),
                            max=1.0)
        grads = _map(lambda g: g * scale, grads)

    mu = _map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = _map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)

    t = step.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=t.device)
    bc1 = 1 - torch.pow(torch.tensor(b1, **f32), t)
    bc2 = 1 - torch.pow(torch.tensor(b2, **f32), t)

    def upd(p, m, v):
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p
        return (p - lr * u).to(p.dtype)

    return _map(upd, params, mu, nu), AdamWState(step=step, mu=mu, nu=nu)


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """Linear warmup -> cosine decay, as a float32 tensor."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
