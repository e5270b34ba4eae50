"""The served net's weights, made from the run's seed on its device.

He-normal conv and classifier weights drawn by one ``torch.Generator`` on
the device in one call, conv biases 0.05, a zero classifier bias and unit
thresholds: the untrained serving set-up of the program's serve bench (a
conv with fewer than four output channels takes the absolute values, so
SVHN's 1C3 bottleneck is not silent). The benchmark draws them itself, so
that a change to the program's initialisation or training cannot change
what is served.
"""
from __future__ import annotations

import math

import torch

from ..reference import snn


def make(net: dict, seed: int, device) -> tuple[list, list]:
    """(params, thresholds): one {'w', 'b'} per spec token ({} for a
    pool), float32 tensors on ``device``; thresholds 0-d float32."""
    stages, head = snn.plan(net["spec"], net["input_hw"], net["input_c"])
    shapes = [(s.k, s.k, s.in_c, s.out_c) for s in stages]
    shapes.append((head.n_in, head.n_out))
    sizes = [math.prod(s) for s in shapes]
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(sizes), generator=gen, device=device)
    n_layers = len(snn.parse(net["spec"]))
    params: list[dict] = [{} for _ in range(n_layers)]
    for st, w in zip(stages, torch.split(z, sizes)):
        fan_in = st.k * st.k * st.in_c
        w = w.reshape(st.k, st.k, st.in_c, st.out_c) * math.sqrt(2 / fan_in)
        if st.out_c < 4:
            w = w.abs()
        params[st.index] = {"w": w, "b": torch.full((st.out_c,), 0.05,
                                                    device=device)}
    w = z[-sizes[-1]:].reshape(head.n_in, head.n_out)
    params[head.index] = {"w": w * math.sqrt(2 / head.n_in),
                          "b": torch.zeros((head.n_out,), device=device)}
    thresholds = [torch.ones((), device=device) for _ in range(n_layers)]
    return params, thresholds


def copy(params, thresholds):
    """Tensors of their own for the reference: nothing the program may
    touch in place is shared."""
    return ([{k: v.detach().clone() for k, v in p.items()} for p in params],
            [t.detach().clone() for t in thresholds])
