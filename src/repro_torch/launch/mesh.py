"""Production mesh construction (port of ``repro.launch.mesh``).

The reference's dry run lays its cells out on 16 x 16 = 256 chips (a
second ``pod`` axis doubles that) and forces 512 host devices to lower
them. The port's counterpart is a *virtual* mesh: every position names one
device, ``meta`` by default, so a cell's step can be traced at its full
shapes with nothing allocated and no environment variable set.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..sharding.resolver import Mesh


def make_production_mesh(*, multi_pod: bool = False, dp: int = 16,
                         tp: int = 16, device="meta") -> Mesh:
    """A (dp) x (tp) ``("data", "model")`` mesh, the reference's cell
    layout (16 x 16 by default); ``multi_pod`` adds a leading ``pod`` axis
    of 2. Every position is ``device``. dp/tp rebalancing is a cost-model
    knob (e.g. 32 x 8 halves the TP activation-collective domain at the
    cost of wider FSDP gathers)."""
    shape = (2, dp, tp) if multi_pod else (dp, tp)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.full(shape, torch.device(device), dtype=object), axes)


def make_host_mesh(device=None) -> Mesh:
    """A 1 x 1 ``("data", "model")`` mesh over one device: the card
    (``cuda:<current>``) unless the caller asks for another."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(np.full((1, 1), dev, dtype=object), ("data", "model"))
