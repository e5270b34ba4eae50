"""Image batches for the CNN trainer (port of
``repro.data.pipeline.image_batches``; the token stream and prefetcher are
template-era and stay in the reference)."""
from __future__ import annotations

import torch

from ..device import resolve_device


def image_batches(dataset: str, n: int, batch: int, *, seed: int = 0,
                  device=None):
    """Paper-wing image batches (mnist/svhn/cifar10 procedural sets) as
    ``{"image", "label"}`` tensors on ``device``; the arrays are the
    reference's for the same seed. A trailing partial batch is dropped, as
    there."""
    from .synthetic import DATASETS

    device = resolve_device(device)
    images, labels = DATASETS[dataset](n, seed=seed)
    images = torch.as_tensor(images, device=device)
    labels = torch.as_tensor(labels, device=device)
    for i in range(0, n - batch + 1, batch):
        yield {"image": images[i : i + batch], "label": labels[i : i + batch]}
