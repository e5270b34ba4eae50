"""Host data pipeline (port of ``repro.data.pipeline``): deterministic LM
token batches, a bounded background prefetcher, and image batches for the
CNN trainer.

Every token batch is derived from (seed, step, host_index): resuming at
step k regenerates the exact stream, and a re-sharded job re-slices the
same global stream. The ids are the reference's, integer for integer.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from .synthetic import make_tokens


class TokenStream:
    """Deterministic LM batches from the synthetic Markov corpus, as int32
    tensors on ``device`` (``None``: the card)."""

    def __init__(self, vocab: int, seq: int, global_batch: int, *,
                 seed: int = 0, host_index: int = 0, num_hosts: int = 1,
                 corpus_tokens: int = 2_000_000, device=None):
        self.vocab, self.seq = vocab, seq
        self.global_batch = global_batch
        self.host_batch = global_batch // num_hosts
        self.host_index = host_index
        self.seed = seed
        self.device = resolve_device(device)
        self.corpus = make_tokens(min(corpus_tokens, 4_000_000), vocab, seed)

    def batch(self, step: int) -> dict:
        """The host's shard of global batch ``step`` (pure function of step)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) % (2**63))
        starts = rng.integers(
            0, len(self.corpus) - self.seq - 1, size=self.global_batch)
        mine = starts[self.host_index * self.host_batch:
                      (self.host_index + 1) * self.host_batch]
        toks = np.stack([self.corpus[s: s + self.seq] for s in mine])
        labels = np.stack([self.corpus[s + 1: s + self.seq + 1] for s in mine])
        return {"tokens": torch.as_tensor(toks, device=self.device),
                "labels": torch.as_tensor(labels, device=self.device)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of an iterator (depth-bounded)."""

    def __init__(self, it, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.done = object()

        def worker():
            for item in it:
                self.q.put(item)
            self.q.put(self.done)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self.done:
                return
            yield item


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
        yield {"image": images[i: i + batch], "label": labels[i: i + batch]}
