"""Fault-tolerance runtime: heartbeats, straggler detection, elastic
restart (port of ``repro.runtime.fault_tolerance``).

Everything host-side is deterministic and unit-testable with a fake clock:

- ``HeartbeatMonitor``   : per-host liveness with configurable timeout; a
  host missing N beats is declared dead -> triggers elastic restart.
- ``StragglerDetector``  : EWMA of per-host step times (numpy, the
  reference's); hosts slower than ``factor`` x fleet median for
  ``patience`` consecutive steps are flagged.
- ``ElasticPlan``        : given the surviving device count, the new mesh
  shape (shrinking the model axis until it divides), the checkpoint step to
  resume from and a note.
- ``run_resilient``      : the training supervision loop — train step,
  async checkpoint every K steps, auto-resume on failure (simulated
  failures injectable for tests and the chip smoke).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..checkpoint.checkpoint import (AsyncCheckpointer, _tree_map,
                                     latest_step, restore)


@dataclasses.dataclass
class HeartbeatMonitor:
    n_hosts: int
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self.last_beat = {h: now for h in range(self.n_hosts)}

    def beat(self, host: int):
        self.last_beat[host] = self.clock()

    def dead_hosts(self) -> list[int]:
        now = self.clock()
        return [h for h, t in self.last_beat.items()
                if now - t > self.timeout_s]

    def all_alive(self) -> bool:
        return not self.dead_hosts()


@dataclasses.dataclass
class StragglerDetector:
    n_hosts: int
    factor: float = 1.8        # slower than factor x median -> straggling
    patience: int = 3          # consecutive flagged steps before action
    alpha: float = 0.3         # EWMA smoothing

    def __post_init__(self):
        self.ewma = np.zeros(self.n_hosts)
        self.strikes = np.zeros(self.n_hosts, dtype=int)

    def observe(self, step_times: np.ndarray) -> list[int]:
        """Feed per-host step durations; returns hosts to mitigate."""
        self.ewma = np.where(
            self.ewma == 0, step_times,
            self.alpha * step_times + (1 - self.alpha) * self.ewma)
        median = np.median(self.ewma)
        slow = self.ewma > self.factor * median
        self.strikes = np.where(slow, self.strikes + 1, 0)
        return [int(h) for h in np.nonzero(self.strikes >= self.patience)[0]]

    def rebalance_shares(self) -> np.ndarray:
        """Data shares inversely proportional to smoothed step time (soft
        mitigation before exclusion)."""
        w = 1.0 / np.maximum(self.ewma, 1e-9)
        return w / w.sum()


@dataclasses.dataclass
class ElasticPlan:
    surviving_devices: int
    resume_step: int
    mesh_shape: tuple
    note: str

    @staticmethod
    def make(surviving_devices: int, ckpt_root: str, model_parallel: int = 16):
        mp = model_parallel
        while mp > 1 and surviving_devices % mp != 0:
            mp //= 2
        step = latest_step(ckpt_root) or 0
        return ElasticPlan(
            surviving_devices=surviving_devices,
            resume_step=step,
            mesh_shape=(surviving_devices // mp, mp),
            note=f"re-mesh to {surviving_devices // mp}x{mp}, resume @ {step}",
        )


def _skeleton(state):
    """``state``'s structure with each tensor swapped for an empty one of
    its dtype and device: the template ``restore`` needs, so the caller
    can drop the state a restore replaces before the new one is built (on
    the card the two would not fit side by side at full width)."""
    return _tree_map(lambda t: t.new_empty((0,))
                     if isinstance(t, torch.Tensor) else t, state)


def run_resilient(
    *,
    train_step,
    state,
    batches,                 # iterable of batches
    ckpt_root: str,
    ckpt_every: int = 50,
    fail_at: dict | None = None,   # {step: exception} injected failures
    max_steps: int | None = None,
    on_metrics=None,
):
    """Supervised training loop with async checkpoints and auto-resume.

    Returns (final state, history). On an injected or real step failure
    (``RuntimeError`` or ``ValueError``, as the reference catches; a CUDA
    out-of-memory error is a ``RuntimeError``) the loop restores the newest
    valid checkpoint and continues — the behaviour a cluster supervisor
    provides across process boundaries, modeled in one process.

    As in the reference, the loop keeps drawing from one iterator: the
    steps a restore rolls back rerun on the stream's next batches, and the
    failing step's batch is consumed. The state being replaced is dropped
    before a restore builds the new one.
    """
    ckpt = AsyncCheckpointer(ckpt_root)
    history = []
    fail_at = dict(fail_at or {})

    step0 = latest_step(ckpt_root)
    if step0 is not None:
        skeleton, state = _skeleton(state), None
        state, _ = restore(ckpt_root, skeleton, step=step0)

    it = iter(batches)
    while True:
        step = int(state.step)  # audit: allow[host-sync] the loop's step counter
        if max_steps is not None and step >= max_steps:
            break
        try:
            batch = next(it)
        except StopIteration:
            break
        try:
            if step in fail_at:
                exc = fail_at.pop(step)
                raise exc
            state, metrics = train_step(state, batch)
            if on_metrics:
                on_metrics(step, metrics)
            history.append(float(metrics["loss"]))  # audit: allow[host-sync] the loss history
            if (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, state)
        except (RuntimeError, ValueError) as e:
            # node failure path: restore newest valid checkpoint and go on
            ckpt.wait()
            s = latest_step(ckpt_root)
            if s is None:
                raise RuntimeError("failure before first checkpoint") from e
            skeleton, state = _skeleton(state), None
            state, _ = restore(ckpt_root, skeleton, step=s)
    ckpt.wait()
    return state, history
