"""What the comparison catches.

- The control (marker ``cuda``, run on the card at a cell's own size):
  the reference computed in the nearest precision below the one the
  configuration states, TF32 for float32 with TF32 off, put in the
  program's place. ``correct`` must come out false on every seed, and
  the readings are printed for the limits.
- The faults (on the CPU): a whole run of a small cell through the
  harness, with the served path broken underneath, must come out not
  correct: a plan that returns its previous outputs (state unchanged),
  half of each bucket left out, the shards' outputs not exchanged (a
  four-way mesh), an answer altered where it is produced; the faults a
  single card can have again under an open loop's mixed buckets.
"""
import numpy as np
import pytest
import torch

from bench.harness import judge, manifest, traffic, weights
from bench.reference import snn

from _tiny import ROOT, run_tiny, tiny_checkout

SEEDS = (11, 2**31 + 5, 987654321)


def control_readings(cfg, seed, device, n_requests):
    """The checks of the TF32 control's answers to ``n_requests`` draws
    from the pool, judged against the float32 reference."""
    net = cfg["net"]
    params, ths = weights.make(net, seed, device)
    pool = traffic.pool(cfg["dataset"], 1024, seed)
    idx = np.arange(len(pool))
    blk = cfg["reference_block"]
    ref = judge.reference_answers(
        snn.run_blocks(params, ths, net, pool, block=blk), net, idx, len(pool))
    ctl = judge.reference_answers(
        snn.run_blocks(params, ths, net, pool, block=blk, tf32=True), net,
        idx, len(pool))
    d = traffic.Draws(seed, len(pool))
    draws = np.fromiter((d.next() for _ in range(n_requests)), np.int64)
    served = {k: v[draws] for k, v in ctl.items()}
    served["rid"] = np.arange(n_requests)
    served["pred"] = served["logits"].argmax(1)
    return judge.compare(served, draws, n_requests, ref, cfg["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["cifar10", "svhn"])
def test_the_tf32_control_is_not_correct(config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    from repro_torch.device import resolve_device

    cfg = manifest.config(manifest.load(ROOT), config, ROOT)
    for seed in SEEDS:
        checks = control_readings(cfg, seed, resolve_device("cuda"), 120_000)
        print(f"[control] {config} seed {seed}: "
              + ", ".join(f"{k} {v!r}" for k, (v, _) in checks.items()))
        assert not judge.passed(checks)


# -- faults ---------------------------------------------------------------------

# Each replay fault stands in for ``replay(images, split)``, the call both
# plans share, and hands the step's split on, so the served step's phases
# are cut as they are on the sound path.

def stale_outputs(monkeypatch):
    """A plan that returns the outputs of its first call every time."""
    from repro_torch import obs
    from repro_torch.serve import registry

    real, first = registry.EagerPlan.replay, {}

    def replay(self, images, split=obs.NO_SPLIT):
        out = real(self, images, split)
        return first.setdefault(images.shape[0], out)
    monkeypatch.setattr(registry.EagerPlan, "replay", replay)


def half_batch(monkeypatch):
    """Only the first half of each bucket is computed; the rest is zeros."""
    from repro_torch import obs
    from repro_torch.core import engine
    from repro_torch.serve import registry

    real = registry.EagerPlan.replay

    def replay(self, images, split=obs.NO_SPLIT):
        b = images.shape[0]
        if b < 2:
            return real(self, images, split)
        logits, st = real(self, images[: b // 2], split)
        grow = lambda a: torch.cat([a, torch.zeros((b - len(a),) + a.shape[1:],
                                                   dtype=a.dtype)])
        return grow(logits), engine.SNNStats(*(grow(a) for a in st))
    monkeypatch.setattr(registry.EagerPlan, "replay", replay)


def no_exchange(monkeypatch):
    """Each shard's rows come back as the first shard's: nothing crosses
    between devices."""
    from repro_torch.serve import registry

    real = registry.gather

    def gather(outs, device):
        return real([outs[0]] * len(outs), device)
    monkeypatch.setattr(registry, "gather", gather)


def altered_answer(monkeypatch):
    """The first row of every bucket's logits is moved by 1e-3."""
    from repro_torch import obs
    from repro_torch.serve import registry

    real = registry.EagerPlan.replay

    def replay(self, images, split=obs.NO_SPLIT):
        logits, st = real(self, images, split)
        logits = logits.clone()
        logits[0] += 1e-3
        return logits, st
    monkeypatch.setattr(registry.EagerPlan, "replay", replay)


@pytest.mark.parametrize("fault,chips,cell_name", [
    (stale_outputs, 1, "tiny.closed"), (half_batch, 1, "tiny.closed"),
    (no_exchange, 4, "tiny.closed"), (altered_answer, 1, "tiny.closed"),
    (stale_outputs, 1, "tiny.open"), (half_batch, 1, "tiny.open"),
    (altered_answer, 1, "tiny.open")],
    ids=["state_unchanged", "half_batch", "no_exchange", "altered_answer",
         "state_unchanged.open", "half_batch.open", "altered_answer.open"])
def test_a_broken_served_path_is_not_correct(tmp_path, monkeypatch, fault,
                                             chips, cell_name):
    root = tiny_checkout(tmp_path, chips=chips)
    assert run_tiny(root, cell_name=cell_name)["correct"]
    fault(monkeypatch)
    r = run_tiny(root, cell_name=cell_name)
    assert not r["correct"], r["checks"]
