"""Energy/latency pricing of SNN stats (port of ``repro.core.energy``).

The constants are the reference's pricing-model inputs — order-of-magnitude
per-operation energies and the TPU v5e clock it prices latency with. They
are copied unchanged so that pricing stays identical to the reference; they
are model inputs, not measurements, and say nothing about an H100.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# --- energy constants [pJ] (pricing-model inputs) --------------------------
E_FP32_ADD = 0.11       # membrane potential accumulate (SNN is add-only)
E_HBM_BYTE = 15.0       # off-chip memory read/write per byte
E_VMEM_BYTE = 0.8       # on-chip memory per byte
CLOCK_HZ = 940e6        # the pricing model's accelerator clock (TPU v5e)
STATIC_POWER_W = 60.0   # the pricing model's per-chip baseline, for FPS/W


class EnergyBreakdown(NamedTuple):
    compute_pj: torch.Tensor
    hbm_pj: torch.Tensor
    vmem_pj: torch.Tensor
    total_pj: torch.Tensor
    latency_s: torch.Tensor

    @property
    def total_j(self):
        return self.total_pj * 1e-12

    def fps_per_w(self):
        """Frames/s/W at the latency-implied power (paper's FPS/W metric)."""
        power = self.total_j / self.latency_s
        return 1.0 / (self.latency_s * (power + STATIC_POWER_W))


def snn_energy(stats, *, word_bytes: int = 1, mem_bytes: int = 4,
               vmem_resident: bool = True, events_per_cycle: int = 9,
               lanes: int = 128) -> EnergyBreakdown:
    """Energy/latency for SNN inference from its stats, in float32.

    - every add_op is a fp32 accumulate (multiplier-less);
    - every event is written once + read once from the queue memory;
    - membrane potentials live on chip (``vmem_resident``) or off chip;
    - throughput: ``events_per_cycle`` events/cycle, each driving ``lanes``
      output-channel accumulates.
    """
    f32 = torch.float32
    adds = stats.add_ops.sum(-1, dtype=torch.int32).to(f32)
    events = stats.events_in.sum(-1, dtype=torch.int32).to(f32)
    spikes = stats.spikes_out.sum(-1, dtype=torch.int32).to(f32)

    compute = adds * E_FP32_ADD
    queue_bytes = (events + spikes) * word_bytes
    mem_traffic = adds * mem_bytes  # each accumulate reads+writes a potential
    if vmem_resident:
        hbm = queue_bytes * E_HBM_BYTE * 0.0  # queues stay on-chip too
        vmem = (queue_bytes + mem_traffic) * E_VMEM_BYTE
    else:
        hbm = (queue_bytes + mem_traffic) * E_HBM_BYTE
        vmem = torch.zeros_like(hbm)

    cycles = torch.maximum(adds / (events_per_cycle * lanes), events)
    latency = cycles / CLOCK_HZ
    return EnergyBreakdown(compute, hbm, vmem, compute + hbm + vmem, latency)


_FIELDS = ("events_in", "spikes_out", "add_ops", "overflow", "queue_words")


def reprice(stats, **kw) -> EnergyBreakdown:
    """Price recorded stats (an ``SNNStats`` of tensors or a ``StatsRecord``
    of numpy arrays) exactly like a fresh inference: all inputs are integer
    counts, so repricing is exact. Keywords as :func:`snn_energy`."""
    stats = stats._replace(**{f: torch.as_tensor(getattr(stats, f))
                              for f in _FIELDS})
    return snn_energy(stats, **kw)
