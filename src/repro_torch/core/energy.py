"""Energy/latency pricing of SNN stats and of the dense CNN (port of
``repro.core.energy``).

The constants are the reference's pricing-model inputs — order-of-magnitude
per-operation energies, and the TPU v5e clock, peak rates and HBM bandwidth
it prices latency with. They are copied unchanged so that pricing stays
identical to the reference; they are model inputs, not measurements, and
say nothing about an H100.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# --- energy constants [pJ] (pricing-model inputs) --------------------------
E_FP32_ADD = 0.11       # membrane potential accumulate (SNN is add-only)
E_BF16_MAC = 0.25       # dense multiply-accumulate (the CNN above 8 bits)
E_INT8_MAC = 0.07       # quantized multiply-accumulate (the CNN at <= 8 bits)
E_HBM_BYTE = 15.0       # off-chip memory read/write per byte
E_VMEM_BYTE = 0.8       # on-chip memory per byte
E_REG_BYTE = 0.05       # register file per byte

# --- the reference's TPU v5e machine constants (pricing-model inputs, not
# H100 figures): the CNN's latency roofline and the SNN's clock ----------
PEAK_BF16_FLOPS = 197e12
PEAK_INT8_OPS = 394e12
HBM_BW = 819e9
CLOCK_HZ = 940e6
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
    """Price recorded stats (an ``SNNStats`` of tensors, a ``StatsRecord``
    — anything with an ``as_snn_stats()`` — or a stats tuple of numpy
    arrays) exactly like a fresh inference: all inputs are integer counts,
    so repricing is exact. Keywords as :func:`snn_energy`."""
    rehydrate = getattr(stats, "as_snn_stats", None)
    if rehydrate is not None:
        stats = rehydrate()
    else:
        stats = stats._replace(**{f: torch.as_tensor(getattr(stats, f))
                                  for f in _FIELDS})
    return snn_energy(stats, **kw)


class SNNStaticCosts(NamedTuple):
    """Input-independent SNN memory footprint, derived from the LayerPlan:
    bytes of queue (AEQ capacity) and of membrane state per conv stage —
    the re-target of the paper's Eq. 3-5 BRAM sizing."""

    queue_bytes: tuple      # per conv stage: T * C_in * K^2 * depth * word
    state_bytes: tuple      # per conv stage: H * W * C_out * 4 (fp32 Vm)
    total_queue_bytes: int
    total_state_bytes: int


def snn_static_costs(plan, *, T: int, depth: int, word_bytes: int = 1,
                     state_bytes_per_neuron: int = 4) -> SNNStaticCosts:
    """Static queue/membrane sizing for a compiled ``engine.LayerPlan``."""
    q = tuple(T * cp.in_c * cp.kernel * cp.kernel * depth * word_bytes
              for cp in plan.convs)
    s = tuple(cp.in_hw * cp.in_hw * cp.out_c * state_bytes_per_neuron
              for cp in plan.convs)
    return SNNStaticCosts(q, s, sum(q), sum(s))


def cnn_energy(costs, *, bits: int = 8,
               mxu_utilization: float = 0.5) -> EnergyBreakdown:
    """Energy/latency for one dense CNN inference (input-independent), as
    0-d float32 CPU tensors.

    The arithmetic is the reference's, op for op in float32: the MAC count
    converted once from its integer, the byte bound ``weight_bytes /
    HBM_BW`` taken in Python and rounded to float32 where the reference's
    ``jnp.maximum`` meets it.
    """
    def f32(x):  # one rounding: an int through int64, a float directly
        dtype = torch.int64 if isinstance(x, int) else torch.float32
        return torch.tensor(x, dtype=dtype).to(torch.float32)

    macs = f32(costs.macs)
    e_mac = E_INT8_MAC if bits <= 8 else E_BF16_MAC
    peak = PEAK_INT8_OPS if bits <= 8 else PEAK_BF16_FLOPS

    compute = macs * e_mac
    hbm = f32(costs.weight_bytes) * E_HBM_BYTE
    vmem = f32(costs.act_bytes) * E_VMEM_BYTE * 2  # read + write

    latency = torch.maximum(2.0 * macs / f32(peak * mxu_utilization),
                            f32(costs.weight_bytes / HBM_BW))
    return EnergyBreakdown(compute, hbm, vmem, compute + hbm + vmem, latency)
