"""The pricing every served response carries, in plain PyTorch.

The paper's energy model re-targeted to the reference package's machine
constants (TPU-v5e-style per-operation energies and clock): each add is a
float32 accumulate, each event is written to and read from its queue once,
and the membranes stay on chip. The numbers are outputs that a response
must carry, priced from its own statistics, and are compared exactly:
every input is an integer count and every step is a float32 operation on
the CPU, in this order.
"""
from __future__ import annotations

import math

import torch

E_FP32_ADD = 0.11       # pJ per membrane accumulate
E_HBM_BYTE = 15.0       # pJ per off-chip byte
E_VMEM_BYTE = 0.8       # pJ per on-chip byte
CLOCK_HZ = 940e6
EVENTS_PER_CYCLE = 9
LANES = 128
MEM_BYTES = 4           # a membrane potential read and written per add


def word_bytes(input_hw: int, compressed: bool, k: int = 3) -> int:
    """Bytes of one stored event word of the first conv's AE format (Sec.
    5.2, Eq. 6-7): two window coordinates, with in-band status when a
    coordinate field has a spare pattern, else two explicit status bits."""
    n_win = math.ceil(input_hw / k)
    bits = max(1, math.ceil(math.log2(n_win))) if n_win > 1 else 1
    spare = (1 << bits) - n_win
    nbits = 2 * bits if compressed and spare >= 1 else 2 * bits + 2
    return next(nb for nb in (1, 2, 4) if nbits <= 8 * nb)


def price(events_in, spikes_out, add_ops, *, input_hw: int,
          compressed: bool, vmem_resident: bool):
    """(energy J, latency s) per row, float32 CPU tensors, from (N, L)
    int32 statistics."""
    f32 = torch.float32
    adds = torch.as_tensor(add_ops).sum(-1, dtype=torch.int32).to(f32)
    events = torch.as_tensor(events_in).sum(-1, dtype=torch.int32).to(f32)
    spikes = torch.as_tensor(spikes_out).sum(-1, dtype=torch.int32).to(f32)
    compute = adds * E_FP32_ADD
    queue = (events + spikes) * word_bytes(input_hw, compressed)
    traffic = adds * MEM_BYTES
    if vmem_resident:
        hbm = queue * E_HBM_BYTE * 0.0
        vmem = (queue + traffic) * E_VMEM_BYTE
    else:
        hbm = (queue + traffic) * E_HBM_BYTE
        vmem = torch.zeros_like(hbm)
    total_pj = compute + hbm + vmem
    cycles = torch.maximum(adds / (EVENTS_PER_CYCLE * LANES), events)
    return total_pj * 1e-12, cycles / CLOCK_HZ
