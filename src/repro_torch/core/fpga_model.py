"""The paper's analytical FPGA BRAM cost model (Eq. 3-5, Table 5) — a copy of
``repro.core.fpga_model``, pure Python.

Kept as the cross-check between the accelerator re-target and the paper's
numbers: it reproduces every Table 5 row exactly.
"""
from __future__ import annotations

import math
from typing import NamedTuple


def bram_words(w: int) -> int:
    """Eq. (3): words per 36Kb Xilinx BRAM at word width w."""
    if 18 < w <= 36:
        return 1024
    if 9 < w <= 18:
        return 2048
    if 4 < w <= 8:
        return 4096
    if 2 < w <= 4:
        return 8192
    if w == 2:
        return 16384
    if w == 1:
        return 32768
    raise ValueError(f"unsupported BRAM word width {w}")


def ceil_bram(n: float) -> float:
    """Eq. (4): smallest instantiable unit is half a BRAM."""
    return math.ceil(2 * n) / 2


def n_bram(P: int, K2: int, D: int, w: int) -> float:
    """Eq. (5): #BRAM = P * K^2 * ceil_BRAM(D / #words(w)).

    (The paper writes K for the number of interlaced queues, which is the
    kernel size *squared* — cf. Table 5 where K2=9 reproduces all rows.)
    """
    return P * K2 * ceil_bram(D / bram_words(w))


class SNNMemoryPlan(NamedTuple):
    bram_aeq: float
    bram_membrane: float
    bram_weights: float
    bram_total: float


def snn_memory_plan(
    *, P: int, K: int = 3, D_aeq: int, w_aeq: int,
    D_mem: int = 256, w_mem: int = 8, weight_bram_per_pe: float = 2.5,
) -> SNNMemoryPlan:
    """Full design memory plan as in Sec. 4.2 (Table 5 + weight memories)."""
    K2 = K * K
    aeq = n_bram(P, K2, D_aeq, w_aeq)
    mem = 2 * n_bram(P, K2, D_mem, w_mem)   # double-buffered potentials
    wts = weight_bram_per_pe * P
    return SNNMemoryPlan(aeq, mem, wts, aeq + mem + wts)


def bram_occupancy(D: int, w: int) -> float:
    """Utilization of the allocated BRAM bits (the paper's 6.25 % finding for
    D=256, w=8 shallow membrane memories)."""
    allocated_words = ceil_bram(D / bram_words(w)) * bram_words(w)
    return D / allocated_words
