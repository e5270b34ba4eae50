"""The yardstick of work: the card's peaks and the operations and bytes the
served net needs, counted from the configuration and the reference's
statistics, never from the program.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12        # float32 outside the tensor cores

F32 = 4                        # bytes of a float32 or an int32


def bound_s(nbytes: float, ops: float) -> float:
    """Least seconds the card needs for a call: the larger of its bytes
    over the memory bandwidth and its operations over the fp32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S)


def b1_call_bytes(stage, rows: int) -> int:
    """Bytes one fused spike-accumulate call over ``rows`` (images x T)
    must move at ``stage``: its int32 occupancy (rows, C_in, K², windows)
    read once, its float32 HWIO weights read once, its float32 charge
    (rows, H, W, C_out) written once."""
    k2, p = stage.k * stage.k, stage.n_win * stage.n_win
    return F32 * (rows * stage.in_c * k2 * p
                  + k2 * stage.in_c * stage.out_c
                  + rows * stage.in_hw * stage.in_hw * stage.out_c)


def taps(hw: int, k: int) -> int:
    """Kernel taps of a SAME conv that land inside an hw-wide map, summed
    over the hw output coordinates of one axis."""
    pad = k // 2
    return sum(1 for y in range(hw) for d in range(k) if 0 <= y + d - pad < hw)


def analog_flops(stage) -> int:
    """The analog first layer's work: its in-bounds multiply-adds at two
    operations each, once a request (the constant current is the same
    every step)."""
    return 2 * taps(stage.in_hw, stage.k) ** 2 * stage.in_c * stage.out_c
