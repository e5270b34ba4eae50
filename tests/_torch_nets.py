"""Shared inputs for the port's parity tests: dyadic nets and images.

Every value is a multiple of 2^-8 (weights, images) or 2^-4 (biases), so
fp32 sums of them are exact in any order; the dense layer's max |w| is
127 * 2^-8, which makes its symmetric int8 scale exactly 2^-8.
"""
import numpy as np

from repro.core import engine as jengine


def dyadic_net(spec, hw, c, seed=0):
    rng = np.random.default_rng(seed)
    plan = jengine.compile_plan(spec, hw, c)
    params = [{} for _ in range(plan.n_layers)]
    for cp in plan.convs:
        params[cp.index] = {
            "w": rng.integers(-96, 97, (3, 3, cp.in_c, cp.out_c)) / 256.0,
            "b": rng.integers(-2, 4, (cp.out_c,)) / 16.0}
    w = rng.integers(-127, 128, (plan.out.n_in, plan.out.n_out))
    w.flat[0] = 127                      # power-of-two int8 scale
    params[plan.out.index] = {"w": w / 256.0,
                              "b": rng.integers(-8, 8, plan.out.n_out) / 16.0}
    params = [{k: v.astype(np.float32) for k, v in p.items()} for p in params]
    th = [np.float32(0.5)] * plan.n_layers
    return params, th


def images(B, hw, c, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, hw, hw, c)) / 256.0).astype(np.float32)
