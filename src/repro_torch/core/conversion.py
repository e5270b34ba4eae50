"""ANN -> SNN conversion (port of ``repro.core.conversion``): snntoolbox's
data-based weight normalization (Rueckauer et al. 2017) and greedy
threshold balancing.

    lambda_l = p-th percentile of layer-l ReLU activations on calibration data
    w'_l = w_l * lambda_{l-1} / lambda_l
    b'_l = b_l / lambda_l
    V_t  = 1.0 for every layer

Conversion walks the same compiled plan as execution, so the
parameter/threshold lists line up with the engine by construction.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from .cnn_baseline import cnn_forward, fraction_f32
from .engine import compile_plan


def _round_f32(x: Fraction) -> np.float32:
    """``x`` rounded to the nearest float32, ties to even (normal range)."""
    if x == 0:
        return np.float32(0.0)
    mag = abs(x)
    e = mag.numerator.bit_length() - mag.denominator.bit_length()
    if mag < Fraction(2) ** e:       # now 2**e <= mag < 2**(e + 1)
        e -= 1
    unit = Fraction(2) ** max(e - 23, -149)
    m = round(mag / unit)            # Fraction rounds half to even
    return np.float32((-1 if x < 0 else 1) * float(m * unit))


def _fma_f32(a, b, c) -> np.float32:
    """``a * b + c`` of float32 values with one rounding (a fused
    multiply-add), computed exactly in rationals."""
    return _round_f32(Fraction(float(a)) * Fraction(float(b))
                      + Fraction(float(c)))


def percentile_f32(a: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q``-th percentile of all of ``a``, linearly interpolated, as a
    0-d float32 tensor on ``a``'s device — bit for bit what the reference's
    ``jnp.percentile(a, q)`` returns for a float32 ``a``.

    The reference's compiled percentile folds ``(q / 100) * (n - 1)`` into
    ``q * ((n - 1) * f32(1 / 100))`` and ends in a fused multiply-add,
    ``fma(hi, w, lo * (1 - w))``; the position and weights are therefore
    taken here in float32 in that order, and the last step as one exact
    fused multiply-add on the two order statistics. Any size works (a sort,
    not ``torch.quantile``, which refuses inputs past 2^24 elements); a
    NaN anywhere gives NaN, as there.
    """
    f32 = np.float32
    flat = a.detach().reshape(-1).to(torch.float32)
    n = flat.numel()
    pos = f32(q) * ((f32(n) - f32(1)) * (f32(1) / f32(100)))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = f32(pos - lo)
    w_lo = f32(1) - w_hi
    lo = int(min(max(lo, 0), n - 1))
    hi = int(min(max(hi, 0), n - 1))
    s = torch.sort(flat).values                      # NaNs sort last
    # audit: allow[host-sync] two order statistics (and the NaN probe) go
    # to the host for the exact last step: three scalars per layer
    picked = torch.stack([s[lo], s[hi], s[-1]]).cpu().numpy()
    if np.isnan(picked[2]):
        out = f32(np.nan)
    else:
        out = _fma_f32(picked[1], w_hi, f32(picked[0] * w_lo))
    return torch.tensor(out, dtype=torch.float32, device=a.device)


def calibrate_lambdas(params, spec: str, calib_images,
                      percentile: float = 99.0):
    """Per weighted layer activation scale lambda_l (plus lambda_0 = input)."""
    _, acts = cnn_forward(params, spec, calib_images, return_acts=True)
    lam0 = percentile_f32(calib_images, percentile)
    lams = [torch.clamp(percentile_f32(a, percentile), min=1e-6)
            for a in acts]
    return [torch.clamp(lam0, min=1e-6)] + lams


@torch.no_grad()
def convert(params, spec: str, calib_images, percentile: float = 99.0):
    """Returns ``(snn_params, thresholds)`` — the params' list layout, with
    thresholds[li] = 1.0 (a 0-d float32 tensor) for every layer (pools'
    are ignored)."""
    plan = compile_plan(spec, int(calib_images.shape[1]),
                        int(calib_images.shape[-1]))
    lams = calibrate_lambdas(params, spec, calib_images, percentile)

    device = calib_images.device
    snn_params: list[dict] = [{} for _ in range(plan.n_layers)]
    thresholds = [torch.ones((), dtype=torch.float32, device=device)
                  for _ in range(plan.n_layers)]
    weighted = [cp.index for cp in plan.convs] + [plan.out.index]
    for wi, li in enumerate(weighted):
        w, b = params[li]["w"], params[li]["b"]
        lam_prev, lam = lams[wi], lams[wi + 1]
        snn_params[li] = {"w": w * lam_prev / lam, "b": b / lam}
    return snn_params, thresholds


@torch.no_grad()
def balance_thresholds(snn_params, thresholds, cfg, cnn_params, calib_images,
                       grid=(0.25, 0.4, 0.55, 0.7, 0.85, 1.0, 1.25, 1.5,
                             1.75, 2.0)):
    """Greedy per-layer threshold balancing (Diehl et al. 2015 style).

    Layer by layer, two coordinate-descent sweeps pick the threshold scale
    from ``grid`` that maximizes argmax agreement with the source CNN on
    the calibration images, through the ``dense`` backend on the images'
    device; a scale replaces the best so far only if its agreement is
    strictly higher (ties keep the earlier scale, as in the reference).
    """
    from .snn_model import snn_dense_infer_batch

    device = calib_images.device
    plan = compile_plan(cfg.spec, cfg.input_hw, cfg.input_c, cfg.compressed)
    cnn_pred = torch.argmax(cnn_forward(cnn_params, cfg.spec, calib_images),
                            -1)

    def agreement(ths):
        logits, _ = snn_dense_infer_batch(snn_params, ths, cfg, calib_images,
                                          device=device)
        # audit: allow[host-sync] the greedy search branches on the score
        return fraction_f32(torch.argmax(logits, -1) == cnn_pred).item()

    ths = list(thresholds)
    for _pass in range(2):  # two coordinate-descent sweeps
        for cp in plan.convs:  # pools have no threshold; the dense never fires
            li = cp.index
            best_s, best_a = 1.0, -1.0
            for s in grid:
                trial = list(ths)
                trial[li] = thresholds[li] * s
                a = agreement(trial)
                if a > best_a:
                    best_a, best_s = a, s
            ths[li] = thresholds[li] * best_s
    return ths


def conversion_gap(cnn_acc: float, snn_acc: float) -> float:
    """The paper's headline metric: accuracy delta after conversion."""
    return float(cnn_acc) - float(snn_acc)
