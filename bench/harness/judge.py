"""Decides ``correct``: every served response against the reference's
answer for its image.

The numbers compared, each with its limit from the configuration file:

- ``missing``: requests taken from the queue with no response, plus
  responses for requests never sent or sent once and answered twice;
- ``stats_mismatch_pct``: the share of responses whose integer statistics
  (events in, spikes out, adds, queue words a layer; overflow) differ
  from the reference's for their image;
- ``logit_gap``: the widest distance between a served logit and the
  reference's, over the responses whose statistics agree (a threshold
  crossed a rounding apart changes a spike, and every later layer with it);
- ``energy_mismatch``: responses whose statistics agree but whose priced
  energy or model latency is not the reference's pricing, exactly;
- ``pred_mismatch``: responses whose prediction is not the arg-max of
  their own logits, or not the reference's where the reference's best
  logit leads the next by more than twice the logit limit.
"""
from __future__ import annotations

import numpy as np

from ..reference import energy
from .serve import STATS

CHECKS = ("missing", "stats_mismatch_pct", "logit_gap", "energy_mismatch",
          "pred_mismatch")


def reference_answers(ref, net: dict, images, pool_size: int) -> dict:
    """The reference's outputs (``reference.snn.Outputs``) for the pool
    indices ``images``, with their pricing, as numpy arrays indexed by
    pool image (images not computed hold -1 and NaN)."""
    ej, lat = energy.price(ref.events_in, ref.spikes_out, ref.add_ops,
                           input_hw=net["input_hw"],
                           compressed=net["compressed"],
                           vmem_resident=net["vmem_resident"])
    rows = {f: getattr(ref, f).numpy() for f in STATS}
    rows["logits"] = ref.logits.numpy()
    rows["energy_j"], rows["model_latency_s"] = ej.numpy(), lat.numpy()
    out = {}
    for k, v in rows.items():
        fill = -1 if v.dtype.kind == "i" else np.nan
        out[k] = np.full((pool_size,) + v.shape[1:], fill, v.dtype)
        out[k][images] = v
    return out


def compare(served: dict, pool_of_rid: np.ndarray, n_taken: int,
            ref: dict, limits: dict) -> dict:
    """{check: (value, limit)} for the ``served`` log arrays
    (``serve.Log.arrays``) of ``n_taken`` requests taken from the queue."""
    rid = served["rid"]
    n = len(rid)
    unique = len(np.unique(rid))
    bad_rid = int(((rid < 0) | (rid >= len(pool_of_rid))).sum())
    missing = (n_taken - unique) + (n - unique) + bad_rid
    idx = pool_of_rid[np.clip(rid, 0, len(pool_of_rid) - 1)]
    agree = np.ones(n, bool)
    for f in STATS:
        want = ref[f][idx]
        got = served[f].reshape(want.shape)
        agree &= (got == want).reshape(n, -1).all(1)
    mismatch_pct = 100.0 * (n - agree.sum()) / n if n else 0.0
    logits = served["logits"].astype(np.float64)
    want = ref["logits"][idx].astype(np.float64)
    gap = (float(np.abs(logits - want)[agree].max())
           if agree.any() else float("inf"))
    e_bad = ((np.float32(served["energy_j"]) != ref["energy_j"][idx])
             | (np.float32(served["model_latency_s"])
                != ref["model_latency_s"][idx]))
    energy_bad = int((e_bad & agree).sum())
    top2 = np.sort(want, axis=1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 2 * limits["logit_gap"]
    pred_bad = ((served["pred"] != logits.argmax(1))
                | (sure & (served["pred"] != want.argmax(1))))
    values = {"missing": int(missing),
              "stats_mismatch_pct": float(mismatch_pct),
              "logit_gap": gap, "energy_mismatch": energy_bad,
              "pred_mismatch": int(pred_bad.sum())}
    return {k: (values[k], limits[k]) for k in CHECKS}


def passed(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())
