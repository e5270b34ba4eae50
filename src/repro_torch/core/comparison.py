"""DEPRECATED flat entry point for the SNN-vs-CNN study (port of
``repro.core.comparison``).

The experiment lives in the staged, cached Study API (:mod:`repro_torch.study`):

    spec → train → convert → collect → price → report

:func:`run_study` is a thin shim: it builds a :class:`~repro_torch.study.StudySpec`
from its flat kwargs and delegates to :func:`repro_torch.study.run_with_data`,
so it returns what that returns. ``StudyResult`` is an alias of
:class:`repro_torch.study.Report`.
"""
from __future__ import annotations

import warnings

import numpy as np

from ..study import StudySpec, run_with_data
from ..study.report import Report as StudyResult  # noqa: F401  (compat)


def run_study(
    params,
    spec: str,
    dataset_name: str,
    images,              # (N, H, W, C) evaluation samples
    labels,              # (N,)
    calib_images,        # calibration set for conversion
    *,
    T: int = 4,
    depth: int = 256,
    compressed: bool = True,
    input_mode: str = "analog",
    mode: str = "mttfs_cont",
    balance: bool = True,
    backend: str | None = None,
    use_queues: bool = False,
    weight_bits: int = 8,
    vmem_resident: bool = True,
    batch: int = 64,
    device=None,
) -> StudyResult:
    """Deprecated: prefer ``repro_torch.study.run(StudySpec(...))`` /
    ``sweep``. ``device`` is where the stages run (``None``: the card)."""
    warnings.warn(
        "comparison.run_study is deprecated; use the staged Study API "
        "(repro_torch.study.run / sweep) — it caches train/convert/collect "
        "and re-prices recorded stats instead of re-running inference",
        DeprecationWarning, stacklevel=2)
    if use_queues:
        warnings.warn(
            "use_queues is deprecated; pass backend='queue' instead",
            DeprecationWarning, stacklevel=2)
        if backend is None:
            backend = "queue"

    study_spec = StudySpec(
        dataset=dataset_name,
        net=spec,
        input_hw=int(np.shape(images)[1]),
        input_c=int(np.shape(images)[-1]),
        n_eval=int(np.shape(images)[0]),
        n_calib=int(np.shape(calib_images)[0]),
        T=T, depth=depth, compressed=compressed, input_mode=input_mode,
        mode=mode, balance=balance, backend=backend or "dense",
        weight_bits=weight_bits, vmem_resident=vmem_resident, batch=batch,
    )
    return run_with_data(study_spec, params, images, labels, calib_images,
                         device=device)
