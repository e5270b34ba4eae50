"""The staged, cached Study API — the paper's experiment as a pipeline
(port of ``repro.study``).

    spec → train → convert → collect → price → report
                   (or train_snn, when spec.training="direct")

One :class:`StudySpec` declares a study point; :func:`run` executes the
chain; :func:`sweep` prices variants against shared recorded stats;
:func:`export_artifact` / :func:`load_artifact` ship a converted or
directly trained net as a checkpoint directory.
``core.comparison.run_study`` survives as a deprecation shim over
:func:`run_with_data`. The grid runner is ``python -m
repro_torch.study.sweep`` (:mod:`.sweep`).
"""
from ..core.energy import reprice as price_stats  # noqa: F401
from .artifacts import (CollectArtifact, ConvertArtifact,  # noqa: F401
                        DirectTrainArtifact, StatsRecord, TrainArtifact)
from .cache import DEFAULT_CACHE, StudyCache, content_key  # noqa: F401
from .report import Report, sweep_rows  # noqa: F401
from .spec import (StudySpec, StudySpecError, UnknownBackendError,  # noqa: F401
                   UnknownDatasetError, UnknownInputModeError,
                   UnknownNeuronModeError)
from .stages import (collect, convert, export_artifact,  # noqa: F401
                     fit_cnn, from_params, load_artifact, price,
                     price_record, reset_stage_counts, run, run_with_data,
                     stage_counts, sweep, train, train_snn)

# the sweep *runner* module. Importing it binds the package attribute
# ``sweep`` to the module, shadowing the stage helper just imported; the
# module is a callable module type delegating __call__ to stages.sweep, so
# `study.sweep(base, variants)` works either way, and importing it here
# makes the shadowing independent of import order. `from . import sweep`
# would not do: the name is already bound, so the submodule import would be
# skipped; import_module always runs it and rebinds the attribute.
import importlib as _importlib  # noqa: E402

sweep = _importlib.import_module(".sweep", __name__)

__all__ = [
    "StudySpec", "StudySpecError", "UnknownDatasetError",
    "UnknownBackendError", "UnknownNeuronModeError", "UnknownInputModeError",
    "StudyCache", "DEFAULT_CACHE", "content_key",
    "TrainArtifact", "ConvertArtifact", "DirectTrainArtifact",
    "CollectArtifact", "StatsRecord",
    "Report", "sweep_rows", "price_stats",
    "train", "train_snn", "convert", "collect", "price", "price_record",
    "run", "run_with_data", "sweep", "export_artifact", "load_artifact",
    "fit_cnn", "from_params", "stage_counts", "reset_stage_counts",
]
