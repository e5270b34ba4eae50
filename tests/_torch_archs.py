"""The reference's smoke and full-size ArchConfigs (``tests/_smoke_archs``)
as the port's: the same fields, with the port's ``MoEConfig`` and
``MambaConfig`` and a torch ``param_dtype``. Used by the LM parity tests
(``tests/test_torch_models*.py``, ``test_torch_moe.py``,
``test_torch_train_loop.py``)."""
import dataclasses

import torch

from repro_torch.models import model as TM
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import MambaConfig

from _smoke_archs import FULL, SMOKES


def port_cfg(cfg, **changes):
    """A reference ``ArchConfig`` as the port's."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["param_dtype"] = torch.float32
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(*cfg.moe)
    if cfg.mamba is not None:
        kw["mamba"] = MambaConfig(*cfg.mamba)
    kw.update(changes)
    return TM.ArchConfig(**kw)


TORCH_SMOKES = {name: port_cfg(cfg) for name, cfg in SMOKES.items()}
TORCH_FULL = {name: port_cfg(cfg) for name, cfg in FULL.items()}
