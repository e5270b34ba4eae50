"""``price_record`` (port of ``repro.study.stages.price_record``)."""
from __future__ import annotations

from ..core import encoding
from ..core.energy import reprice


def price_record(record, *, input_hw: int, compressed: bool = True):
    """Price a :class:`StatsRecord` (or any N-row slice of one).

    The word format is the kernel=3 AE format of the first conv at
    ``input_hw``, as in the reference, so pricing a sliced row bit-equals
    the same row of a whole-record pricing. Membrane potentials are priced
    as resident on chip, the reference's serving default. Returns an
    :class:`~repro_torch.core.energy.EnergyBreakdown`.
    """
    fmt = encoding.make_format(input_hw, 3, compressed=compressed)
    return reprice(record, word_bytes=encoding.word_nbytes(fmt),
                   vmem_resident=True)
