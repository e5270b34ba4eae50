"""Per-request pricing pieces of ``repro.study``: the stats record and
``price_record``."""
from .artifacts import StatsRecord  # noqa: F401
from .stages import price_record  # noqa: F401
