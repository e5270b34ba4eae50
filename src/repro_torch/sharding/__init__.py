"""Logical-axis sharding rules (port of ``repro.sharding``); see
:mod:`.resolver`."""
from .resolver import (PRIORITY, RULES, SECOND_PASS,  # noqa: F401
                       PartitionSpec, Resolver, batch_partition_spec,
                       is_axes_leaf, map_with_axes)

__all__ = ["RULES", "SECOND_PASS", "PRIORITY", "PartitionSpec", "Resolver",
           "batch_partition_spec", "is_axes_leaf", "map_with_axes"]
