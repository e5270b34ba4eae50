"""Logical-axis sharding rules and placement (port of
``repro.sharding``); see :mod:`.resolver`."""
from .resolver import (PRIORITY, RULES, SECOND_PASS, Mesh,  # noqa: F401
                       NamedSharding, PartitionSpec, Resolver, ShardedTensor,
                       active, batch_partition_spec, constrain, is_axes_leaf,
                       map_with_axes, use_resolver)

__all__ = ["RULES", "SECOND_PASS", "PRIORITY", "PartitionSpec", "Resolver",
           "Mesh", "NamedSharding", "ShardedTensor", "batch_partition_spec",
           "is_axes_leaf", "map_with_axes", "use_resolver", "active",
           "constrain"]
