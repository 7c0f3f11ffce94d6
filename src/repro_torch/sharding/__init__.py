"""Sharding rules (DP/FSDP/TP/EP + cache SP) as PartitionSpecs and their
DTensor placements over a `DeviceMesh`."""
from .rules import (NamedSharding, P, PartitionSpec, batch_specs,
                    cache_specs, legalize, param_specs, to_named,
                    to_placements)

__all__ = ["param_specs", "batch_specs", "cache_specs", "legalize",
           "to_named", "to_placements", "PartitionSpec", "P",
           "NamedSharding"]
