"""Frontier primitives of the search loop (stable key sort, rank merge)
and the logical-axis sharding rules of the reference's
``repro.parallel``."""

from repro_torch.parallel.sharding import (
    NamedSharding,
    ShardingRules,
    constrain,
    default_rules,
    get_rules,
    logical_spec,
    named_sharding,
    set_rules,
    spec_to_placements,
)

__all__ = [
    "ShardingRules",
    "default_rules",
    "logical_spec",
    "constrain",
    "set_rules",
    "get_rules",
    "named_sharding",
    "NamedSharding",
    "spec_to_placements",
]
