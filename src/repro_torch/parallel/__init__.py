"""Distribution substrate of the port, on ``torch.distributed``: the
logical-axis sharding rules and blocks (:mod:`.sharding`), collectives
with stated backwards (:mod:`.comm`) and the GPipe pipeline
(:mod:`.pp`)."""

from .pp import bubble_fraction, pipeline_apply
from .sharding import (
    NamedSharding,
    PartitionSpec,
    ShardingRules,
    gather_tree,
    local_block,
    logical_spec,
    make_rules,
    shard,
    shard_tree,
)

__all__ = ["NamedSharding", "PartitionSpec", "ShardingRules", "bubble_fraction",
           "gather_tree", "local_block", "logical_spec", "make_rules", "pipeline_apply",
           "shard", "shard_tree"]
