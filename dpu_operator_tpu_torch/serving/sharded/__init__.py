"""Fabric-sharded serving replicas, and the shard plane's typed failures
and framed protocol.

One replica's decode step spans many shard workers: the
``FabricExecutor`` coordinator speaks the serving plane's two-phase
``submit/collect`` contract upward and a small shard-set contract
downward, with two backends — ``SyntheticShardSet`` (in-process shard
threads, each rank's slice on the set's device) and ``ShardProcessSet``
(real ``shard_worker`` processes reducing over
``parallel/fabric_collectives``, ring order from
``parallel/topology.ring_order``). The shard-side math lives once in
``shard_math`` so every backend decodes the same token streams. The
``shard_worker --kv`` entry is the context-parallel KV plane's rank
process.

Importing this package starts nothing; a shard worker imports torch in
its own interpreter."""

from .executor import FabricExecutor
from .procset import ShardProcessSet
from .synthetic import (ShardAborted, ShardCollectiveStall, ShardError,
                        ShardStepError, ShardTimeout, StepOutput,
                        SyntheticShardSet)

__all__ = [
    "FabricExecutor",
    "ShardAborted",
    "ShardCollectiveStall",
    "ShardError",
    "ShardProcessSet",
    "ShardStepError",
    "ShardTimeout",
    "StepOutput",
    "SyntheticShardSet",
]
