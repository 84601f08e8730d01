"""The shard plane of the port: its typed failures (``synthetic.py``),
the coordinator-to-shard framed protocol (``protocol.py``) and the
context-parallel KV rank process (``shard_worker.py --kv``).

Importing this package starts nothing; the rank process imports torch
only in its own interpreter."""

from .synthetic import (ShardAborted, ShardCollectiveStall, ShardError,
                        ShardStepError, ShardTimeout)

__all__ = [
    "ShardAborted",
    "ShardCollectiveStall",
    "ShardError",
    "ShardStepError",
    "ShardTimeout",
]
