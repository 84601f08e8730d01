"""The shard plane's typed failures.

A copy of the error classes of the JAX package's
``serving/sharded/synthetic.py``: every shard backend raises these, the
context-parallel KV sets (``serving/kvcache/sharded.py``) included. A
failure carries the rank it came from. The row-plane shard set itself
(``SyntheticShardSet``) comes with the fabric-sharded serving plane.
"""

from __future__ import annotations

from typing import Optional


class ShardError(RuntimeError):
    """Base of the shard plane's failures; carries the origin rank."""

    def __init__(self, msg: str, rank: Optional[int] = None):
        super().__init__(msg)
        self.rank = rank


class ShardStepError(ShardError):
    """One shard's step raised; the whole replica step is poisoned
    (every peer needs the missing partial)."""


class ShardCollectiveStall(ShardError):
    """A peer never deposited its partial inside the collective
    deadline — the bounded-time spelling of 'one shard is hung'."""


class ShardAborted(ShardError):
    """The step's generation was torn down (reset/close) before the
    result landed — the owner must not retry against this handle."""


class ShardTimeout(ShardError):
    """collect() deadline expired before every shard replied."""
