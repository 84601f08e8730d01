"""Disaggregated prefill/decode serving.

Dedicated prefill replicas build paged KV and stream the pages over
the fabric to decode replicas that only run the per-token step:

  * spec.py   — ``KVSpec``: the pool layout declared ONCE; wire
    bytes, segmentation and the receiver's parse all derive from it
    (hello-checked with typed CodecMismatch/KVSpecMismatch).
  * stream.py — ``KVPageStream``/``KVPageStreamServer``: pages
    point-to-point over the sharded plane's framed transport with
    the int8 block codec (verbatim for int8-resident pools).
  * pool.py   — ``DisaggPool``: two role-typed ReplicaPools plus the
    transfer plane; lease migration rides the paged plane's detach →
    stream → import → ``_reattach`` path, failure disposition
    mirrors the supervisor's requeue contract.

All three are the JAX package's jax-free modules, copied. A pool's
executors may come from either package: the spec check compares
``KVSpec.fingerprint()``, which both packages compute alike.
"""

from .pool import DisaggPool
from .spec import (SHARD_AXES, WIRE_CODECS, CodecMismatch, KVSpec,
                   KVSpecMismatch)
from .stream import (KVPageStream, KVPageStreamServer, KVStreamError,
                     KVStreamNack)

__all__ = [
    "CodecMismatch",
    "DisaggPool",
    "KVPageStream",
    "KVPageStreamServer",
    "KVSpec",
    "KVSpecMismatch",
    "KVStreamError",
    "KVStreamNack",
    "SHARD_AXES",
    "WIRE_CODECS",
]
