"""The worker processes' stdout guard.

A copy of ``protocol_stdout`` from the JAX package's
``parallel/fabric_worker.py``: a worker prints exactly one JSON object on
stdout, so everything else is sent to stderr. The context-parallel KV
rank process (``serving/sharded/shard_worker.py --kv``) uses it. The
fabric worker's collectives and training slice come with the
fabric-sharded serving plane.
"""

from __future__ import annotations

import logging
import sys


def protocol_stdout():
    """Reserve the REAL stdout for the one-line JSON protocol.

    The worker's contract is "exactly one JSON object on stdout" — but
    library logging (jax's absl handlers, any logging.basicConfig a
    transitively imported module ran, a stray debug print) defaults to
    stdout and INTERLEAVES with the protocol line, corrupting the
    parse on the coordinator side. The fix is structural, not
    discipline: swap ``sys.stdout`` for stderr so every later
    print()/handler write lands on the diagnostic stream, repoint any
    ALREADY-INSTALLED stream handlers that captured the old stdout,
    and hand the caller the real stdout for the single protocol
    write. The shard worker (serving/sharded/shard_worker.py) inherits
    the same guard."""
    real = sys.stdout
    sys.stdout = sys.stderr
    for h in logging.getLogger().handlers:
        if isinstance(h, logging.StreamHandler) and \
                getattr(h, "stream", None) is real:
            h.setStream(sys.stderr)
    # Late-configured loggers inherit this root handler (stderr);
    # force=False keeps any handlers a harness deliberately installed.
    logging.basicConfig(stream=sys.stderr)
    return real
