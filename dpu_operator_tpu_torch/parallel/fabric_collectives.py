"""The fabric ring's error types and its even contiguous partition.

A copy of the part of the JAX package's ``parallel/fabric_collectives.py``
that the context-parallel KV plane reaches: ``KVSpec``'s per-rank
geometry splits heads and block ids with ``_segment_bounds``, and its
hello check raises ``CodecMismatch``. The ring transport itself
(``RingTransport``, ``bench_ring``) comes with the fabric-sharded
serving plane.
"""

from __future__ import annotations

from typing import List, Tuple


class RingError(RuntimeError):
    """Transport setup/exchange failure — callers fall back to gloo."""


class CodecMismatch(RingError):
    """The two ends of a ring link disagree on the wire codec. Caught
    at hello time (before any payload moves) so a misconfigured rank
    fails typed instead of decoding int8 bytes as floats."""


def _segment_bounds(n_elems: int, world: int) -> List[Tuple[int, int]]:
    """Even contiguous partition of [0, n_elems) into `world` segments
    (first n_elems % world segments get the extra element)."""
    base, rem = divmod(n_elems, world)
    bounds, off = [], 0
    for r in range(world):
        size = base + (1 if r < rem else 0)
        bounds.append((off, off + size))
        off += size
    return bounds
