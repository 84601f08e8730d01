"""Ring addressing and the ring-stream protocol of the port.

Counterpart of the part of the JAX package's ``parallel/ring_probe.py``
that ring attention needs: ``_ring_ids``, here plain integer arithmetic
on a rank's mesh coordinates. The protocol body itself
(``_run_ring_stream`` there) is device code here, written once in
``csrc/ring_stream.cuh`` as a template over a consumer, so that every
kernel built on the ring shares one copy of it.

The protocol, per rank of an n-rank one-way ring (block in hand at step
k is the one whose owner is ``(my_id - k) mod n``):

  * a neighbour barrier: both neighbours have entered before any block
    lands in this rank's slots;
  * two comm slots; the rank's own shard is the first block in hand;
  * at step k < n - 1: wait for the block of step k (k > 0) and for one
    credit (k > 0), copy the block in hand into the right neighbour's
    slot ``(k + 1) % 2`` and raise its receive flag, consume the block,
    then grant one credit to the left neighbour (k < n - 2);
  * the final arrival, block ``(my_id + 1) mod n``, is consumed from
    slot ``(n - 1) % 2``.

Why the credit. Waiting on one's own receive flag bounds nothing about
the neighbours' progress: a rank's step-k completion depends only on its
left chain, so around an n-ring a neighbour can run up to n - 1 steps
ahead, and its step-(k + 2) copy would land in a slot whose step-k
contents this rank has not yet forwarded (seen as chunk corruption on
the reference's 8-wide ring; 2-wide rings never skew enough to expose
it). The step-k copy targets the right neighbour's slot (k + 1) % 2,
which is free once that neighbour finished its step k - 1 with it; so
each rank grants its left neighbour a credit after each step and waits
for one before every send after the first. Skew is bounded to one step,
which the two slots absorb.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def _ring_ids(axis: str, axis_size: int, axis_names: Sequence[str],
              coords: Sequence[int]
              ) -> Tuple[int, Tuple[int, ...], Tuple[int, ...]]:
    """``(my_id, right, left)`` for the rank at mesh coordinates
    ``coords`` (one per name of ``axis_names``) on the ring over
    ``axis``: its position on the ring and its two neighbours' full mesh
    coordinates. Only the ring axis differs from the rank's own
    coordinates, so the ring stays on ``axis`` whatever the other axes
    are."""
    if len(coords) != len(axis_names):
        raise ValueError(f"coords {tuple(coords)} do not match axes "
                         f"{tuple(axis_names)}")
    ring_pos = list(axis_names).index(axis)
    my_id = int(coords[ring_pos])
    if not 0 <= my_id < axis_size:
        raise ValueError(f"rank {my_id} is not on a ring of {axis_size}")
    right = list(coords)
    right[ring_pos] = (my_id + 1) % axis_size
    left = list(coords)
    left[ring_pos] = (my_id - 1 + axis_size) % axis_size
    return my_id, tuple(right), tuple(left)
