"""Kernel 10 (the all-to-all of the row plane's expert exchanges): bytes of
one launch, from the exchange's shape.

Each stage's MoE dispatches ``[E·E·C, G·d]`` f32 buckets (E ep ranks, C the
capacity a source rank, G row groups folded into the width) and the
exchange reads each byte once and writes it once.
"""

from __future__ import annotations

import math


def capacity(rows_local: int, experts: int, capacity_factor: float,
             top_k: int = 1) -> int:
    """The Switch capacity a source rank: ceil(top_k·rows/E·cf)."""
    return int(math.ceil(top_k * rows_local / experts * capacity_factor))


def exchange_bytes(experts: int, cap: int, width: int,
                   itemsize: int = 4) -> int:
    """Bytes one way: the ``[E·E·C, width]`` buckets."""
    return experts * experts * cap * width * itemsize


def launch_bytes(experts: int, cap: int, width: int,
                 itemsize: int = 4) -> int:
    """Bytes one launch moves: the buckets read once and written once."""
    return 2 * exchange_bytes(experts, cap, width, itemsize)
