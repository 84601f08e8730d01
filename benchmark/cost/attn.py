"""Kernel 1 (fused quantize-append + paged attention): bytes and operations
of one launch, from the step plan's ``ctx`` and ``n_new``.

A copy of ``attn_cost`` in the repository's ``chip_smoke.py``, with the
step's shape passed in rather than read from module constants.
"""

from __future__ import annotations

import numpy as np


def attn_cost(ctx, n_new, *, slots: int, chunk: int, heads: int,
              d_head: int, block_size: int, pool_dtype: str = "int8"):
    """(bytes, flops) the function needs on these inputs, each byte moved
    once: q read and o written for all slots * chunk rows; k_new, v_new and
    their row scales read for the appended rows only (sum n_new); K/V read
    at the sum(ctx) positions already in the pools, and the appended rows
    written (the new rows attend them from k_new/v_new, they need not be
    read back); table entries and table scales read for the blocks below
    each slot's limit; ctx and n_new. 4 flops per (row, position, element)
    attended (q.k and p.v)."""
    ctx = np.asarray(ctx, np.int64)
    n_new = np.asarray(n_new, np.int64)
    item = 1 if pool_dtype == "int8" else 4
    row = heads * d_head
    appended = int(np.sum(n_new))
    blocks = int(np.sum(-(-(ctx + n_new) // block_size)))
    nbytes = (2 * slots * chunk * row * 4              # q in, o out
              + 2 * appended * (row * 4 + 4)           # k/v_new, row scales
              + 2 * int(np.sum(ctx)) * row * item      # K/V pages read
              + 2 * appended * row * item              # appended rows
              + 3 * blocks * 4                         # table, its scales
              + 2 * slots * 4)                         # ctx, n_new
    flops = 4 * row * int(np.sum(ctx * n_new + n_new * (n_new + 1) // 2))
    return nbytes, flops
