"""The cost functions against the work lines the port's records give."""

import numpy as np

from cost import PEAKS, bound_s
from cost.attn import attn_cost
from cost.exchange import capacity, exchange_bytes, launch_bytes
from cost.model import paged_request_flops, rows_request_flops


def phase3_plan():
    """ctx and n_new of the served-run kernel check's inputs (seed 0): one
    idle slot, decode rows and 16-row prefill chunks off block edges."""
    S, C, B, bs = 16, 16, 256, 16
    rng = np.random.RandomState(0)
    ctx = np.zeros(S, np.int64)
    n_new = np.zeros(S, np.int64)
    for s in range(1, S):
        if s % 2:
            ctx[s] = rng.randint(1, 4000)
            n_new[s] = 1
        else:
            ctx[s] = rng.randint(0, 4000 - C) // bs * bs + rng.randint(1, bs)
            n_new[s] = C
    ctx[S - 1] = B * bs - 1
    return ctx, n_new


def test_attn_cost_phase3_int8():
    ctx, n_new = phase3_plan()
    nbytes, flops = attn_cost(ctx, n_new, slots=16, chunk=16, heads=32,
                              d_head=128, block_size=16)
    assert nbytes == 312_504_300
    assert round(flops / 1e9, 2) == 3.85


def test_attn_cost_phase3_fp32():
    ctx, n_new = phase3_plan()
    nbytes, _ = attn_cost(ctx, n_new, slots=16, chunk=16, heads=32,
                          d_head=128, block_size=16, pool_dtype="fp32")
    assert nbytes == 1_212_968_940


def test_row_plane_exchange_bytes():
    # 64 slots over ep = 8: 8 rows a rank, dropless at cf 8.
    cap = capacity(64 // 8, 8, 8.0)
    assert cap == 8
    assert exchange_bytes(8, cap, 4096) == 8_388_608
    assert launch_bytes(8, cap, 4096) == 2 * 8_388_608


def test_bound_takes_the_larger_side():
    assert bound_s(PEAKS["tf32_flop_per_s"], 0) == 1.0
    assert bound_s(0, PEAKS["hbm_bytes_per_s"]) == 1.0
    assert bound_s(1.0, PEAKS["hbm_bytes_per_s"] * 2) == 2.0


def test_paged_request_flops_counts_the_model_not_the_window():
    d, H, V, mlp = 64, 4, 256, 128
    one = paged_request_flops(10, 1, 0, d=d, heads=H, vocab=V, mlp=mlp)
    per_pos = 8 * d * d + 4 * d * mlp
    attn = 4 * d * sum(range(1, 11))
    assert one == 10 * per_pos + attn + 2 * d * V
    # A cached prefix is not computed again, but is attended over.
    hit = paged_request_flops(10, 1, 8, d=d, heads=H, vocab=V, mlp=mlp)
    assert hit == 2 * per_pos + 4 * d * (9 + 10) + 2 * d * V
    assert paged_request_flops(10, 0, 0, d=d, heads=H, vocab=V,
                               mlp=mlp) == 0.0


def test_rows_request_flops():
    f = rows_request_flops(3, d=8, ffn=16, experts=2, layers=2)
    assert f == 3 * 2 * (4 * 8 * 16 + 2 * 8 * 2 + 4 * 8 * 16)
