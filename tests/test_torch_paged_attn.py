"""The port's fused paged-attention step against the JAX package's.

The same seeded numpy inputs go through the reference Pallas kernel
(``make_paged_attn_step``, in interpret mode, as the reference's own CPU
tests run it) and through the port's plain PyTorch version, which is what
``paged_attn_step_cuda`` runs for tensors on the CPU.

Bars:
  * pools (int8 codes or fp32 rows) bitwise equal: the appends are the
    same writes, with the same IEEE divide and half-to-even rounding;
  * ``o`` within ``rtol=1e-5, atol=1e-6`` on every row, padding rows and
    idle slots included: the reference accumulates an online softmax
    block by block and scales by ``1/sqrt(dh)``, the port takes one
    softmax over the whole context and divides by ``sqrt(dh)``, so the
    two differ by float reassociation only;
  * a pool poisoned past each slot's limit (NaN rows, NaN scales of the
    blocks past it, garbage int8 codes) gives exactly the clean ``o``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpu_operator_tpu.parallel.pallas_paged_attn import make_paged_attn_step
from dpu_operator_tpu_torch.parallel.paged_attn import (
    paged_attn_step_cuda, paged_attn_step_plain)

torch.set_num_threads(1)

S, C, B, BS, H, DH, N = 2, 4, 4, 4, 2, 8, 16
RTOL, ATOL = 1e-5, 1e-6

# (ctx, n_new, table) per slot. Slot tables own disjoint blocks; an idle
# slot with no state has an all-zero table, like the planner's rows.
CASES = {
    # decode one token; a 4-row chunk crossing the block edge at 4
    "decode+cross": [(5, 1, [3, 7, 1, 9]), (2, 4, [2, 5, 11, 4])],
    # idle slot with no context (its padding rows aim at block 0, which
    # the other slot writes this step) next to a chunk inside block 0
    "idle+chunk": [(0, 0, [0, 0, 0, 0]), (1, 3, [0, 5, 11, 4])],
    # idle slot WITH context; first token of a fresh slot
    "idle_ctx+first": [(7, 0, [3, 7, 1, 9]), (0, 1, [2, 5, 11, 4])],
    # chunk landing exactly on a block start; decode at the last slot
    "aligned+tail": [(8, 4, [3, 7, 1, 9]), (15, 1, [2, 5, 11, 4])],
}


def _random_case(seed):
    """Seeded slot states: disjoint tables, any ctx/n_new that fits the
    table (an idle slot with no state gets the planner's zero row)."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(N)
    slots = []
    for s in range(S):
        n_new = int(rng.randint(0, C + 1))
        ctx = int(rng.randint(0, B * BS - n_new + 1))
        table = perm[s * B:(s + 1) * B].tolist()
        if n_new == 0 and ctx % 2:
            ctx, table = 0, [0] * B
        slots.append((ctx, n_new, table))
    return slots


def _inputs(case, pool_dtype, seed=0):
    rng = np.random.RandomState(seed)
    slots = CASES[case] if case in CASES else _random_case(case)
    ctx = np.array([c for c, _, _ in slots], np.int32)
    n_new = np.array([n for _, n, _ in slots], np.int32)
    tables = np.array([t for _, _, t in slots], np.int32)
    q, k, v = (rng.randn(S, C, H, DH).astype(np.float32) for _ in range(3))
    if pool_dtype == "int8":
        kpool = rng.randint(-127, 128, (N, BS, H, DH)).astype(np.int8)
        vpool = rng.randint(-127, 128, (N, BS, H, DH)).astype(np.int8)
        kscale = (rng.rand(N).astype(np.float32) * 0.02 + 0.01)
        vscale = (rng.rand(N).astype(np.float32) * 0.02 + 0.01)
    else:
        kpool = rng.randn(N, BS, H, DH).astype(np.float32)
        vpool = rng.randn(N, BS, H, DH).astype(np.float32)
        kscale = np.ones(N, np.float32)
        vscale = np.ones(N, np.float32)
    rows = np.clip((ctx[:, None] + np.arange(C)) // BS, 0, B - 1)
    blk_rows = np.take_along_axis(tables, rows, axis=1)
    return dict(tables=tables, ctx=ctx, n_new=n_new, q=q, k_new=k, v_new=v,
                kscale_rows=kscale[blk_rows], vscale_rows=vscale[blk_rows],
                kscale_tbl=kscale[tables], vscale_tbl=vscale[tables],
                kpool=kpool, vpool=vpool)


ORDER = ("tables", "ctx", "n_new", "q", "k_new", "v_new", "kscale_rows",
         "vscale_rows", "kscale_tbl", "vscale_tbl", "kpool", "vpool")


@functools.lru_cache(maxsize=None)
def _reference_step(pool_dtype):
    return jax.jit(make_paged_attn_step(S, C, B, BS, H, DH, N,
                                        pool_dtype=pool_dtype,
                                        interpret=True))


def _reference(inp, pool_dtype):
    step = _reference_step(pool_dtype)
    o, kp, vp = step(*(jnp.asarray(inp[k]) for k in ORDER))
    return np.asarray(o), np.asarray(kp), np.asarray(vp)


def _port(inp, fn=paged_attn_step_plain):
    args = [torch.from_numpy(np.array(inp[k])) for k in ORDER]
    o = fn(*args)
    return o.numpy(), args[10].numpy(), args[11].numpy()


def _poison(inp, pool_dtype):
    """Every pool position a slot may not attend (at or past its limit,
    and blocks no slot's table names) turns to garbage, and the table
    scales of blocks wholly past the limit to NaN."""
    out = {k: np.array(v) for k, v in inp.items()}
    bad = np.ones((N, BS), bool)
    for s in range(S):
        limit = int(inp["ctx"][s] + inp["n_new"][s])
        for p in range(limit):
            bad[inp["tables"][s, p // BS], p % BS] = False
        for b in range(-(-limit // BS), B):
            out["kscale_tbl"][s, b] = np.nan
            out["vscale_tbl"][s, b] = np.nan
    for name, sign in (("kpool", 1), ("vpool", -1)):
        if pool_dtype == "int8":
            out[name][bad] = sign * 113
        else:
            out[name][bad] = np.nan
    return out


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_reference(case, pool_dtype):
    inp = _inputs(case, pool_dtype)
    o_ref, kp_ref, vp_ref = _reference(inp, pool_dtype)
    o, kp, vp = _port(inp)
    np.testing.assert_array_equal(kp, kp_ref)
    np.testing.assert_array_equal(vp, vp_ref)
    assert np.isfinite(o).all()
    np.testing.assert_allclose(o, o_ref, rtol=RTOL, atol=ATOL)
    if case.startswith("idle+"):
        # no context, no new rows: the idle slot's rows are exactly 0
        assert not o[0].any()
    # the step really appended: new rows differ from the seeded pool
    assert not np.array_equal(kp, inp["kpool"])


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_plain_matches_pallas_reference_random_states(seed, pool_dtype):
    """The same bars on seeded random slot states."""
    inp = _inputs(seed, pool_dtype, seed=seed)
    o_ref, kp_ref, vp_ref = _reference(inp, pool_dtype)
    o, kp, vp = _port(inp)
    np.testing.assert_array_equal(kp, kp_ref)
    np.testing.assert_array_equal(vp, vp_ref)
    np.testing.assert_allclose(o, o_ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
@pytest.mark.parametrize("case", ["decode+cross", "idle+chunk"])
def test_poisoned_pool_gives_clean_output(case, pool_dtype):
    inp = _inputs(case, pool_dtype)
    o_clean, _, _ = _port(inp)
    o_bad, _, _ = _port(_poison(inp, pool_dtype))
    np.testing.assert_array_equal(o_bad, o_clean)
    o_ref_bad, _, _ = _reference(_poison(inp, pool_dtype), pool_dtype)
    np.testing.assert_allclose(o_bad, o_ref_bad, rtol=RTOL, atol=ATOL)


def test_cuda_wrapper_runs_plain_version_on_cpu_tensors():
    """Given CPU tensors the kernel's wrapper runs the plain version, and
    counts no launch: a launch is counted only where the kernel runs."""
    inp = _inputs("decode+cross", "int8")
    before = paged_attn_step_cuda.launches
    o, kp, _ = _port(inp, paged_attn_step_cuda)
    o_plain, kp_plain, _ = _port(inp)
    np.testing.assert_array_equal(o, o_plain)
    np.testing.assert_array_equal(kp, kp_plain)
    assert paged_attn_step_cuda.launches == before
