"""The port's fused paged-attention step against the JAX package's.

The same seeded numpy inputs go through the reference Pallas kernel
(``make_paged_attn_step``, in interpret mode, as the reference's own CPU
tests run it) and through the port's plain PyTorch version, which is what
``paged_attn_step_cuda`` runs for tensors on the CPU, and through
``paged_attn_split_plain``, the kernel's split of the context across
CTAs written out in PyTorch, at chunks of 1, 2, 3 and B table entries (B:
one chunk, the unsplit order).

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
from dpu_operator_tpu_torch import cuda_build
from dpu_operator_tpu_torch.parallel import paged_attn as pa
from dpu_operator_tpu_torch.parallel.paged_attn import (
    paged_attn_split_plain, paged_attn_step_cuda, paged_attn_step_plain)

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
    # a chunk straddling the boundary of 1- and 2-entry chunks (8); a
    # chunk from ctx = B * bs - 1, whose rows past the table clip to its
    # last block
    "straddle+clip": [(6, 4, [3, 7, 1, 9]), (15, 4, [2, 5, 11, 4])],
    # an idle slot; a chunk straddling the 3-entry chunks' boundary (12)
    "idle+straddle3": [(0, 0, [0, 0, 0, 0]), (10, 4, [2, 5, 11, 4])],
}
# The split's chunk sizes in table entries: B is one chunk.
CHUNKS = [1, 2, 3, B]


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


@functools.lru_cache(maxsize=None)
def _reference_of(case, pool_dtype, seed, poisoned):
    """The reference's outputs on a case's inputs, computed once for the
    plain version's test and each of the split's chunk sizes."""
    inp = _inputs(case, pool_dtype, seed=seed)
    return _reference(_poison(inp, pool_dtype) if poisoned else inp,
                      pool_dtype)


def _split(chunk_blocks):
    return functools.partial(paged_attn_split_plain,
                             chunk_blocks=chunk_blocks)


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
        for p in range(min(limit, B * BS)):  # the table's positions
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


def _matches_reference(case, pool_dtype, fn):
    inp = _inputs(case, pool_dtype)
    o_ref, kp_ref, vp_ref = _reference_of(case, pool_dtype, 0, False)
    o, kp, vp = _port(inp, fn)
    np.testing.assert_array_equal(kp, kp_ref)
    np.testing.assert_array_equal(vp, vp_ref)
    assert np.isfinite(o).all()
    np.testing.assert_allclose(o, o_ref, rtol=RTOL, atol=ATOL)
    if case.startswith("idle+"):
        # no context, no new rows: the idle slot's rows are exactly 0
        assert not o[0].any()
    # the step really appended: new rows differ from the seeded pool
    assert not np.array_equal(kp, inp["kpool"])


def _matches_reference_random_state(seed, pool_dtype, fn):
    inp = _inputs(seed, pool_dtype, seed=seed)
    o_ref, kp_ref, vp_ref = _reference_of(seed, pool_dtype, seed, False)
    o, kp, vp = _port(inp, fn)
    np.testing.assert_array_equal(kp, kp_ref)
    np.testing.assert_array_equal(vp, vp_ref)
    np.testing.assert_allclose(o, o_ref, rtol=RTOL, atol=ATOL)


def _poison_gives_clean_output(case, pool_dtype, fn):
    inp = _inputs(case, pool_dtype)
    o_clean, _, _ = _port(inp, fn)
    o_bad, _, _ = _port(_poison(inp, pool_dtype), fn)
    np.testing.assert_array_equal(o_bad, o_clean)
    o_ref_bad, _, _ = _reference_of(case, pool_dtype, 0, True)
    np.testing.assert_allclose(o_bad, o_ref_bad, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_reference(case, pool_dtype):
    _matches_reference(case, pool_dtype, paged_attn_step_plain)


@pytest.mark.parametrize("chunk_blocks", CHUNKS)
@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_matches_pallas_reference(case, pool_dtype, chunk_blocks):
    """The kernel's split, chunk by chunk and combined in chunk order,
    on the same cases and bars: codes bitwise, o within rtol / atol."""
    _matches_reference(case, pool_dtype, _split(chunk_blocks))


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_plain_matches_pallas_reference_random_states(seed, pool_dtype):
    """The same bars on seeded random slot states."""
    _matches_reference_random_state(seed, pool_dtype, paged_attn_step_plain)


@pytest.mark.parametrize("chunk_blocks", CHUNKS)
@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_split_matches_pallas_reference_random_states(seed, pool_dtype,
                                                      chunk_blocks):
    _matches_reference_random_state(seed, pool_dtype, _split(chunk_blocks))


POISON_CASES = ["decode+cross", "idle+chunk", "straddle+clip"]


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
@pytest.mark.parametrize("case", POISON_CASES)
def test_poisoned_pool_gives_clean_output(case, pool_dtype):
    _poison_gives_clean_output(case, pool_dtype, paged_attn_step_plain)


@pytest.mark.parametrize("chunk_blocks", CHUNKS)
@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
@pytest.mark.parametrize("case", POISON_CASES)
def test_split_poisoned_pool_gives_clean_output(case, pool_dtype,
                                                chunk_blocks):
    """No poisoned byte reaches o through any chunk or the combine."""
    _poison_gives_clean_output(case, pool_dtype, _split(chunk_blocks))


def test_split_of_one_chunk_is_the_unsplit_order():
    """With B entries a chunk the split is one online softmax over the
    whole context: the combine multiplies by exp(0) = 1 and adds zeros,
    so o equals the one-chunk recurrence written out directly."""
    inp = _inputs("straddle+clip", "int8")
    o, _, _ = _port(inp, _split(B))
    args = [torch.from_numpy(np.array(inp[k])) for k in ORDER]
    paged_attn_step_plain(*args)  # the appends
    tables, ctx, n_new, q = (args[0].long(), args[1].long(),
                             args[2].long(), args[3])
    keys = pa.int8_block_decode(args[10][tables], args[8]).reshape(
        S, B * BS, H, DH)
    vals = pa.int8_block_decode(args[11][tables], args[9]).reshape(
        S, B * BS, H, DH)
    limit = ctx + n_new
    tpos = torch.arange(B * BS)
    ok = tpos[None, :] < limit[:, None]
    keys = torch.where(ok[:, :, None, None], keys, torch.zeros(()))
    vals = torch.where(ok[:, :, None, None], vals, torch.zeros(()))
    pos = ctx[:, None] + torch.arange(C)[None, :]
    allowed = ((tpos[None, None, :] <= pos[:, :, None]) & ok[:, None, :]
               )[:, None]
    scores = torch.where(allowed, torch.einsum("schd,sthd->shct", q, keys)
                         / np.sqrt(DH), torch.full((), pa.NEG))
    m = scores.amax(-1)
    p = torch.where(allowed, torch.exp(scores - m[..., None]),
                    torch.zeros(()))
    want = (torch.einsum("shct,sthd->shcd", p, vals)
            / p.sum(-1)[..., None]).permute(0, 2, 1, 3)
    np.testing.assert_array_equal(o, want.numpy())


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


class _Fn:
    """A ctypes function stand-in: argtypes/restype slots and a result."""

    def __init__(self, result):
        self.argtypes = None
        self.restype = None
        self.result = result

    def __call__(self, *args):
        return self.result


class _Lib:
    def __init__(self, chunk_blocks):
        self.paged_attn_chunk_blocks = _Fn(chunk_blocks)
        self.paged_attn_step_launch = _Fn(0)


@pytest.mark.parametrize("exported", [pa.CHUNK_BLOCKS // 2,
                                      pa.CHUNK_BLOCKS + 1])
def test_launcher_raises_on_another_chunk_size(exported, monkeypatch):
    """The wrapper sizes the combine's scratch by its own CHUNK_BLOCKS: a
    library whose CTAs own another number of table entries is refused,
    at every call, and one that agrees is bound."""
    monkeypatch.setattr(cuda_build, "load", lambda name: _Lib(exported))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="block-table entries"):
            pa._launcher()
    lib = _Lib(pa.CHUNK_BLOCKS)
    monkeypatch.setattr(cuda_build, "load", lambda name: lib)
    assert pa._launcher() is lib.paged_attn_step_launch
    assert lib.paged_attn_step_launch.argtypes is not None


def test_scratch_is_reused_per_stream_and_shape(monkeypatch):
    """One scratch set per (device, stream, shape), allocated once and
    reused; its arrival words start at 0; the oldest set goes first."""
    monkeypatch.setattr(pa, "_scratch", {})
    cpu = torch.device("cpu")
    first = pa._scratch_for(cpu, 7, S, H, C, DH, 64)
    assert pa._scratch_for(cpu, 7, S, H, C, DH, 64) is first
    acc, ml, arrivals = first
    assert acc.shape == (S, H, 2, C, DH) and ml.shape == (S, H, 2, C, 2)
    assert arrivals.dtype == torch.int32 and not arrivals.any()
    assert pa._scratch_for(cpu, 8, S, H, C, DH, 64) is not first
    assert pa._scratch_for(cpu, 7, S, H, C, DH, 96) is not first
    for stream in range(100, 100 + pa.SCRATCH_KEEP):
        pa._scratch_for(cpu, stream, S, H, C, DH, 64)
    assert len(pa._scratch) == pa.SCRATCH_KEEP
    assert pa._scratch_for(cpu, 7, S, H, C, DH, 64) is not first


def test_cpu_path_never_touches_the_library(monkeypatch):
    def no_build(name):
        raise AssertionError(f"the CPU path loaded {name}")

    monkeypatch.setattr(cuda_build, "load", no_build)
    inp = _inputs("straddle+clip", "fp32")
    o, _, _ = _port(inp, paged_attn_step_cuda)
    np.testing.assert_array_equal(o, _port(inp)[0])
