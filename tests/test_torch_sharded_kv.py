"""Context-parallel paged KV on the port against the JAX package's.

Every lane runs on the CPU, on the reference's own invariance trace
(``tests/test_sharded_kv.py``'s ``DIMS`` and ``PROMPTS``):

  * the rank steps: the port's ``PagedRankStep`` against the reference's
    (``kernel="xla"``) on the same inputs, head and page axes, int8 and
    fp32 pools, world 2 and 3 bounds, over a prefill and decode steps;
    the finish step, with and without ``per_pos``, on one merged output;
    the copied ``merge_partial_softmax`` bit for bit;
  * the executor: ``ShardedPagedKVExecutor`` over the reference test's
    world / axis / pool / loop matrix decodes the reference single
    worker's golden streams byte for byte, speculative verify included;
    the shard axis rule, ``KVSpec``'s fingerprint and per-rank geometry,
    page export and import, ``kv_rank_stats`` and the ``rank`` label of
    ``/metrics``, and the shard plane's fault semantics;
  * the process backend (slow): two ``shard_worker --kv`` processes on
    the CPU decode the golden streams.

Bars:
  * tokens exact; int8 codes exact;
  * fp32 pool rows and per-block scales within 1e-6
    (``tests/test_torch_paged_step.py``'s bar: the projections are float32
    matmuls in two libraries, and a scale is the amax of a projection);
  * attention partials (a head rank's ``o_r`` on its appended rows, a
    page rank's ``m``, ``l`` and ``o``) within ``ATTN_RTOL`` /
    ``ATTN_ATOL``: float32 sums of at most 32 terms in two libraries.
"""

import json
import re
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dpu_operator_tpu.parallel.ring_attention import (
    merge_partial_softmax as ref_merge)
from dpu_operator_tpu.serving import ShardedPagedKVExecutor as RefSharded
from dpu_operator_tpu.serving.disagg.spec import KVSpec as RefKVSpec
from dpu_operator_tpu.serving.kvcache import (
    resolve_shard_axis as ref_resolve)
from dpu_operator_tpu.serving.kvcache.paged import (
    PagedDecodeStep as RefDecodeStep)
from dpu_operator_tpu.serving.kvcache.paged import (
    PagedFinishStep as RefFinish)
from dpu_operator_tpu.serving.kvcache.paged import PagedRankStep as RefRank
from dpu_operator_tpu.serving.kvcache.paged import (
    build_paged_params as ref_build_params)
from dpu_operator_tpu_torch import faults
from dpu_operator_tpu_torch.parallel.ring_attention import (
    merge_partial_softmax)
from dpu_operator_tpu_torch.serving import (AdmissionQueue,
                                            ContinuousBatcher,
                                            GenerateRequest,
                                            PagedKVExecutor, ServingServer,
                                            ShardedPagedKVExecutor)
from dpu_operator_tpu_torch.serving.disagg.spec import KVSpec
from dpu_operator_tpu_torch.serving.kvcache import (SyntheticKVShardSet,
                                                    resolve_shard_axis)
from dpu_operator_tpu_torch.serving.kvcache.paged import (
    PagedDecodeStep, PagedFinishStep, PagedRankStep, params_from_numpy)
from dpu_operator_tpu_torch.serving.sharded import (ShardAborted,
                                                    ShardStepError)
from test_sharded_kv import DIMS, MAX_TOKENS, PROMPTS, _golden

torch.set_num_threads(1)

FLOAT_ATOL = 1e-6
ATTN_RTOL, ATTN_ATOL = 1e-5, 1e-6
STEP_DIMS = {k: v for k, v in DIMS.items() if k != "prefill_chunk"}
STEP_DIMS["chunk"] = DIMS["prefill_chunk"]
D_HEAD = DIMS["d"] // DIMS["heads"]
CPU = dict(device="cpu")


def _spec(cls, axis, world, pool_dtype="int8"):
    return cls(model="paged", block_size=DIMS["block_size"],
               heads=DIMS["heads"], d_head=D_HEAD, vocab=DIMS["vocab"],
               max_blocks_per_req=DIMS["max_blocks_per_req"],
               pool_dtype=pool_dtype, planes=2, seed=DIMS["seed"],
               shard_axis=axis, world=world)


def _req(prompt, max_tokens=MAX_TOKENS):
    return GenerateRequest(prompt_vec=None, max_tokens=max_tokens,
                           deadline=time.monotonic() + 60.0,
                           prompt_tokens=list(prompt))


def _drive_direct(ex, prompts, max_tokens=MAX_TOKENS):
    """The reference test's sync-loop driver on the port's classes: waves
    of ``ex.slots`` prompts, submit/collect until every stream is full."""
    streams = []
    for i in range(0, len(prompts), ex.slots):
        reqs = [_req(p, max_tokens) for p in prompts[i:i + ex.slots]]
        for s, r in enumerate(reqs):
            ex.kv_attach(s, r)
        got = [[] for _ in reqs]
        for _ in range(200):
            toks = ex.collect(ex.submit((), gen=ex.kv_gen()))
            for s in range(len(reqs)):
                if toks[s] >= 0 and len(got[s]) < max_tokens:
                    got[s].append(int(toks[s]))
                    reqs[s].tokens.append(int(toks[s]))
            if all(len(st) == max_tokens for st in got):
                break
        assert all(len(st) == max_tokens for st in got), got
        for s, r in enumerate(reqs):
            ex.kv_release_slot(s, cache=False)
            r.finish()
        streams.extend(got)
    ex.allocator.assert_clean()
    return streams


def _drive_batched(ex, prompts, max_tokens=MAX_TOKENS, timeout=60.0):
    q = AdmissionQueue(max_depth=len(prompts) + 1)
    b = ContinuousBatcher(ex, q)
    reqs = [_req(p, max_tokens) for p in prompts]
    for r in reqs:
        q.submit(r)
    b.start()
    try:
        for r in reqs:
            assert r.wait(timeout=timeout), "request lost"
    finally:
        b.stop()
    for r in reqs:
        assert r.error is None, r.error
    ex.allocator.assert_clean()
    return [list(r.tokens) for r in reqs]


# -- the rank steps -----------------------------------------------------------


def _step_inputs(rng, step):
    """Host inputs of one step at DIMS' shapes: a prefill chunk across a
    block edge and a short one, then decode rows, over permuted
    tables."""
    S, C = DIMS["slots"], DIMS["prefill_chunk"]
    n_new = np.array([C, 3] if step < 2 else [1, 1], np.int32)
    host = rng.randint(0, DIMS["vocab"], (S, C)).astype(np.int32)
    use_host = np.array([True, step != 3])
    prev = rng.randint(0, DIMS["vocab"], S).astype(np.int32)
    return prev, host, use_host, n_new


RANK_CASES = [("head", 2, "int8"), ("head", 2, "fp32"),
              ("page", 2, "int8"), ("page", 2, "fp32"),
              ("page", 3, "int8"), ("page", 3, "fp32")]


@pytest.mark.parametrize("axis,world,pool_dtype", RANK_CASES)
def test_rank_steps_match_reference(axis, world, pool_dtype):
    spec = _spec(RefKVSpec, axis, world, pool_dtype)
    N = DIMS["num_blocks"]
    params = params_from_numpy(
        {k: np.asarray(v) for k, v in ref_build_params(
            DIMS["seed"], DIMS["vocab"], DIMS["d"],
            spec.max_context).items()}, "cpu")
    for r in range(world):
        kw = dict(shard_axis=axis, head_bounds=spec.rank_heads(r),
                  block_bounds=spec.rank_blocks(r, N),
                  pool_dtype=pool_dtype)
        ref = RefRank(**STEP_DIMS, kernel="xla", **kw)
        port = PagedRankStep(**STEP_DIMS, params=params, **kw, **CPU)
        assert port.kernel == "torch"
        assert (port.pool_heads, port.pool_blocks) == (ref.pool_heads,
                                                       ref.pool_blocks)
        ref_pools = list(ref.init_pools())
        pools = list(port.init_pools())
        rng = np.random.RandomState(r)
        tables = rng.permutation(N)[:2 * DIMS["max_blocks_per_req"]]
        tables = tables.reshape(2, -1).astype(np.int32)
        ctx = np.array([2, 0], np.int32)
        for step in range(4):
            prev, host, use_host, n_new = _step_inputs(rng, step)
            args = (prev, host, use_host, ctx, n_new, tables)
            want = ref(*ref_pools, *(jnp.asarray(a) for a in args))
            got = port(*pools, *(torch.from_numpy(a) for a in args))
            ref_pools, pools = list(want[:4]), list(got[:4])
            tag = f"rank {r} step {step}"
            for name, a, b in zip(("kpool", "kscale", "vpool", "vscale"),
                                  want[:4], got[:4]):
                a, b = np.asarray(a), b.numpy()
                assert b.shape == a.shape, (tag, name)
                if pool_dtype == "int8" and name.endswith("pool"):
                    np.testing.assert_array_equal(b, a, err_msg=f"{tag} "
                                                  f"{name}")
                else:
                    np.testing.assert_allclose(b, a, rtol=0,
                                               atol=FLOAT_ATOL,
                                               err_msg=f"{tag} {name}")
            if axis == "head":
                # The appended rows: padding rows attend differently in
                # the two compositions and no caller reads them.
                a, b = np.asarray(want[4]), got[4].numpy()
                assert b.shape == a.shape == (2, DIMS["prefill_chunk"],
                                              port.pool_heads, D_HEAD)
                for s in range(2):
                    np.testing.assert_allclose(
                        b[s, :n_new[s]], a[s, :n_new[s]], rtol=ATTN_RTOL,
                        atol=ATTN_ATOL, err_msg=f"{tag} o_r slot {s}")
            else:
                assert len(got) == 7
                for name, a, b in zip("mlo", want[4:], got[4:]):
                    np.testing.assert_allclose(
                        b.numpy(), np.asarray(a), rtol=ATTN_RTOL,
                        atol=ATTN_ATOL, err_msg=f"{tag} {name}")
            ctx = ctx + n_new


@pytest.mark.parametrize("per_pos", [False, True])
def test_finish_step_matches_reference(per_pos):
    S, C, d = DIMS["slots"], DIMS["prefill_chunk"], DIMS["d"]
    fin_kw = dict(slots=S, vocab=DIMS["vocab"], d=d,
                  block_size=DIMS["block_size"],
                  max_blocks_per_req=DIMS["max_blocks_per_req"], chunk=C,
                  seed=DIMS["seed"], per_pos=per_pos)
    ref, port = RefFinish(**fin_kw), PagedFinishStep(**fin_kw, **CPU)
    rng = np.random.RandomState(5)
    for trial in range(4):
        o = rng.randn(S, C, d).astype(np.float32)
        prev, host, use_host, n_new = _step_inputs(rng, trial)
        ctx = rng.randint(0, 20, S).astype(np.int32)
        args = (prev, host, use_host, ctx, n_new, o)
        want = np.asarray(ref(*(jnp.asarray(a) for a in args)))
        got = port(*(torch.from_numpy(a) for a in args)).numpy()
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_merge_partial_softmax_is_the_reference_bit_for_bit():
    rng = np.random.RandomState(3)
    shape = (2, 3, 4)
    parts = []
    for r in range(3):
        m = rng.randn(*shape).astype(np.float32)
        l = rng.uniform(0.5, 4.0, shape).astype(np.float32)
        o = rng.randn(*shape, 8).astype(np.float32)
        # Rank r owns nothing for some rows: the fold identity.
        none = rng.rand(*shape) < 0.3
        m[none], l[none], o[none] = -1e30, 0.0, 0.0
        parts.append((m, l, o))
    got = merge_partial_softmax(parts)
    want = ref_merge(parts)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ident = [(np.full(shape, -1e30, np.float32), np.zeros(shape, np.float32),
              np.zeros(shape + (8,), np.float32))] * 2
    assert not merge_partial_softmax(ident).any()
    np.testing.assert_array_equal(merge_partial_softmax(ident),
                                  ref_merge(ident))
    with pytest.raises(ValueError, match="partial"):
        merge_partial_softmax([])


def test_rank_step_kernel_rules():
    spec = _spec(KVSpec, "page", 2)
    kw = dict(shard_axis="page", head_bounds=spec.rank_heads(0),
              block_bounds=spec.rank_blocks(0, DIMS["num_blocks"]))
    with pytest.raises(ValueError, match="flash partials"):
        PagedRankStep(**STEP_DIMS, **kw, kernel="cuda", **CPU)
    head = dict(shard_axis="head", head_bounds=(0, 1),
                block_bounds=(0, DIMS["num_blocks"]))
    with pytest.raises(ValueError, match="CUDA"):
        PagedRankStep(**STEP_DIMS, **head, kernel="cuda", **CPU)
    with pytest.raises(ValueError, match="head|page"):
        PagedRankStep(**STEP_DIMS, shard_axis="ring", head_bounds=(0, 1),
                      block_bounds=(0, 1), **CPU)
    assert PagedRankStep(**STEP_DIMS, **head, **CPU).kernel == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        ShardedPagedKVExecutor(world=2, shard_axis="head", kernel="cuda",
                               **DIMS, **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PagedRankStep(**STEP_DIMS, **head)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShardedPagedKVExecutor(world=2, shard_axis="head", **DIMS)


def test_ranks_and_finish_share_one_weight_copy():
    sset = SyntheticKVShardSet(_spec(KVSpec, "head", 2), slots=2,
                               num_blocks=DIMS["num_blocks"],
                               chunk=DIMS["prefill_chunk"], **CPU)
    try:
        steps = [st.step for st in sset._states] + [sset._finish]
        for name in ("embed", "wq", "wo", "wout"):
            ptrs = {getattr(s, name).data_ptr() for s in steps}
            assert len(ptrs) == 1, name
        assert [st.kpool.shape[2] for st in sset._states] == [1, 1]
    finally:
        sset.close()


# -- the executor -------------------------------------------------------------


# tests/test_sharded_kv.py's matrix.
CASES = [
    (1, "head", "int8", "sync"),
    (2, "head", "int8", "sync"),
    (2, "page", "int8", "pipelined"),
    (3, "page", "int8", "sync"),
    (2, "head", "fp32", "pipelined"),
    (2, "page", "fp32", "sync"),
]


@pytest.mark.parametrize("world,axis,pool_dtype,mode", CASES)
def test_sharded_streams_byte_identical_to_reference_single_worker(
        world, axis, pool_dtype, mode):
    ex = ShardedPagedKVExecutor(world=world, shard_axis=axis, mode=mode,
                                pool_dtype=pool_dtype, **DIMS, **CPU)
    try:
        drive = _drive_direct if mode == "sync" else _drive_batched
        streams = drive(ex, PROMPTS)
        assert streams == _golden(pool_dtype), (streams,
                                                _golden(pool_dtype))
        assert ex.shards.outstanding() == 0
        ex.allocator.assert_clean()
    finally:
        ex.close()


def test_speculative_on_sharded_kv_equals_single_worker_and_reference():
    from dpu_operator_tpu.serving import AdmissionQueue as RefQueue
    from dpu_operator_tpu.serving import ContinuousBatcher as RefBatcher
    from dpu_operator_tpu.serving import GenerateRequest as RefRequest
    from dpu_operator_tpu.serving import PagedKVExecutor as RefPaged

    ref = RefPaged(mode="speculative", spec_k=3, **DIMS)
    q = RefQueue(max_depth=len(PROMPTS) + 1)
    b = RefBatcher(ref, q)
    reqs = [RefRequest(prompt_vec=None, max_tokens=MAX_TOKENS,
                       deadline=time.monotonic() + 60.0,
                       prompt_tokens=list(p)) for p in PROMPTS]
    for r in reqs:
        q.submit(r)
    b.start()
    try:
        for r in reqs:
            assert r.wait(timeout=60.0)
    finally:
        b.stop()
    golden = [list(r.tokens) for r in reqs]

    single = PagedKVExecutor(mode="speculative", spec_k=3, **DIMS, **CPU)
    assert _drive_batched(single, PROMPTS) == golden
    ex = ShardedPagedKVExecutor(world=2, shard_axis="head",
                                mode="speculative", spec_k=3, **DIMS, **CPU)
    try:
        streams = _drive_batched(ex, PROMPTS)
        assert streams == golden, (streams, golden)
        assert ex.kv_stats()["spec_verify_steps"] > 0
        assert ex.shards.outstanding() == 0
    finally:
        ex.close()


def test_shard_axis_resolution_and_spec_validation():
    for heads, world in ((2, 2), (2, 3), (4, 2), (3, 3), (32, 3)):
        assert (resolve_shard_axis("auto", heads, world)
                == ref_resolve("auto", heads, world))
    assert resolve_shard_axis("auto", heads=2, world=2) == "head"
    assert resolve_shard_axis("auto", heads=2, world=3) == "page"
    assert resolve_shard_axis("page", heads=2, world=2) == "page"
    with pytest.raises(ValueError, match="head"):
        _spec(KVSpec, "head", 3)
    flat = KVSpec(model="paged", block_size=4, heads=2, d_head=8, vocab=32,
                  max_blocks_per_req=8, pool_dtype="int8")
    sharded = _spec(KVSpec, "head", 2)
    assert flat.fingerprint() != sharded.fingerprint()
    assert sum(sharded.rank_heads(r)[1] - sharded.rank_heads(r)[0]
               for r in range(2)) == 2
    paged = _spec(KVSpec, "page", 3)
    spans = [paged.rank_blocks(r, 64) for r in range(3)]
    assert spans[0][0] == 0 and spans[-1][1] == 64
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("axis,world,heads,pool_dtype", [
    ("head", 2, 32, "int8"), ("head", 4, 32, "fp32"),
    ("page", 3, 32, "fp32"), ("none", 1, 2, "int8")])
def test_kv_spec_geometry_equals_reference(axis, world, heads, pool_dtype):
    kw = dict(model="paged", block_size=16, heads=heads, d_head=128,
              vocab=32000, max_blocks_per_req=256, pool_dtype=pool_dtype,
              shard_axis=axis, world=world)
    port, ref = KVSpec(**kw), RefKVSpec(**kw)
    assert port.fingerprint() == ref.fingerprint()
    for r in range(world):
        assert port.rank_heads(r) == ref.rank_heads(r)
        for n in (8192, 64, 7 + world):
            assert port.rank_blocks(r, n) == ref.rank_blocks(r, n)
            assert (port.rank_resident_nbytes(r, n)
                    == ref.rank_resident_nbytes(r, n))
        for codec in ((pool_dtype,) if pool_dtype == "int8"
                      else ("fp32", "int8")):
            assert (port.rank_wire_block_nbytes(r, codec)
                    == ref.rank_wire_block_nbytes(r, codec))


def test_page_export_equals_reference_and_import_round_trips():
    blocks = list(range(DIMS["num_blocks"]))
    ref = RefSharded(world=2, shard_axis="page", mode="sync", **DIMS)
    port = ShardedPagedKVExecutor(world=2, shard_axis="page", mode="sync",
                                  **DIMS, **CPU)
    try:
        from test_sharded_kv import _drive_direct as ref_drive

        assert ref_drive(ref, PROMPTS) == _golden("int8")
        assert _drive_direct(port, PROMPTS) == _golden("int8")
        want, want_counts = ref.shards.export_rank_pages(blocks)
        got, counts = port.shards.export_rank_pages(blocks)
    finally:
        ref.close()
        port.close()
    assert counts == want_counts == [32, 32]
    written = 0
    for r in range(2):
        for (k, ks), (wk, wks) in zip(got[r], want[r]):
            assert k.dtype == np.int8 and k.shape == wk.shape
            np.testing.assert_array_equal(k, np.asarray(wk))
            np.testing.assert_allclose(ks, np.asarray(wks), rtol=0,
                                       atol=FLOAT_ATOL)
            written += int(np.count_nonzero(k))
    assert written > 0, "the trace wrote no pages"
    fresh = SyntheticKVShardSet(_spec(KVSpec, "page", 2), slots=2,
                                num_blocks=DIMS["num_blocks"],
                                chunk=DIMS["prefill_chunk"], **CPU)
    try:
        order = [fresh._rank_owned(r, blocks) for r in range(2)]
        fresh.import_rank_pages(blocks, got, {"rank_index": order})
        again, again_counts = fresh.export_rank_pages(blocks)
    finally:
        fresh.close()
    assert again_counts == counts
    for r in range(2):
        for (k, ks), (k2, ks2) in zip(got[r], again[r]):
            assert k.tobytes() == k2.tobytes()
            assert ks.tobytes() == ks2.tobytes()


@pytest.mark.parametrize("axis", ["head", "page"])
def test_kv_rank_stats_equal_reference(axis):
    ref = RefSharded(world=2, shard_axis=axis, mode="sync", **DIMS)
    port = ShardedPagedKVExecutor(world=2, shard_axis=axis, mode="sync",
                                  **DIMS, **CPU)
    try:
        from dpu_operator_tpu.serving import GenerateRequest as RefRequest

        assert port.kv_rank_stats() == ref.kv_rank_stats()
        for ex, cls in ((ref, RefRequest), (port, GenerateRequest)):
            for s, p in enumerate(PROMPTS[:2]):
                ex.kv_attach(s, cls(prompt_vec=None, max_tokens=2,
                                    deadline=time.monotonic() + 60.0,
                                    prompt_tokens=list(p)))
        got, want = port.kv_rank_stats(), ref.kv_rank_stats()
        assert got == want
        assert sum(v["blocks_used"] for v in got.values()) > 0
    finally:
        ref.close()
        port.close()


def test_metrics_expose_the_rank_label_of_kv_blocks():
    ex = ShardedPagedKVExecutor(world=2, shard_axis="page",
                                mode="pipelined", **DIMS, **CPU)
    srv = ServingServer([ex]).start()
    try:
        body = json.dumps({"prompt_tokens": PROMPTS[0], "max_tokens": 2,
                           "deadline_ms": 30000}).encode()
        urllib.request.urlopen(
            urllib.request.Request(srv.url + "/v1/generate", data=body),
            timeout=30).read()
        text = urllib.request.urlopen(srv.url + "/metrics",
                                      timeout=5).read().decode()
    finally:
        srv.stop()
    lines = [ln for ln in text.splitlines()
             if ln.startswith("serving_kv_blocks{")]
    for r in ("0", "1"):
        for state in ("used", "free"):
            pat = re.compile(r'serving_kv_blocks\{(?=[^}]*rank="%s")'
                             r'(?=[^}]*state="%s")' % (r, state))
            assert any(pat.match(ln) for ln in lines), (r, state, lines)
    assert any('state="used"' in ln for ln in lines if "rank=" not in ln)
    ex.allocator.assert_clean()
    ex.close()


def _pools(sset):
    return [[t.clone() for t in (st.kpool, st.kscale, st.vpool, st.vscale)]
            for st in sset._states]


def test_rank_fault_poisons_the_generation_and_reset_keeps_pools():
    ex = ShardedPagedKVExecutor(world=2, shard_axis="head", mode="sync",
                                **DIMS, **CPU)
    try:
        for s, p in enumerate(PROMPTS[:2]):
            ex.kv_attach(s, _req(p))
        ex.collect(ex.submit((), gen=ex.kv_gen()))
        with faults.injected() as plan:
            plan.inject("kvshard1.step", exc=RuntimeError("rank down"),
                        times=1)
            with pytest.raises(ShardStepError) as err:
                ex.collect(ex.submit((), gen=ex.kv_gen()))
        assert err.value.rank == 1
        assert plan.fired.get("kvshard1.step") == 1
        # The generation is poisoned: the next step aborts at once.
        job = ex.shards.submit(dict(step_no=99, host_tok=None,
                                    use_host=None, ctx=None, n_new=None,
                                    tables=None))
        with pytest.raises(ShardAborted, match="poisoned"):
            ex.shards.collect(job, timeout=5.0)
        before, resets = _pools(ex.shards), ex.shards.resets
        ex.shards.reset()
        after = _pools(ex.shards)
        for a, b in zip(before, after):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        assert ex.shards.outstanding() == 0
        assert ex.shards.resets == resets + 1
        # Served again after the re-rendezvous.
        assert ex.shards.collect(ex.shards.submit(dict(
            step_no=100, host_tok=np.zeros((2, 8), np.int32),
            use_host=np.ones(2, bool), ctx=np.zeros(2, np.int32),
            n_new=np.zeros(2, np.int32),
            tables=np.zeros((2, 8), np.int32))), timeout=30.0).shape == (2,)
        assert ex.shards.outstanding() == 0
    finally:
        ex.close()


# -- the single-worker step's fault and method --------------------------------


def test_take_prev_needs_per_pos():
    step = PagedDecodeStep(**STEP_DIMS, **CPU)
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="take_prev needs per_pos=True"):
        step.take_prev(torch.zeros(2, dtype=torch.int32), z, z)
    spec_step = PagedDecodeStep(**STEP_DIMS, per_pos=True, **CPU)
    out = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    got = spec_step.take_prev(out, torch.tensor([3, 0], dtype=torch.int32),
                              torch.tensor([7, 9], dtype=torch.int32))
    assert got.tolist() == [2, 9]


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
def test_kv_bytes_per_slot_method_equals_reference(pool_dtype):
    ref = RefDecodeStep(**STEP_DIMS, kernel="xla", pool_dtype=pool_dtype)
    port = PagedDecodeStep(**STEP_DIMS, pool_dtype=pool_dtype, **CPU)
    assert port.kv_bytes_per_slot() == ref.kv_bytes_per_slot() > 0


# -- the process backend ------------------------------------------------------


@pytest.mark.slow
def test_process_shard_set_world2_streams_match_golden():
    from dpu_operator_tpu_torch.serving.kvcache import KVShardProcessSet

    spec = _spec(KVSpec, "head", 2)
    backend = KVShardProcessSet(spec, slots=DIMS["slots"],
                                num_blocks=DIMS["num_blocks"],
                                chunk=DIMS["prefill_chunk"], **CPU)
    ex = ShardedPagedKVExecutor(world=2, shard_axis="head", mode="sync",
                                backend=backend, **DIMS, **CPU)
    try:
        streams = _drive_direct(ex, PROMPTS)
        assert streams == _golden("int8")
        assert ex.shards.outstanding() == 0
        assert sorted(ex.shards.live_ranks()) == [0, 1]
    finally:
        ex.close()
