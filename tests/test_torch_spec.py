"""Speculative decoding on the port against the JAX package's.

Each lane runs the port and the reference on the same seed, weights,
prompts and plans, on the CPU:

  * the drafts: ``OracleDraft`` (a copy) and ``TruncatedDraft`` (rewritten
    in PyTorch) propose what the reference's propose, ties included;
  * the step: ``PagedDecodeStep(per_pos=True)``, ``tree_step`` and
    ``take_prev`` replay every plan the reference's own planner made on a
    speculative ``PagedKVExecutor`` and give its per-position tokens (rows
    ``< n_new``), int8 codes and scales exactly, fp32 pool rows within
    ``FLOAT_ATOL``;
  * the executor: ``PagedKVExecutor`` in ``speculative`` and
    ``speculative-pipelined`` mode, chain and tree windows, int8 and fp32
    pools, decodes the reference's streams with its spec counters, against
    its XLA composition and once against its Pallas kernel in interpret
    mode; and keeps the reference's own contracts (fp32 speculative ==
    sync, int8 deterministic, a pipeline peak of at least 2);
  * the planner at controlled acceptance: ``SyntheticKVExecutor`` with
    ``OracleDraft`` gives the reference's streams and stats over the
    accept and tree matrices, the sibling repair row, resume from the
    confirmed watermark and the spec series of ``/metrics``.
"""

import functools
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from dpu_operator_tpu.serving import AdmissionQueue as RefQueue
from dpu_operator_tpu.serving import ContinuousBatcher as RefBatcher
from dpu_operator_tpu.serving import GenerateRequest as RefRequest
from dpu_operator_tpu.serving import PagedKVExecutor as RefPaged
from dpu_operator_tpu.serving import SyntheticKVExecutor as RefSynth
from dpu_operator_tpu.serving import spec as ref_spec
from dpu_operator_tpu.serving.kvcache.paged import (
    build_paged_params as ref_build_params)
from dpu_operator_tpu_torch.serving import (AdmissionQueue,
                                            ContinuousBatcher,
                                            GenerateRequest, OracleDraft,
                                            PagedKVExecutor, ServingServer,
                                            SpecConfig, SyntheticKVExecutor,
                                            TruncatedDraft)
from dpu_operator_tpu_torch.serving import spec as port_spec
from dpu_operator_tpu_torch.serving.kvcache.paged import PagedDecodeStep
from dpu_operator_tpu_torch.serving.spec import propose_full, token_run

torch.set_num_threads(1)

MODEL = dict(vocab=32, d=16, heads=2)
PAGED = dict(slots=2, block_size=4, num_blocks=64, max_blocks_per_req=8,
             prefill_chunk=8, seed=0, **MODEL)
VOCAB = 64  # the synthetic executors' default
FLOAT_ATOL = 1e-6  # tests/test_torch_paged_step.py's bar
# The reference's invariance trace (tests/test_spec.py): a long prompt
# chunk-prefilled mid-run, a short one, a constant one, and the
# full-table 26-token edge.
PROMPTS = [list(np.arange(25) % 13), [3, 1, 4, 1, 5], [9] * 12,
           list(np.arange(26) % 13)]
SPEC_MODES = ("speculative", "speculative-pipelined")
POOLS = ("int8", "fp32")


def _req(cls, prompt, max_tokens=6):
    return cls(prompt_vec=None, max_tokens=max_tokens,
               deadline=time.monotonic() + 60, prompt_tokens=list(prompt))


def _drive(ex, prompts, max_tokens=6, ref=False):
    """Queue every prompt, serve them through a ContinuousBatcher (the
    package's own), return the token streams."""
    qcls, bcls, rcls = ((RefQueue, RefBatcher, RefRequest) if ref else
                        (AdmissionQueue, ContinuousBatcher, GenerateRequest))
    q = qcls(max_depth=len(prompts) + 1)
    b = bcls(ex, q)
    reqs = [_req(rcls, p, max_tokens) for p in prompts]
    for r in reqs:
        q.submit(r)
    b.start()
    try:
        for r in reqs:
            assert r.wait(timeout=120), "request lost"
    finally:
        b.stop()
    for r in reqs:
        assert r.error is None, r.error
    ex.allocator.assert_clean()
    return [list(r.tokens) for r in reqs]


def _spec_stats(st):
    """The spec counters of kv_stats(), without the in-flight gauge: a
    run's last plan-ahead window may still be in flight when the batcher
    stops, which depends on thread timing."""
    return {k: v for k, v in st.items()
            if k.startswith("spec_") and k != "spec_pipeline_depth"}


# -- drafts ------------------------------------------------------------------


@pytest.mark.parametrize("accept_rate,tree_width,sib_rate",
                         [(0.0, 1, 0.5), (0.6, 3, 1.0), (1.0, 2, 0.0),
                          (0.35, 4, 0.7)])
def test_oracle_draft_equals_reference(accept_rate, tree_width, sib_rate):
    rng = np.random.RandomState(11)
    last = rng.randint(0, VOCAB, 32).astype(np.int32)
    ctx = rng.randint(0, 500, 32).astype(np.int32)
    kw = dict(k=4, accept_rate=accept_rate, vocab=VOCAB, target_seed=3,
              seed=5, tree_width=tree_width, sib_rate=sib_rate)
    port, ref = OracleDraft(**kw), ref_spec.OracleDraft(**kw)
    np.testing.assert_array_equal(port.propose(last, ctx),
                                  ref.propose(last, ctx))
    np.testing.assert_array_equal(port.propose_sibs(last, ctx),
                                  ref.propose_sibs(last, ctx))
    np.testing.assert_array_equal(propose_full(port, last, ctx),
                                  ref_spec.propose_full(ref, last, ctx))


def _draft_pair(params, k, tree_width, slots):
    import jax.numpy as jnp

    names = ("embed", "wpos", "wout")
    ref = ref_spec.TruncatedDraft(*(jnp.asarray(params[n]) for n in names),
                                  k, slots, tree_width=tree_width)
    port = TruncatedDraft(*(torch.tensor(np.asarray(params[n]))
                            for n in names), k, slots,
                          tree_width=tree_width)
    return port, ref


@pytest.mark.parametrize("tree_width", [1, 3])
def test_truncated_draft_equals_reference(tree_width):
    """At MODEL widths, over every last token and positions up to past
    the table's end (the position clamps)."""
    T = PAGED["max_blocks_per_req"] * PAGED["block_size"]
    params = {k: np.asarray(v) for k, v in ref_build_params(
        0, MODEL["vocab"], MODEL["d"], T).items()}
    port, ref = _draft_pair(params, 3, tree_width, 2 * MODEL["vocab"])
    last = np.repeat(np.arange(MODEL["vocab"], dtype=np.int32), 2)
    ctx = np.tile(np.array([0, T - 2], np.int32), MODEL["vocab"])
    ctx[::7] = T + 5
    got = port.propose(last, ctx)
    assert got.shape == (len(last), 3) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref.propose(last, ctx))
    sibs = port.propose_sibs(last, ctx)
    assert sibs.shape == (len(last), tree_width - 1)
    np.testing.assert_array_equal(sibs, ref.propose_sibs(last, ctx))
    np.testing.assert_array_equal(propose_full(port, last, ctx),
                                  ref_spec.propose_full(ref, last, ctx))


def test_truncated_draft_ties_break_toward_the_lower_index():
    """Integer weights make the logits exact, and three equal columns of
    wout tie at the top: the argmax takes the first, and the sibling
    ranks follow in index order, as ``lax.top_k`` does."""
    rng = np.random.RandomState(2)
    V, d, T = 16, 8, 8
    params = dict(embed=rng.randint(1, 3, (V, d)).astype(np.float32),
                  wpos=rng.randint(0, 2, (T, d)).astype(np.float32),
                  wout=rng.randint(-2, 3, (d, V)).astype(np.float32))
    for col in (3, 7, 11):
        params["wout"][:, col] = 3.0
    port, ref = _draft_pair(params, 2, 4, V)
    last = np.arange(V, dtype=np.int32)
    ctx = np.arange(V, dtype=np.int32) % T
    trunk = port.propose(last, ctx)
    sibs = port.propose_sibs(last, ctx)
    np.testing.assert_array_equal(trunk, ref.propose(last, ctx))
    np.testing.assert_array_equal(sibs, ref.propose_sibs(last, ctx))
    assert (trunk == 3).all()
    assert (sibs[:, :2] == [7, 11]).all()
    # the rank after the tie: the first index of the next logit value
    x = params["embed"][last] + params["wpos"][ctx]
    logits = x @ params["wout"]
    want = np.argsort(-logits, axis=1, kind="stable")[:, 3]
    np.testing.assert_array_equal(sibs[:, 2], want)


# -- the step, plan by plan ---------------------------------------------------


def _record_reference(pool_dtype, mode, tree_width):
    """Serve PROMPTS[:3] on the reference and record every dispatched
    plan with the chain value before it, its per-position tokens and the
    pools and chain value after it."""
    ref = RefPaged(**PAGED, kernel="xla", pool_dtype=pool_dtype, mode=mode,
                   spec_k=3, spec_tree_width=tree_width)
    records = []
    dispatch = ref._dispatch

    def recording(plan):
        prev = np.asarray(ref._prev)
        out = dispatch(plan)
        records.append((plan, prev, np.asarray(out),
                        [np.asarray(a) for a in (ref._kpool, ref._kscale,
                                                 ref._vpool, ref._vscale)],
                        np.asarray(ref._prev)))
        return out

    ref._dispatch = recording
    streams = _drive(ref, PROMPTS[:3], ref=True)
    return records, streams


@pytest.mark.parametrize("pool_dtype", POOLS)
@pytest.mark.parametrize("mode,tree_width",
                         [("speculative", 1), ("speculative-pipelined", 1),
                          ("speculative-pipelined", 3)])
def test_step_replays_reference_plans(mode, tree_width, pool_dtype):
    records, _ = _record_reference(pool_dtype, mode, tree_width)
    dims = {k: v for k, v in PAGED.items() if k != "prefill_chunk"}
    step = PagedDecodeStep(**dims, chunk=PAGED["prefill_chunk"],
                           pool_dtype=pool_dtype, device="cpu",
                           per_pos=True, tree=tree_width > 1)
    pools = list(step.init_pools())
    verify = tree_rows = 0
    for i, (plan, prev, ref_out, ref_pools, ref_prev) in enumerate(records):
        t = {n: torch.from_numpy(np.asarray(getattr(plan, n)))
             for n in ("host_tok", "use_host", "ctx", "n_new", "tables",
                       "n_app")}
        prev = torch.tensor(prev)
        args = (*pools, prev, t["host_tok"],
                t["use_host"], t["ctx"], t["n_new"], t["tables"])
        if plan.roff is not None:
            out = step.tree_step(
                *args, t["n_app"].new_tensor(plan.roff),
                t["n_app"], torch.from_numpy(plan.plim),
                torch.from_numpy(plan.win))[4]
            tree_rows += int((plan.roff != np.arange(
                PAGED["prefill_chunk"])).sum())
        else:
            out = step(*args)[4]
        assert out.shape == ref_out.shape
        rows = np.arange(out.shape[1])[None, :] < plan.n_new[:, None]
        np.testing.assert_array_equal(out.numpy()[rows], ref_out[rows],
                                      err_msg=f"step {i}")
        verify += int((plan.spec_k >= 0).sum())
        for got, want, name in zip(pools, ref_pools, ("k", "ks", "v", "vs")):
            if pool_dtype == "int8" and name in ("k", "v"):
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{name} step {i}")
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=FLOAT_ATOL,
                                           err_msg=f"{name} step {i}")
        if mode == "speculative-pipelined":
            chained = step.take_prev(out, t["n_app"], prev)
            assert chained.dtype == torch.int32
            np.testing.assert_array_equal(chained.numpy(), ref_prev,
                                          err_msg=f"take_prev step {i}")
    assert verify > 0
    if tree_width > 1:
        assert tree_rows > 0, "no sibling row was ever planned"


def test_tree_needs_per_pos_and_take_prev_keeps_idle_rows():
    dims = {k: v for k, v in PAGED.items() if k != "prefill_chunk"}
    with pytest.raises(ValueError, match="per_pos"):
        PagedDecodeStep(**dims, chunk=8, device="cpu", tree=True)
    step = PagedDecodeStep(**dims, chunk=8, device="cpu", per_pos=True)
    with pytest.raises(RuntimeError, match="tree=True"):
        step.tree_step(*([None] * 14))
    out = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    got = step.take_prev(out, torch.tensor([3, 0], dtype=torch.int32),
                         torch.tensor([-5, 42], dtype=torch.int32))
    assert got.tolist() == [2, 42] and got.dtype == torch.int32
    assert [w.data_ptr() for w in step.draft_params] == \
        [step.embed.data_ptr(), step.wpos.data_ptr(), step.wout.data_ptr()]


# -- the paged executor ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_streams(mode, tree_width, pool_dtype):
    ex = RefPaged(**PAGED, kernel="xla", pool_dtype=pool_dtype, mode=mode,
                  spec_k=3, spec_tree_width=tree_width)
    streams = _drive(ex, PROMPTS[:3], ref=True)
    return streams, _spec_stats(ex.kv_stats())


def _port_paged(mode, pool_dtype, **kw):
    return PagedKVExecutor(**PAGED, pool_dtype=pool_dtype, mode=mode,
                           device="cpu", **kw)


@pytest.mark.parametrize("pool_dtype", POOLS)
@pytest.mark.parametrize("tree_width", [1, 3])
@pytest.mark.parametrize("mode", SPEC_MODES)
def test_paged_spec_streams_and_counters_match_reference(mode, tree_width,
                                                         pool_dtype):
    ex = _port_paged(mode, pool_dtype, spec_k=3,
                     spec_tree_width=tree_width)
    assert isinstance(ex.spec.draft, TruncatedDraft)
    streams = _drive(ex, PROMPTS[:3])
    st = _spec_stats(ex.kv_stats())
    want, want_st = _ref_streams(mode, tree_width, pool_dtype)
    assert streams == want
    assert st == want_st
    assert st["spec_verify_steps"] > 0
    assert any(len(set(s)) > 1 for s in streams)


def test_paged_spec_matches_reference_pallas_kernel_interpreted():
    """One lane against the reference's fused Pallas kernel (interpret
    mode), at the reference's own size for it: 2 prompts x 4 tokens."""
    ref = RefPaged(**PAGED, kernel="pallas", interpret=True,
                   pool_dtype="fp32", mode="speculative", spec_k=3)
    want = _drive(ref, PROMPTS[:2], max_tokens=4, ref=True)
    ex = _port_paged("speculative", "fp32", spec_k=3)
    assert _drive(ex, PROMPTS[:2], max_tokens=4) == want
    assert _spec_stats(ex.kv_stats()) == _spec_stats(ref.kv_stats())


@functools.lru_cache(maxsize=None)
def _port_sync_fp32():
    return _drive(_port_paged("sync", "fp32"), PROMPTS[:3])


@pytest.mark.parametrize("mode,tree_width",
                         [("speculative", 1), ("speculative-pipelined", 1),
                          ("speculative-pipelined", 3)])
def test_paged_fp32_spec_streams_equal_sync(mode, tree_width):
    """The reference's byte-identity contract on the port: fp32 pools,
    speculative streams == the one-token sync streams."""
    ex = _port_paged(mode, "fp32", spec_k=3, spec_tree_width=tree_width)
    streams = _drive(ex, PROMPTS[:3])
    st = ex.kv_stats()
    assert streams == _port_sync_fp32()
    assert st["spec_verify_steps"] > 0
    if mode == "speculative-pipelined":
        assert st["spec_pipeline_peak"] >= 2


@pytest.mark.parametrize("mode", SPEC_MODES)
def test_paged_int8_spec_is_deterministic_against_itself(mode):
    """int8 quantization groups differ from the one-token run by design
    (a verify window's rows, rejected ones included, set a block's scale),
    so the int8 contract is determinism, not equality with sync."""
    runs = [_drive(_port_paged(mode, "int8", spec_k=3), PROMPTS[:2],
                   max_tokens=5) for _ in range(2)]
    assert runs[0] == runs[1]


# -- the planner at controlled acceptance (SyntheticKVExecutor) --------------


def _synth_pair(spec_kw=None, pipelined=None, **kw):
    """A port and a reference SyntheticKVExecutor, each with its own
    package's OracleDraft on the same dials."""
    out = []
    for synth, oracle, config in ((SyntheticKVExecutor, OracleDraft,
                                   SpecConfig),
                                  (RefSynth, ref_spec.OracleDraft,
                                   ref_spec.SpecConfig)):
        spec = None
        if spec_kw is not None:
            d = dict(k=4, vocab=VOCAB, target_seed=0)
            d.update(spec_kw)
            spec = config(oracle(**d), d["k"])
        args = dict(slots=2, num_blocks=64,
                    pipelined=spec is None if pipelined is None
                    else pipelined)
        args.update(kw)
        out.append(synth(spec=spec, **args))
    return out


def _synth_run(spec_kw=None, pipelined=None, prompts=PROMPTS,
               max_tokens=6, **kw):
    """Port and reference streams and stats on the same trace."""
    got = []
    for ex, ref in zip(_synth_pair(spec_kw, pipelined, **kw),
                       (False, True)):
        streams = _drive(ex, prompts, max_tokens, ref=ref)
        got.append((streams, ex.kv_stats()))
        ex.close()
    (port, port_st), (ref, ref_st) = got
    assert port == ref
    port_st.pop("spec_pipeline_depth", None)
    ref_st.pop("spec_pipeline_depth", None)
    assert port_st == ref_st
    return port, port_st


@functools.lru_cache(maxsize=None)
def _synth_golden():
    return _synth_run()[0]


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("accept_rate", [0.0, 0.6, 1.0])
def test_synthetic_accept_matrix_matches_reference(accept_rate, pipelined):
    streams, st = _synth_run(dict(accept_rate=accept_rate), pipelined)
    assert streams == _synth_golden()
    assert any(len(set(s)) > 1 for s in streams)
    assert st["decode_tokens"] == sum(len(s) for s in streams)
    assert st["spec_verify_steps"] > 0
    if accept_rate == 0.0:
        assert st["spec_accepted_tokens"] == 0
    if accept_rate == 1.0:
        assert st["spec_accepted_tokens"] == st["spec_proposed_tokens"]
    if pipelined:
        assert st["spec_pipeline_peak"] >= 2
        if accept_rate == 0.0:
            assert st["spec_replans"] > 0   # every miss re-plans
        if accept_rate == 1.0:
            assert st["spec_replans"] == 0  # the chain never breaks


@pytest.mark.parametrize("accept_rate", [0.0, 0.5, 1.0])
def test_synthetic_tree_matrix_matches_reference(accept_rate):
    streams, st = _synth_run(dict(accept_rate=accept_rate, tree_width=3,
                                  sib_rate=1.0), True)
    assert streams == _synth_golden()
    if accept_rate == 0.0:
        assert st["spec_path_len"].get(2, 0) > 0
        assert st["spec_tokens_per_step"] > 1.0


def test_synthetic_sibling_repair_row_matches_reference():
    """After a sibling wins, the trunk's wrong token sits appended at the
    accepted position; the next window's repair row overwrites it. A long
    generation after many sibling accepts proves the repair."""
    prompt = [[3, 1, 4, 1, 5]]
    golden, _ = _synth_run(slots=1, prompts=prompt, max_tokens=24)
    streams, st = _synth_run(dict(k=3, accept_rate=0.0, tree_width=2,
                                  sib_rate=1.0), True, slots=1,
                             prompts=prompt, max_tokens=24)
    assert streams == golden
    assert st["spec_path_len"].get(2, 0) >= 8


@pytest.mark.parametrize("pipelined", [False, True])
def test_synthetic_resume_from_confirmed_watermark(pipelined):
    """Reset with (pipelined: a plan-ahead window in flight) part-way
    through: re-attach replays only settled tokens and the stream equals
    the unbroken one, on the port and on the reference."""
    prompt = list(np.arange(16) % 9)
    golden, _ = _synth_run(dict(accept_rate=0.6), pipelined, slots=1,
                           prompts=[prompt], max_tokens=8)
    streams = []
    for ex, rcls in zip(_synth_pair(dict(accept_rate=0.6), pipelined,
                                    slots=1),
                        (GenerateRequest, RefRequest)):
        req = _req(rcls, prompt, 8)
        ex.kv_attach(0, req)
        pending = ex.submit((), gen=ex.kv_gen()) if pipelined else None
        while len(req.tokens) < 3:
            nxt = ex.submit((), gen=ex.kv_gen())
            if pipelined:
                nxt, pending = pending, nxt
            req.tokens.extend(token_run(ex.collect(nxt)[0]))
        ex.reset()
        assert req.kv_lease.resumable
        ex.kv_attach(0, req)
        assert ex.resumed_total == 1
        while len(req.tokens) < 8:
            for t in token_run(ex.collect(ex.submit((),
                                                    gen=ex.kv_gen()))[0]):
                if len(req.tokens) < 8:
                    req.tokens.append(t)
        ex.kv_release_slot(0)
        req.finish()
        ex.allocator.assert_clean()
        ex.close()
        streams.append(list(req.tokens))
    assert streams == [golden[0], golden[0]]


def _scrape(ex, max_tokens):
    srv = ServingServer([ex]).start()
    try:
        body = json.dumps({"prompt_tokens": list(range(1, 10)),
                           "max_tokens": max_tokens,
                           "deadline_ms": 10000}).encode()
        for _ in range(2):
            urllib.request.urlopen(urllib.request.Request(
                srv.url + "/v1/generate", data=body), timeout=10).read()
        text = urllib.request.urlopen(srv.url + "/metrics",
                                      timeout=5).read().decode()
    finally:
        srv.stop()
    ex.allocator.assert_clean()
    ex.close()
    return {line.split()[0]: float(line.split()[-1])
            for line in text.splitlines()
            if line.startswith("serving_spec_")}


def test_metrics_expose_the_spec_series():
    ex = SyntheticKVExecutor(slots=2, num_blocks=64, pipelined=False,
                             spec=SpecConfig(OracleDraft(
                                 k=4, accept_rate=1.0, vocab=VOCAB), 4))
    got = _scrape(ex, 6)
    assert got["serving_spec_proposed_tokens_total"] > 0
    assert got["serving_spec_accepted_tokens_total"] > 0
    assert got["serving_spec_accept_rate"] == 1.0
    assert got["serving_spec_tokens_per_step"] > 1.0


def test_metrics_expose_the_pipelined_tree_series():
    d = OracleDraft(k=4, accept_rate=0.0, vocab=VOCAB, tree_width=2,
                    sib_rate=1.0)
    ex = SyntheticKVExecutor(slots=2, num_blocks=64, pipelined=True,
                             spec=SpecConfig(d, 4))
    got = _scrape(ex, 8)
    assert got["serving_spec_replans_total"] > 0
    assert got["serving_spec_pipeline_peak"] >= 2
    assert "serving_spec_pipeline_depth" in got
    assert got["serving_spec_tree_path_len_count"] > 0
    assert any(k.startswith("serving_spec_tree_path_len_bucket")
               for k in got)


def test_port_spec_module_keeps_the_reference_api():
    assert port_spec.__all__ == ref_spec.__all__
    for name in port_spec.__all__:
        assert hasattr(port_spec, name), name
