"""The port's serving slice end to end against the JAX package's.

The port's ``PagedKVExecutor(device="cpu")`` (plain attention) must decode
exactly the token streams of the reference ``PagedKVExecutor(kernel=
"xla")`` on the same prompts, in sync and pipelined mode, with int8 and
fp32 pools, three ways:

  * driven directly (attach, submit/collect, release);
  * through the port's ``ContinuousBatcher`` over an ``AdmissionQueue``;
  * through the port's ``ServingServer`` over HTTP (``prompt_tokens``).

Sync and pipelined streams are equal, and every block goes back to the
allocator (``assert_clean``) once the requests are released. The host
plane's other paths run on the port too: a prefix-cache hit, re-attach
after a reset, spill to the host tier and restore, the page export and
import hooks, and a pool poisoned past every written position.
"""

import functools
import json
import time
import urllib.request

import pytest
import torch

from dpu_operator_tpu.serving import GenerateRequest as RefRequest
from dpu_operator_tpu.serving import PagedKVExecutor as RefExecutor
from dpu_operator_tpu_torch.serving import (AdmissionQueue,
                                            ContinuousBatcher,
                                            GenerateRequest,
                                            PagedKVExecutor, ServingServer)

torch.set_num_threads(1)

DIMS = dict(slots=2, vocab=16, d=8, heads=2, block_size=4, num_blocks=32,
            max_blocks_per_req=4, prefill_chunk=4, seed=0)
# Three prompts through two slots: one request waits for a free slot.
PROMPTS = [[1, 2, 3, 4, 5, 6], [7, 8, 9], [9, 3, 14, 2, 2]]
MAX_TOKENS = 4
MODES = ("sync", "pipelined")
POOLS = ("int8", "fp32")


def _drive_direct(ex, req_cls, prompts):
    """Attach every prompt (in waves of ``slots``), submit/collect until
    each stream has MAX_TOKENS, release."""
    streams = []
    for i in range(0, len(prompts), ex.slots):
        wave = prompts[i:i + ex.slots]
        reqs = [req_cls(prompt_vec=None, max_tokens=MAX_TOKENS,
                        deadline=time.monotonic() + 60,
                        prompt_tokens=list(p)) for p in wave]
        for s, r in enumerate(reqs):
            ex.kv_attach(s, r)
        for _ in range(200):
            toks = ex.collect(ex.submit((), gen=ex.kv_gen()))
            for s, r in enumerate(reqs):
                if toks[s] >= 0 and len(r.tokens) < MAX_TOKENS:
                    r.tokens.append(int(toks[s]))
            if all(len(r.tokens) == MAX_TOKENS for r in reqs):
                break
        for s, r in enumerate(reqs):
            ex.kv_release_slot(s, cache=False)
            r.finish()
        streams += [list(r.tokens) for r in reqs]
    ex.allocator.assert_clean()
    return streams


@functools.lru_cache(maxsize=None)
def _golden(mode, pool_dtype):
    ex = RefExecutor(**DIMS, kernel="xla", pool_dtype=pool_dtype,
                     mode=mode)
    streams = _drive_direct(ex, RefRequest, PROMPTS)
    assert all(len(s) == MAX_TOKENS for s in streams)
    return streams


def _port(mode, pool_dtype):
    return PagedKVExecutor(**DIMS, pool_dtype=pool_dtype, mode=mode,
                           device="cpu")


def _drive_batched(ex, prompts):
    q = AdmissionQueue(max_depth=len(prompts) + 1)
    b = ContinuousBatcher(ex, q)
    reqs = [GenerateRequest(prompt_vec=None, max_tokens=MAX_TOKENS,
                            deadline=time.monotonic() + 60,
                            prompt_tokens=list(p)) for p in prompts]
    for r in reqs:
        q.submit(r)
    b.start()
    try:
        for r in reqs:
            assert r.wait(timeout=30), "request lost"
    finally:
        b.stop()
    for r in reqs:
        assert r.error is None, r.error
    return [list(r.tokens) for r in reqs]


def _release_all(ex):
    if ex.prefix is not None:
        ex.prefix.flush()
    ex.allocator.assert_clean()


@pytest.mark.parametrize("pool_dtype", POOLS)
@pytest.mark.parametrize("mode", MODES)
def test_direct_streams_match_reference(mode, pool_dtype):
    streams = _drive_direct(_port(mode, pool_dtype), GenerateRequest,
                            PROMPTS)
    assert streams == _golden(mode, pool_dtype)
    assert any(len(set(s)) > 1 for s in streams)


@pytest.mark.parametrize("pool_dtype", POOLS)
@pytest.mark.parametrize("mode", MODES)
def test_batcher_streams_match_reference(mode, pool_dtype):
    ex = _port(mode, pool_dtype)
    assert _drive_batched(ex, PROMPTS) == _golden(mode, pool_dtype)
    _release_all(ex)


def _post(url, body):
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


@pytest.mark.parametrize("pool_dtype", POOLS)
@pytest.mark.parametrize("mode", MODES)
def test_http_streams_match_reference(mode, pool_dtype):
    ex = _port(mode, pool_dtype)
    srv = ServingServer([ex]).start()
    try:
        out = [_post(srv.url, {"prompt_tokens": p, "max_tokens": MAX_TOKENS,
                               "deadline_ms": 30000}) for p in PROMPTS]
    finally:
        srv.stop()
    for code, body in out:
        assert code == 200, body
        assert not body["truncated"]
    assert [body["tokens"] for _, body in out] == _golden(mode, pool_dtype)
    _release_all(ex)


@pytest.mark.parametrize("pool_dtype", POOLS)
def test_sync_and_pipelined_streams_equal(pool_dtype):
    sync = _drive_direct(_port("sync", pool_dtype), GenerateRequest,
                         PROMPTS)
    pipe = _drive_direct(_port("pipelined", pool_dtype), GenerateRequest,
                         PROMPTS)
    assert sync == pipe


def test_speculative_modes_construct_and_unknown_mode_raises():
    """Both speculative modes build on the CPU with the reference's
    defaults (a truncated draft over the step's weights, chain windows);
    tests/test_torch_spec.py holds what they decode."""
    from dpu_operator_tpu_torch.serving import TruncatedDraft

    for mode in ("speculative", "speculative-pipelined"):
        ex = PagedKVExecutor(**DIMS, mode=mode, spec_k=3, device="cpu")
        assert ex.speculative and isinstance(ex.spec.draft, TruncatedDraft)
        assert ex.pipelined == (mode == "speculative-pipelined")
        assert ex.spec.tree_width == 1 and not ex.spec.adaptive
        assert ex._paged.per_pos and not ex._paged.tree
    ex = PagedKVExecutor(**DIMS, mode="speculative", spec_k=2,
                         spec_tree_width=2, spec_adaptive=True,
                         device="cpu")
    assert ex._paged.tree and ex.spec.adaptive
    # the default spec_k=4 needs a window of 5 rows, over the chunk of 4
    with pytest.raises(ValueError, match="prefill_chunk"):
        PagedKVExecutor(**DIMS, mode="speculative", device="cpu")
    with pytest.raises(ValueError, match="mode must be"):
        PagedKVExecutor(**DIMS, mode="lookahead", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        PagedKVExecutor(**DIMS, mode="speculative", spec_k=3,
                        kernel="cuda", device="cpu")


def test_page_export_import_round_trip_is_byte_exact():
    """The hand-off hooks the tier and disaggregation planes use: pages
    exported from one executor and imported into another land byte for
    byte, in place."""
    src = _port("sync", "int8")
    _drive_direct(src, GenerateRequest, PROMPTS[:1])
    blocks = [0, 1, 2]
    planes = src._export_pages(blocks, None, 12)
    dst = _port("sync", "int8")
    dst._import_pages([5, 6, 7], planes, {})
    for (a, asc), name in zip(planes, ("k", "v")):
        pool = getattr(dst, f"_{name}pool")[[5, 6, 7]].numpy()
        scale = getattr(dst, f"_{name}scale")[[5, 6, 7]].numpy()
        assert (pool == a).all() and (scale == asc).all()
    (k1, _), _ = dst._tier_export_block(6, None)
    assert (k1[0] == planes[0][0][1]).all()
    dst._tier_import_block(9, src._tier_export_block(2, None), None)
    assert torch.equal(dst._kpool[9], src._kpool[2])
    assert torch.equal(dst._vscale[9], src._vscale[2])


def test_spec_fields_equal_the_reference():
    """The pool layout and model identity a KV hand-off checks: a port
    replica and a reference replica of one configuration describe
    themselves identically."""
    for pool_dtype in POOLS:
        ref = RefExecutor(**DIMS, kernel="xla", pool_dtype=pool_dtype,
                          mode="sync", warmup=False)
        port = PagedKVExecutor(**DIMS, pool_dtype=pool_dtype, mode="sync",
                               warmup=False, device="cpu")
        assert port._spec_fields() == ref._spec_fields()
        assert port._spec_fields()["model"] == "paged"


@pytest.mark.parametrize("pool_dtype", POOLS)
def test_poisoned_unwritten_blocks_cannot_leak(pool_dtype):
    """The reference's executor-level guard test, on the port: poison
    every pool row (garbage int8 codes or NaN rows) and every scale
    (NaN), decode the same prompts again, and the streams are the clean
    run's: every attended position is re-written before attention
    reaches it, and the valid-block guard zeroes the rest."""
    ex = PagedKVExecutor(**DIMS, pool_dtype=pool_dtype, mode="sync",
                         prefix_cache=False, device="cpu")
    golden = _drive_direct(ex, GenerateRequest, PROMPTS)
    if pool_dtype == "int8":
        ex._kpool.fill_(113)
        ex._vpool.fill_(-113)
    else:
        ex._kpool.fill_(float("nan"))
        ex._vpool.fill_(float("nan"))
    ex._kscale.fill_(float("nan"))
    ex._vscale.fill_(float("nan"))
    assert _drive_direct(ex, GenerateRequest, PROMPTS) == golden


# -- prefix reuse, re-attach and the host tier, on the port -------------------

TIER_PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]  # 3 blocks at bs=4


def _batched(ex, prompt):
    (stream,) = _drive_batched(ex, [prompt])
    return stream


@pytest.mark.parametrize("pool_dtype", POOLS)
def test_prefix_cache_hit_reproduces_reference_stream(pool_dtype):
    """A cache-hit rerun decodes the cold run's stream, which is the
    reference's: cached blocks are reused byte for byte, and fresh
    appends restart at a block-aligned cursor."""
    ex = _port("pipelined", pool_dtype)
    first = _batched(ex, TIER_PROMPT)
    hits0 = ex.prefix.hit_tokens
    second = _batched(ex, TIER_PROMPT)
    assert ex.prefix.hit_tokens > hits0, "the rerun never hit the cache"
    ref = RefExecutor(**DIMS, kernel="xla", pool_dtype=pool_dtype,
                      mode="sync")
    golden = _drive_direct(ref, RefRequest, [TIER_PROMPT])[0]
    assert first == second == golden
    _release_all(ex)


def test_reattach_after_reset_resumes_identically():
    """Kill/resume: decode part-way, reset() (pools survive), re-attach
    from the settled tokens; the continuation equals the uninterrupted
    stream (the scale-once quantizer makes appends idempotent)."""
    ex = _port("sync", "int8")
    golden = _drive_direct(ex, GenerateRequest, [PROMPTS[0]])[0]
    req = GenerateRequest(prompt_vec=None, max_tokens=MAX_TOKENS,
                          deadline=time.monotonic() + 60,
                          prompt_tokens=list(PROMPTS[0]))
    ex.kv_attach(0, req)
    while len(req.tokens) < 2:
        t = int(ex.collect(ex.submit((), gen=ex.kv_gen()))[0])
        if t >= 0:
            req.tokens.append(t)
    ex.reset()
    assert req.kv_lease.resumable
    ex.kv_attach(0, req)
    while len(req.tokens) < MAX_TOKENS:
        t = int(ex.collect(ex.submit((), gen=ex.kv_gen()))[0])
        if t >= 0:
            req.tokens.append(t)
    assert list(req.tokens) == golden
    ex.kv_release_slot(0, cache=False)
    req.finish()
    _release_all(ex)


def test_host_tier_spill_and_restore_reproduce_the_stream():
    """Evict the cached chain to host RAM (codes + scales copied out
    verbatim), rerun the prompt: the blocks come back byte for byte, the
    hits are credited to the host tier, and the stream is unchanged."""
    ex = PagedKVExecutor(**DIMS, pool_dtype="int8", mode="sync",
                         host_tier_bytes=1 << 20, device="cpu")
    first = _batched(ex, TIER_PROMPT)
    keys = set(ex.prefix.keys())
    assert len(keys) == 3 and ex.prefix.evict(99) == 3
    assert set(ex.tier.keys()) == keys
    again = _batched(ex, TIER_PROMPT)
    assert again == first
    st = ex.kv_stats()
    assert st["prefix_hit_tokens_host"] == 8
    assert st["tier_restored_blocks"] == 2
    _release_all(ex)
    ex.tier.assert_clean()
