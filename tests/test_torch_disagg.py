"""Disaggregated prefill/decode serving on the port against the JAX
package's.

Every test of ``tests/test_disagg.py`` has a counterpart here on the
port's copies (``serving/disagg/{spec,stream,pool}.py``, the batcher, the
pool, faults, the flight recorder and metrics), asserting what the
reference's asserts, with zero leaked blocks on both pools. On top:

  * the disaggregated streams on the port's ``SyntheticKVExecutor`` and
    ``PagedKVExecutor`` (``device="cpu"``; int8 and fp32 pools; sync and
    pipelined decode loops) equal the reference's COLOCATED streams on the
    same trace and seed, driven by the reference's own batcher;
  * the page stream between the packages, both ways: the reference's
    ``KVPageStream`` into the port's ``KVPageStreamServer`` and the
    reverse, the imported planes byte-identical to the sent ones;
  * the mixed pair: the reference's ``PagedKVExecutor`` as the prefill
    replica and the port's as the decode replica, in the port's
    ``DisaggPool``. The bar is exact equality with the reference's
    colocated streams, int8 and fp32: int8 pages ship their codes and
    scales verbatim, and fp32 pages ship the reference's rows losslessly,
    which the port then reads as its own (the port's fp32 rows equal the
    reference's within 1e-6, ``tests/test_torch_paged_step.py``);
  * a ``KVSpecMismatch`` between the packages when the seeds differ, and
    ``kv_spec.fingerprint()`` equal across the packages for the same
    arguments;
  * set arrival schedules forced on both packages' executors
    (``scripts/disagg_schedule.py``): under each, the port's arrivals,
    prefill chunks and streams equal the reference's, colocated and
    disaggregated; and the reference's own int8 streams change with the
    schedule while its fp32 streams do not.
"""

import functools
import importlib.util
import json
import os
import time
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch

from dpu_operator_tpu.serving import AdmissionQueue as RefQueue
from dpu_operator_tpu.serving import ContinuousBatcher as RefBatcher
from dpu_operator_tpu.serving import GenerateRequest as RefRequest
from dpu_operator_tpu.serving import PagedKVExecutor as RefPaged
from dpu_operator_tpu.serving import SyntheticKVExecutor as RefSynth
from dpu_operator_tpu.serving.disagg import KVPageStream as RefStream
from dpu_operator_tpu.serving.disagg import KVPageStreamServer as RefServer
from dpu_operator_tpu.serving.disagg import KVSpec as RefSpec
from dpu_operator_tpu_torch import faults
from dpu_operator_tpu_torch.faults import FaultyExecutor
from dpu_operator_tpu_torch.obs import FlightRecorder
from dpu_operator_tpu_torch.obs import trace as obs_trace
from dpu_operator_tpu_torch.serving import (AdmissionQueue,
                                            ContinuousBatcher, DisaggPool,
                                            GenerateRequest, KVSpecMismatch,
                                            PagedKVExecutor, ServingServer,
                                            SyntheticKVExecutor)
from dpu_operator_tpu_torch.serving.disagg import (KVPageStream,
                                                   KVPageStreamServer,
                                                   KVSpec, KVStreamNack)
from dpu_operator_tpu_torch.serving.disagg.spec import CodecMismatch
from dpu_operator_tpu_torch.utils.metrics import Registry

torch.set_num_threads(1)

# The reference's invariance trace: the 26-token prompt fills the whole
# block table; the 25-token one chunk-prefills mid-run.
PROMPTS = [list(np.arange(25) % 13), [3, 1, 4, 1, 5], [9] * 12,
           list(np.arange(26) % 13)]
MAX_TOKENS = 6

POOL_OPTS = dict(watchdog_s=0.5, restart_backoff_s=0.01, poll_s=0.005)
PAGED = dict(slots=2, block_size=4, num_blocks=64, max_blocks_per_req=8,
             prefill_chunk=8, seed=0, vocab=32, d=16, heads=2)
SYNTH = dict(slots=2, block_size=4, num_blocks=64, max_blocks_per_req=16,
             prefill_chunk=8, pipelined=True)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    leaked = faults.active_plan()
    faults.uninstall()
    assert leaked is None, "test leaked an installed FaultPlan"


@pytest.fixture()
def settle_counts(monkeypatch):
    counts = Counter()
    orig = GenerateRequest.finish

    def counting(self):
        counts[self.request_id] += 1
        orig(self)

    monkeypatch.setattr(GenerateRequest, "finish", counting)
    return counts


def _req(prompt, max_tokens=MAX_TOKENS, deadline_s=60.0, cls=GenerateRequest):
    return cls(prompt_vec=None, max_tokens=max_tokens,
               deadline=time.monotonic() + deadline_s,
               prompt_tokens=list(prompt))


def _drive_colocated(ex, prompts, ref=False, **req_kw):
    """Colocated streams of ``prompts`` on ``ex``, through the port's
    queue and batcher, or the reference's (``ref``)."""
    queue_cls, batcher_cls, req_cls = (
        (RefQueue, RefBatcher, RefRequest) if ref
        else (AdmissionQueue, ContinuousBatcher, GenerateRequest))
    q = queue_cls(max_depth=len(prompts) + 4)
    b = batcher_cls(ex, q)
    reqs = [_req(p, cls=req_cls, **req_kw) for p in prompts]
    for r in reqs:
        q.submit(r)
    b.start()
    try:
        for r in reqs:
            assert r.wait(30), "request lost"
    finally:
        b.stop()
    for r in reqs:
        assert r.error is None, r.error
    ex.allocator.assert_clean()
    return [list(r.tokens) for r in reqs]


def _drive_disagg(pool, queue, prompts, timeout=30.0, **req_kw):
    reqs = [_req(p, **req_kw) for p in prompts]
    for r in reqs:
        queue.submit(r)
    for r in reqs:
        assert r.wait(timeout), "request lost"
    for r in reqs:
        assert r.error is None, r.error
    return [list(r.tokens) for r in reqs], reqs


def _serve_disagg(pool, queue, prompts, timeout=30.0,
                  req_cls=GenerateRequest):
    """Queue every prompt, then start ``pool``, wait for the streams and
    stop it. Int8 pages depend on the steps at which the prefill replica
    attaches the requests (``test_reference_int8_streams_follow_the_
    arrivals``); with all of them queued before the first step those
    steps are fixed, as in ``_drive_colocated``."""
    reqs = [_req(p, cls=req_cls) for p in prompts]
    for r in reqs:
        queue.submit(r)
    pool.start()
    try:
        for r in reqs:
            assert r.wait(timeout), "request lost"
    finally:
        pool.stop()
    for r in reqs:
        assert r.error is None, r.error
    return [list(r.tokens) for r in reqs], reqs


def _synth(**kw):
    return SyntheticKVExecutor(**dict(SYNTH, **kw))


def _paged(pool_dtype, mode="pipelined", **kw):
    return PagedKVExecutor(**dict(PAGED, **kw), mode=mode,
                           pool_dtype=pool_dtype, device="cpu")


def _ref_paged(pool_dtype, mode="pipelined", **kw):
    return RefPaged(**dict(PAGED, **kw), mode=mode, pool_dtype=pool_dtype,
                    kernel="xla")


@functools.lru_cache(maxsize=None)
def _ref_colocated(kind):
    """The reference's colocated streams of PROMPTS: ``"synth"`` on its
    SyntheticKVExecutor, ``"int8"`` / ``"fp32"`` on its PagedKVExecutor,
    through its own queue and batcher."""
    ex = RefSynth(**SYNTH) if kind == "synth" else _ref_paged(kind)
    try:
        return _drive_colocated(ex, PROMPTS, ref=True)
    finally:
        ex.close()


# -- KVSpec: layout declared once, slice math derived -------------------------


def test_spec_derives_wire_bytes_and_segments():
    spec = KVSpec(model="paged", block_size=4, heads=2, d_head=8,
                  vocab=32, max_blocks_per_req=8, pool_dtype="int8")
    # 4*2*8 = 64 int8 code bytes + 4 scale bytes, twice (K and V).
    assert spec.wire_block_nbytes("int8") == 2 * (64 + 4)
    segs = spec.segments(7, "int8", max_seg_bytes=3 * 136)
    assert segs == [(0, 3), (3, 3), (6, 1)]
    assert spec.segments(0, "int8") == []
    pay, sc = spec.plane_part_nbytes("int8", 3)
    assert (pay, sc) == (3 * 64, 12)
    assert spec.blocks_for_tokens(9) == 3


def test_spec_hello_rejects_codec_and_layout_mismatch():
    spec = KVSpec(model="paged", block_size=4, heads=2, d_head=8,
                  vocab=32, max_blocks_per_req=8, pool_dtype="fp32")
    with pytest.raises(CodecMismatch):
        spec.check_hello(spec.fingerprint(), "fp32", "int8")
    other = KVSpec(model="paged", block_size=8, heads=2, d_head=8,
                   vocab=32, max_blocks_per_req=8, pool_dtype="fp32")
    with pytest.raises(KVSpecMismatch, match="block_size"):
        spec.check_hello(other.fingerprint(), "fp32", "fp32")
    reseeded = KVSpec(model="paged", block_size=4, heads=2, d_head=8,
                      vocab=32, max_blocks_per_req=8,
                      pool_dtype="fp32", seed=7)
    with pytest.raises(KVSpecMismatch, match="seed"):
        spec.check_hello(reseeded.fingerprint(), "fp32", "fp32")


def test_spec_int8_pool_requires_int8_wire():
    spec = KVSpec(model="paged", block_size=4, heads=2, d_head=8,
                  vocab=32, max_blocks_per_req=8, pool_dtype="int8")
    assert spec.default_codec() == "int8"
    with pytest.raises(ValueError, match="int8"):
        spec.validate_codec("fp32")


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
def test_kv_spec_fingerprint_equals_the_reference(pool_dtype):
    port, ref = _paged(pool_dtype), _ref_paged(pool_dtype)
    try:
        assert port.kv_spec.fingerprint() == ref.kv_spec.fingerprint()
        assert port.kv_spec.fingerprint()["pool_dtype"] == pool_dtype
    finally:
        port.close()
        ref.close()
    ps, rs = _synth(), RefSynth(**SYNTH)
    try:
        assert ps.kv_spec.fingerprint() == rs.kv_spec.fingerprint()
    finally:
        ps.close()
        rs.close()


# -- the page stream: framed transport + hello + segmentation ----------------


def test_stream_roundtrip_and_mismatch_rejection():
    spec = KVSpec(model="paged", block_size=2, heads=2, d_head=4,
                  vocab=32, max_blocks_per_req=8, pool_dtype="fp32")
    got = {}

    def import_fn(meta, planes):
        got["meta"] = meta
        got["planes"] = planes
        return {"ok_extra": 1}

    srv = KVPageStreamServer(spec, import_fn, codec="fp32")
    try:
        rng = np.random.RandomState(0)
        k = rng.randn(5, 2, 2, 4).astype(np.float32)
        v = rng.randn(5, 2, 2, 4).astype(np.float32)
        ones = np.ones((5,), np.float32)
        st = KVPageStream(spec, srv.addr, codec="fp32", seg_bytes=80)
        assert len(spec.segments(5, "fp32", 80)) > 1
        ack = st.send_pages(
            {"req": "r1", "n_blocks": 5, "tokens": 10,
             "prompt_tokens": [1], "settled": [], "max_tokens": 1,
             "cached": 0}, [(k, ones), (v, ones)])
        assert ack["ok"] and ack["ok_extra"] == 1
        np.testing.assert_array_equal(got["planes"][0][0], k)
        np.testing.assert_array_equal(got["planes"][1][0], v)

        other = KVSpec(model="paged", block_size=4, heads=2, d_head=4,
                       vocab=32, max_blocks_per_req=8,
                       pool_dtype="fp32")
        bad = KVPageStream(other, srv.addr, codec="fp32")
        with pytest.raises(KVStreamNack, match="block_size"):
            bad.connect()
        mixed = KVPageStream(spec, srv.addr, codec="int8")
        with pytest.raises(KVStreamNack, match="codec"):
            mixed.connect()
        st.close()
    finally:
        srv.close()


def test_stream_import_failure_nacks_with_oom_flag():
    spec = KVSpec(model="paged", block_size=2, heads=1, d_head=2,
                  vocab=32, max_blocks_per_req=4, pool_dtype="fp32",
                  planes=1)

    def import_fn(meta, planes):
        raise RuntimeError("kv cache exhausted: need 4, 0 free")

    srv = KVPageStreamServer(spec, import_fn, codec="fp32")
    try:
        st = KVPageStream(spec, srv.addr, codec="fp32")
        blocks = np.zeros((1, 2, 1, 2), np.float32)
        with pytest.raises(KVStreamNack) as ei:
            st.send_pages({"req": "r", "n_blocks": 1, "tokens": 2,
                           "prompt_tokens": [1], "settled": [],
                           "max_tokens": 1, "cached": 0},
                          [(blocks, np.ones((1,), np.float32))])
        assert ei.value.oom
        st.close()
    finally:
        srv.close()


def _pool_planes(pool_dtype, n_blocks=5, seed=0):
    """K and V planes of ``n_blocks`` blocks in a pool's layout: int8
    codes with per-block scales, or f32 rows with unit scales."""
    rng = np.random.RandomState(seed)
    shape = (n_blocks, 4, 2, 8)
    out = []
    for _ in range(2):
        if pool_dtype == "int8":
            out.append((rng.randint(-127, 128, shape).astype(np.int8),
                        rng.rand(n_blocks).astype(np.float32) + 0.5))
        else:
            out.append((rng.randn(*shape).astype(np.float32),
                        np.ones((n_blocks,), np.float32)))
    return out


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_stream_between_packages_is_byte_identical(direction, pool_dtype):
    """One package's stream into the other's server: the hello passes
    (equal fingerprints, the pool's default codec), the transfer splits
    into several segments, and the importer gets the sent planes byte
    for byte."""
    fields = dict(model="paged", block_size=4, heads=2, d_head=8,
                  vocab=32, max_blocks_per_req=8, pool_dtype=pool_dtype)
    if direction == "reference_to_port":
        send_spec, recv_spec = RefSpec(**fields), KVSpec(**fields)
        stream_cls, server_cls = RefStream, KVPageStreamServer
    else:
        send_spec, recv_spec = KVSpec(**fields), RefSpec(**fields)
        stream_cls, server_cls = KVPageStream, RefServer
    got = {}

    def import_fn(meta, planes):
        got["meta"], got["planes"] = meta, planes
        return {"blocks": int(meta["n_blocks"])}

    planes = _pool_planes(pool_dtype)
    srv = server_cls(recv_spec, import_fn)
    try:
        st = stream_cls(send_spec, srv.addr, seg_bytes=600)
        assert len(send_spec.segments(5, send_spec.default_codec(),
                                      600)) > 1
        meta = {"req": "x", "n_blocks": 5, "tokens": 20,
                "prompt_tokens": list(range(20)), "settled": [7],
                "max_tokens": 3, "cached": 4}
        ack = st.send_pages(meta, planes)
        st.close()
    finally:
        srv.close()
    assert ack["ok"] and ack["blocks"] == 5
    for k in meta:
        assert got["meta"][k] == meta[k]
    for (a, sa), (b, sb) in zip(planes, got["planes"]):
        assert np.asarray(b).dtype == a.dtype
        assert np.asarray(b).tobytes() == a.tobytes()
        assert np.asarray(sb, np.float32).tobytes() == sa.tobytes()


# -- lease detach/ack ---------------------------------------------------------


def test_lease_detach_reattach_contract():
    from dpu_operator_tpu_torch.serving.kvcache import (KVBlockAllocator,
                                                        KVLease)

    a = KVBlockAllocator(num_blocks=4, block_size=2)
    lease = KVLease(a, "ex", "r1", a.acquire(2, "r1"), (1, 2), 0)
    assert lease.detach() is True
    assert lease.in_transit and lease.resumable
    with pytest.raises(ValueError, match="double detach"):
        lease.detach()
    lease.reattach()
    assert not lease.in_transit
    assert lease.detach() is True
    assert lease.release() is True
    a.assert_clean()
    assert lease.detach() is False


def test_detach_slot_of_settled_request_is_none_not_crash():
    ex = _synth(pipelined=False)
    r = _req(PROMPTS[1])
    ex.kv_attach(0, r)
    r.fail("handler abandoned")  # settle choke point releases lease
    assert ex.kv_detach_slot(0) is None
    ex.allocator.assert_clean()
    ex.close()


def test_late_import_after_sender_gave_up_releases_pages():
    pre, dec = _synth(), _synth()
    q = AdmissionQueue(max_depth=4)
    pool = DisaggPool([pre], [dec], q, pool_opts=dict(POOL_OPTS))
    try:
        import_fn = pool._import_fn(0)
        meta = {"req": "ghost", "xfer": "dead-xfer", "n_blocks": 1,
                "tokens": 4, "cached": 0, "max_tokens": 1,
                "prompt_tokens": [1, 2, 3, 4], "settled": [5]}
        planes = [(np.asarray([[1.0], [2.0], [3.0], [4.0]],
                              np.float32).reshape(1, 4, 1, 1),
                   np.ones((1,), np.float32))]
        with pytest.raises(RuntimeError, match="abandoned"):
            import_fn(meta, planes)
        assert pool._imported == {}
        dec.allocator.assert_clean()
    finally:
        pool.stop()
    pre.close()
    dec.close()


def test_kv_attach_refuses_mid_transfer_lease():
    ex = _synth(pipelined=False)
    r = _req(PROMPTS[1])
    ex.kv_attach(0, r)
    detach = ex.kv_detach_slot(0)
    with pytest.raises(ValueError, match="mid-transfer"):
        ex.kv_attach(1, r)
    detach["lease"].reattach()
    assert ex.kv_attach(1, r) == 0  # resumes through _reattach
    ex.kv_release_slot(1, cache=False)
    r.finish()
    ex.allocator.assert_clean()
    ex.close()


# -- equivalence: disagg streams == colocated streams -------------------------


@pytest.mark.parametrize("decode_pipelined", [True, False])
def test_disagg_streams_match_colocated_synthetic(decode_pipelined):
    colo = _synth()
    baseline = _drive_colocated(colo, PROMPTS)
    colo.close()
    assert baseline == _ref_colocated("synth")

    pre, dec = _synth(), _synth()
    q = AdmissionQueue(max_depth=16)
    pool = DisaggPool(
        [pre], [dec], q, pool_opts=dict(POOL_OPTS),
        decode_pool_opts=dict(
            POOL_OPTS,
            batcher_kwargs={"pipelined": decode_pipelined}))
    pool.start()
    try:
        streams, _ = _drive_disagg(pool, q, PROMPTS)
    finally:
        pool.stop()
    assert streams == baseline
    assert any(len(set(s)) > 1 for s in baseline), \
        "degenerate streams would make this equality vacuous"
    assert pre.decode_tokens == len(PROMPTS)
    assert dec.decode_tokens == len(PROMPTS) * (MAX_TOKENS - 1)
    assert dec.resumed_total == len(PROMPTS)
    pre.allocator.assert_clean()
    dec.allocator.assert_clean()
    pre.close()
    dec.close()


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
def test_disagg_streams_match_colocated_paged(pool_dtype):
    """The port's paged executors on the CPU: two waves through a
    pipelined decode batcher (the second's prefill a prefix-cache hit on
    the prefill replica, its cached count carried across), then a third
    through a sync decode batcher; every wave decodes the reference's
    colocated streams and the port's own."""
    colo = _paged(pool_dtype)
    baseline = _drive_colocated(colo, PROMPTS)
    assert _drive_colocated(colo, PROMPTS) == baseline
    colo.close()
    assert baseline == _ref_colocated(pool_dtype)

    pre, dec = _paged(pool_dtype), _paged(pool_dtype)
    waves = []
    for _ in range(2):
        q = AdmissionQueue(max_depth=16)
        pool = DisaggPool([pre], [dec], q, pool_opts=dict(POOL_OPTS))
        assert pool.codec == ("int8" if pool_dtype == "int8" else "fp32")
        waves.append(_serve_disagg(pool, q, PROMPTS))
    (streams, _), (streams2, reqs2) = waves
    assert streams == baseline
    assert streams2 == baseline
    cached = [r.kv_lease.cached_tokens for r in reqs2]
    assert any(c > 0 for c in cached), cached
    assert dec.resumed_total == 2 * len(PROMPTS)
    pre.allocator.assert_clean()
    dec.allocator.assert_clean()

    q2 = AdmissionQueue(max_depth=16)
    pool_sync = DisaggPool(
        [pre], [dec], q2, pool_opts=dict(POOL_OPTS),
        decode_pool_opts=dict(
            POOL_OPTS, batcher_kwargs={"pipelined": False}))
    streams3, _ = _serve_disagg(pool_sync, q2, PROMPTS)
    assert streams3 == baseline
    pre.allocator.assert_clean()
    dec.allocator.assert_clean()
    pre.close()
    dec.close()


def _ref_disagg(pool_dtype, mode):
    """The reference's DisaggPool over two of its paged executors."""
    from dpu_operator_tpu.serving import DisaggPool as RefPool

    pre, dec = _ref_paged(pool_dtype, mode), _ref_paged(pool_dtype, mode)
    q = RefQueue(max_depth=16)
    pool = RefPool([pre], [dec], q, pool_opts=dict(POOL_OPTS))
    try:
        return _serve_disagg(pool, q, PROMPTS, req_cls=RefRequest)[0]
    finally:
        pre.close()
        dec.close()


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
def test_disagg_sync_executors_match_reference(pool_dtype):
    """Executors in sync mode (each step collected before the next is
    planned) behind the pool decode the reference's streams of the same
    pool. With fp32 pools those are the colocated streams. With int8
    pools the reference's own sync pair departs from its colocated
    streams on the 26-token prompt (the one that fills the block table)
    from its fifth token, and the port's pair decodes the same departure;
    pipelined pairs match colocated."""
    pre, dec = _paged(pool_dtype, "sync"), _paged(pool_dtype, "sync")
    q = AdmissionQueue(max_depth=16)
    pool = DisaggPool([pre], [dec], q, pool_opts=dict(POOL_OPTS))
    streams, _ = _serve_disagg(pool, q, PROMPTS)
    assert streams == _ref_disagg(pool_dtype, "sync")
    if pool_dtype == "fp32":
        assert streams == _ref_colocated(pool_dtype)
    assert pre.decode_tokens == len(PROMPTS)
    assert dec.resumed_total == len(PROMPTS)
    pre.allocator.assert_clean()
    dec.allocator.assert_clean()
    pre.close()
    dec.close()


def _load_schedule_script():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "disagg_schedule.py")
    spec = importlib.util.spec_from_file_location("disagg_schedule", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sched = _load_schedule_script()

# Arrival schedules, ``[submits before the attach, slot, prompt index]``
# (the slot is the batcher's pick), on four slots so that no prompt waits
# for one. The budget of 8 a step is shared: the 25- and 5-token prompts
# leave part of their last step's budget to the next prefilling slot.
SCHED_PAGED = dict(PAGED, slots=4)
SCHEDULES = {
    "together": [[0, None, 0], [0, None, 1], [0, None, 2], [0, None, 3]],
    "reversed": [[0, None, 3], [0, None, 2], [0, None, 1], [0, None, 0]],
    "stagger": [[0, None, 0], [1, None, 1], [2, None, 2], [3, None, 3]],
    "late_26": [[0, None, 0], [0, None, 1], [0, None, 2], [2, None, 3]],
    "mixed_a": [[0, None, 2], [1, None, 0], [1, None, 3], [3, None, 1]],
    "mixed_b": [[0, None, 1], [0, None, 3], [1, None, 0], [1, None, 2]],
}


def _forced(pool_dtype, ref, **kw):
    cls = sched.forcing(RefPaged if ref else PagedKVExecutor)
    extra = dict(kernel="xla") if ref else dict(device="cpu")
    return cls(**dict(SCHED_PAGED, **kw), mode="pipelined",
               pool_dtype=pool_dtype, prompts=PROMPTS, **extra)


@functools.lru_cache(maxsize=None)
def _ref_forced_colocated(name, pool_dtype):
    ex = _forced(pool_dtype, ref=True)
    try:
        streams = sched.replay_colocated(
            ex, SCHEDULES[name], PROMPTS, MAX_TOKENS, RefQueue, RefBatcher,
            RefRequest)
        ex.allocator.assert_clean()
        return streams, ex.arrivals, ex.chunks
    finally:
        ex.close()


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_forced_schedule_colocated_matches_reference(name, pool_dtype):
    """One arrival schedule forced on a colocated executor of each
    package: the same attaches (step and slot), the same prefill chunks
    and the same streams."""
    want, arrivals, chunks = _ref_forced_colocated(name, pool_dtype)
    assert [[k, i] for k, _, i in arrivals] == \
        [[k, i] for k, _, i in SCHEDULES[name]]
    ex = _forced(pool_dtype, ref=False)
    streams = sched.replay_colocated(
        ex, SCHEDULES[name], PROMPTS, MAX_TOKENS, AdmissionQueue,
        ContinuousBatcher, GenerateRequest)
    assert ex.arrivals == arrivals
    assert ex.chunks == chunks
    assert streams == want
    ex.allocator.assert_clean()
    ex.close()


def test_reference_int8_streams_follow_the_arrivals():
    """The reference's colocated int8 streams take more than one value
    over the schedules (the 26-token prompt's last tokens), its fp32
    streams one: int8 pages depend on where the prefill chunks fall on
    the block grid, so the arrivals are part of an int8 stream's input,
    in the reference as in the port."""
    int8 = {json.dumps(_ref_forced_colocated(n, "int8")[0])
            for n in SCHEDULES}
    fp32 = {json.dumps(_ref_forced_colocated(n, "fp32")[0])
            for n in SCHEDULES}
    assert len(fp32) == 1
    assert len(int8) > 1
    grids = {json.dumps(sched.off_grid(_ref_forced_colocated(n, "int8")[2],
                                       SCHED_PAGED["block_size"]))
             for n in SCHEDULES}
    assert len(grids) > 1


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_forced_schedule_disagg_matches_reference(name):
    """One arrival schedule forced on the prefill replica of each
    package's DisaggPool (int8 pools, pipelined decode): the same
    attaches, the same prefill chunks and the same streams, and no leaked
    block on either package's pools."""
    from dpu_operator_tpu.serving import DisaggPool as RefPool

    got = {}
    for ref in (True, False):
        pre, dec = _forced("int8", ref), _forced("int8", ref)
        streams = sched.replay_disagg(
            pre, dec, SCHEDULES[name], PROMPTS, MAX_TOKENS,
            RefQueue if ref else AdmissionQueue,
            RefPool if ref else DisaggPool,
            RefRequest if ref else GenerateRequest, POOL_OPTS)
        assert pre.decode_tokens == len(PROMPTS)
        assert dec.resumed_total == len(PROMPTS)
        for ex in (pre, dec):
            ex.prefix.flush()
            ex.allocator.assert_clean()
        got[ref] = (streams, pre.arrivals, pre.chunks)
        pre.close()
        dec.close()
    assert got[False] == got[True]


# A divergence recorded on the CPU by ``scripts/disagg_schedule.py
# --device cpu --d 64 --heads 2 --num-blocks 2048 --threads 4``: the gold
# (phase 4's int8 executor over HTTP) attached the phase-4 prompt 1 first
# and the rest a step later; round 0 of phase 19 (a)'s lane attached
# prompt 0 first, and its streams left the gold's at request 2, token 6.
D64 = dict(d=64, heads=2, num_blocks=2048)
D64_GOLD = [[0, 0, 1], [1, 1, 7], [1, 2, 2], [1, 3, 4], [1, 4, 6],
            [1, 5, 5], [1, 6, 3], [1, 7, 0]]
D64_ROUND = [[0, 0, 0], [1, 1, 2], [1, 2, 1], [1, 3, 3], [1, 4, 4],
             [1, 5, 5], [1, 6, 6], [1, 7, 7]]


@pytest.mark.slow
def test_recorded_divergence_is_the_reference_s_under_its_arrivals():
    """The recorded diverging round's arrivals and the gold's, forced on
    the reference's colocated executor and on the port's at chip_smoke's
    served model cut to d 64: under each the two packages decode the same
    streams, and the two schedules' streams part at request 2, token 6,
    as the recorded HTTP runs did; the round's arrivals forced on the
    reference's DisaggPool decode the same streams as its colocated
    executor. So the departure is the reference's own under those
    arrivals, not the transfer's or the port's."""
    import chip_smoke as c
    from dpu_operator_tpu.serving import DisaggPool as RefPool

    prompts = c.serve_prompts()
    kw = dict(c.SERVE, **D64, pool_dtype="int8", mode="pipelined")
    got = {}
    for name, arrivals in (("gold", D64_GOLD), ("round", D64_ROUND)):
        for ref in (True, False):
            cls = sched.forcing(RefPaged if ref else PagedKVExecutor)
            ex = cls(**kw, prompts=prompts,
                     **(dict(kernel="xla") if ref else dict(device="cpu")))
            got[name, ref] = sched.replay_colocated(
                ex, arrivals, prompts, c.MAX_TOKENS,
                RefQueue if ref else AdmissionQueue,
                RefBatcher if ref else ContinuousBatcher,
                RefRequest if ref else GenerateRequest)
            assert [[k, i] for k, _, i in ex.arrivals] == \
                [[k, i] for k, _, i in arrivals]
            ex.close()
        assert got[name, True] == got[name, False], name
    assert c.first_diff(got["round", True], got["gold", True]) == (2, 6)
    pre = sched.forcing(RefPaged)(**kw, prompts=prompts, kernel="xla")
    dec = RefPaged(**kw, kernel="xla")
    streams = sched.replay_disagg(pre, dec, D64_ROUND, prompts,
                                  c.MAX_TOKENS, RefQueue, RefPool,
                                  RefRequest, c.DISAGG_POOL)
    assert pre.arrivals == D64_ROUND
    assert streams == got["round", True]
    pre.close()
    dec.close()


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
def test_mixed_pair_decodes_the_reference_streams(pool_dtype):
    """The reference's PagedKVExecutor prefills, the port's decodes, in
    the port's DisaggPool: the spec check passes across the packages, the
    pages cross the wire, and the streams equal the reference's colocated
    ones exactly."""
    pre, dec = _ref_paged(pool_dtype), _paged(pool_dtype)
    q = AdmissionQueue(max_depth=16)
    reg = Registry()
    pool = DisaggPool([pre], [dec], q, registry=reg,
                      pool_opts=dict(POOL_OPTS))
    streams, _ = _serve_disagg(pool, q, PROMPTS)
    want = _ref_colocated(pool_dtype)
    diff = [(i, j, a, b) for i, (s, t) in enumerate(zip(streams, want))
            for j, (a, b) in enumerate(zip(s, t)) if a != b]
    assert streams == want, f"first differences (request, position, " \
        f"got, want): {diff[:5]}"
    assert pre.decode_tokens == len(PROMPTS)
    assert dec.resumed_total == len(PROMPTS)
    assert reg.counter_value("serving_kv_transfers_total",
                             {"outcome": "ok"}) == len(PROMPTS)
    pre.allocator.assert_clean()
    dec.allocator.assert_clean()
    pre.close()
    dec.close()


def test_pool_refuses_a_reference_executor_of_another_seed():
    pre, dec = _ref_paged("int8"), _paged("int8", seed=1)
    try:
        with pytest.raises(KVSpecMismatch, match="seed"):
            DisaggPool([pre], [dec], AdmissionQueue(max_depth=4))
    finally:
        pre.close()
        dec.close()


# -- chaos: kill the transfer mid-stream --------------------------------------


def test_kill_transfer_mid_stream_recovers_exactly_once(
        settle_counts, tmp_path):
    t0 = time.perf_counter()

    def run(inject, flight_dir=None):
        pre, dec = _synth(), _synth()
        reg = Registry()
        q = AdmissionQueue(max_depth=16)
        rec = (FlightRecorder(flight_dir=str(flight_dir))
               if flight_dir is not None else None)
        pool = DisaggPool([pre], [dec], q, registry=reg, seg_bytes=16,
                          flight_recorder=rec,
                          pool_opts=dict(POOL_OPTS))
        pool.start()
        try:
            streams, reqs = _drive_disagg(pool, q, PROMPTS)
        finally:
            pool.stop()
        pre.allocator.assert_clean()
        dec.allocator.assert_clean()
        pre.close()
        dec.close()
        return streams, reqs, reg, dec

    baseline, _, _, _ = run(inject=False)
    with obs_trace.scoped() as tr:
        with faults.injected() as plan:
            plan.inject("kvstream.send",
                        exc=RuntimeError("cut mid-transfer"),
                        at_calls=[2, 6])
            injected, reqs, reg, dec = run(inject=True,
                                           flight_dir=tmp_path)
        spans = tr.spans_snapshot()
    assert injected == baseline, (injected, baseline)
    assert set(settle_counts.values()) == {1}, settle_counts
    assert dec.resumed_total == len(PROMPTS)
    assert reg.counter_value("serving_kv_transfers_total",
                             {"outcome": "requeued_prefill"}) >= 1
    assert reg.counter_value("serving_kv_transfers_total",
                             {"outcome": "ok"}) == len(PROMPTS)

    failed = [s for s in spans if s.name == "disagg.transfer"
              and s.attrs.get("error")]
    assert failed, "no failed transfer span recorded"
    victim = failed[0].request_id
    vspans = [s for s in spans if s.request_id == victim]
    names = [s.name for s in vspans]
    assert names.count("disagg.handoff") >= 2, names
    assert "queue.requeue" in names
    ok_import = [s for s in vspans if s.name == "disagg.import"]
    assert len(ok_import) == 1, "decode side must import exactly once"
    assert ok_import[-1].t0 >= failed[0].t1, \
        "import must follow the failed transfer"

    files = sorted(tmp_path.glob("flight-kv_transfer_failed-*.json"))
    assert files, sorted(p.name for p in tmp_path.iterdir())
    doc = json.loads(files[0].read_text())
    fspans = doc["spans"]
    fault = next(s for s in fspans if s["name"] == "fault.fired"
                 and s["attrs"].get("site") == "kvstream.send")
    xfer = next(s for s in fspans if s["name"] == "disagg.transfer"
                and s["attrs"].get("error"))
    hand = next(s for s in fspans if s["name"] == "disagg.handoff"
                and s["request_id"] == xfer["request_id"])
    rq = next(s for s in fspans if s["name"] == "queue.requeue"
              and s["request_id"] == xfer["request_id"])
    assert (hand["t0"] <= xfer["t0"] <= fault["t0"] <= rq["t0"]), \
        "injection -> detection -> migration out of order"
    assert doc["extra"]["outcome"] == "requeued_prefill"
    assert time.perf_counter() - t0 < 24.0


def test_connect_and_import_faults_requeue_to_prefill(settle_counts):
    def run(site=None):
        pre, dec = _synth(), _synth()
        reg = Registry()
        q = AdmissionQueue(max_depth=16)
        pool = DisaggPool([pre], [dec], q, registry=reg, seg_bytes=16,
                          pool_opts=dict(POOL_OPTS))
        pool.start()
        try:
            if site is None:
                streams, _ = _drive_disagg(pool, q, PROMPTS)
            else:
                with faults.injected() as plan:
                    plan.inject(site,
                                exc=RuntimeError(f"{site} down"),
                                at_calls=[1])
                    streams, _ = _drive_disagg(pool, q, PROMPTS)
        finally:
            pool.stop()
        pre.allocator.assert_clean()
        dec.allocator.assert_clean()
        pre.close()
        dec.close()
        return streams, reg

    baseline, _ = run()
    for site in ("kvstream.connect", "kvstream.import"):
        streams, reg = run(site)
        assert streams == baseline, site
        assert reg.counter_value(
            "serving_kv_transfers_total",
            {"outcome": "requeued_prefill"}) >= 1, site
    assert set(settle_counts.values()) == {1}, settle_counts


def test_kill_prefill_replica_mid_run_recovers(settle_counts):
    def run(inject):
        inner = _synth(fault_site="pf0" if inject else None)
        ex = FaultyExecutor(inner, site="pf0") if inject else inner
        dec = _synth()
        q = AdmissionQueue(max_depth=16)
        pool = DisaggPool([ex], [dec], q, pool_opts=dict(POOL_OPTS))
        pool.start()
        try:
            streams, _ = _drive_disagg(pool, q, PROMPTS)
        finally:
            pool.stop()
        inner.allocator.assert_clean()
        dec.allocator.assert_clean()
        inner.close()
        dec.close()
        return streams, pool

    baseline, _ = run(inject=False)
    with faults.injected() as plan:
        plan.inject("pf0.submit", exc=RuntimeError("injected kill"),
                    at_calls=[3])
        injected, pool = run(inject=True)
    assert injected == baseline
    assert set(settle_counts.values()) == {1}, settle_counts
    assert sum(pool.prefill_pool.restarts) >= 1


@pytest.mark.parametrize("kind", ["synth", "paged"])
def test_decode_oom_nack_requeues_to_prefill(settle_counts, kind):
    """A decode pool too small for the request's worst case nacks the
    import (oom): the request burns an attempt and retries via prefill
    until the budget exhausts, a 500 retries_exhausted, no leak. On the
    port's paged executor too."""
    if kind == "synth":
        pre, dec = _synth(), _synth(num_blocks=2)
    else:
        pre, dec = _paged("int8"), PagedKVExecutor(
            **dict(PAGED, num_blocks=2), pool_dtype="int8", device="cpu")
    q = AdmissionQueue(max_depth=8)
    reg = Registry()
    pool = DisaggPool([pre], [dec], q, registry=reg, max_attempts=2,
                      pool_opts=dict(POOL_OPTS))
    r = _req(PROMPTS[1])
    pool.start()
    try:
        q.submit(r)
        assert r.wait(20), "request lost"
    finally:
        pool.stop()
    assert r.error == "retries_exhausted"
    assert settle_counts[r.request_id] == 1
    assert reg.counter_value("serving_kv_transfers_total",
                             {"outcome": "retries_exhausted"}) == 1
    pre.allocator.assert_clean()
    dec.allocator.assert_clean()
    pre.close()
    dec.close()


# -- HTTP integration + metrics exposition ------------------------------------


def _post(url, body):
    data = json.dumps(body).encode()
    try:
        r = urllib.request.urlopen(
            urllib.request.Request(url + "/v1/generate", data=data),
            timeout=20)
        return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("kind", ["synth", "paged"])
def test_disagg_server_http_roundtrip_and_metrics(kind):
    """The front door over a DisaggPool, on the synthetic executors and on
    the port's fp32 paged ones: generate round-trips with the transferred
    lease's cached_tokens, /metrics carries the transfer series and the
    role-labelled pool gauge, and a drain completes."""
    if kind == "synth":
        pre, dec = _synth(), _synth()
    else:
        pre, dec = _paged("fp32"), _paged("fp32")
    reg = Registry()

    def factory(execs, queue, registry, tracer, flight_recorder):
        return DisaggPool([pre], [dec], queue, registry=registry,
                          tracer=tracer,
                          flight_recorder=flight_recorder,
                          pool_opts=dict(POOL_OPTS))

    srv = ServingServer([pre, dec], registry=reg,
                        pool_factory=factory).start()
    try:
        toks = [int(t) for t in PROMPTS[0]]
        code, body = _post(srv.url, {"prompt_tokens": toks,
                                     "max_tokens": 4,
                                     "deadline_ms": 20000})
        assert code == 200 and len(body["tokens"]) == 4
        if kind == "paged":
            assert body["tokens"] == _ref_colocated("fp32")[0][:4]
        code2, body2 = _post(srv.url, {"prompt_tokens": toks,
                                       "max_tokens": 4,
                                       "deadline_ms": 20000})
        assert code2 == 200 and body2["tokens"] == body["tokens"]
        assert body2["kv"]["cached_tokens"] > 0

        text = urllib.request.urlopen(srv.url + "/metrics",
                                      timeout=10).read().decode()
        assert 'serving_kv_transfer_bytes_total{codec="fp32"}' in text
        assert "serving_kv_transfer_seconds_bucket" in text
        assert ('serving_pool_replicas{role="prefill",'
                'sharded="false",state="live"} 1' in text)
        assert ('serving_pool_replicas{role="decode",'
                'sharded="false",state="live"} 1' in text)
        assert reg.counter_value("serving_kv_transfer_bytes_total",
                                 {"codec": "fp32"}) > 0
        assert srv.begin_drain(timeout=10.0)
    finally:
        srv.stop()
    pre.allocator.assert_clean()
    dec.allocator.assert_clean()
    pre.close()
    dec.close()


def test_disagg_pool_rejects_mismatched_executors():
    pre = _synth()
    dec = _synth(block_size=8, num_blocks=32)
    with pytest.raises(KVSpecMismatch):
        DisaggPool([pre], [dec], AdmissionQueue(max_depth=4))
    pre.close()
    dec.close()
