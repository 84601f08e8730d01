"""The prefix router and the role autoscaler on the port against the JAX
package's.

Counterparts of every test of ``tests/test_router.py`` on the port's
copies (``serving/router/{gossip,router}.py`` over its
``SyntheticKVExecutor``), asserting what the reference's assert, with
both replicas' allocator and tier ledgers clean; of the router's chaos
case in ``tests/test_chaos_serving.py`` (a pull cut mid-stream falls back
to local prefill, one timeline carries router decision, failed pull and
queue leg); and of the autoscaler's thread-free ``tick()`` tests in
``tests/test_qos.py``. On top: the chain keys equal the reference's, and
the load-skew pull runs over the port's ``PagedKVExecutor``
(``device="cpu"``, int8 and fp32 pools), the pulled prefix decoding the
reference's stream exactly. No check leans on a wall-clock margin: the
gossip cadence is 0 or passed ``now``, and ``tick()`` takes ``now``.
"""

import time

import pytest
import torch

from dpu_operator_tpu.serving import AdmissionQueue as RefQueue
from dpu_operator_tpu.serving import ContinuousBatcher as RefBatcher
from dpu_operator_tpu.serving import GenerateRequest as RefRequest
from dpu_operator_tpu.serving import PagedKVExecutor as RefPaged
from dpu_operator_tpu.serving.router import chain_keys as ref_chain_keys
from dpu_operator_tpu_torch import faults
from dpu_operator_tpu_torch.obs import FlightRecorder
from dpu_operator_tpu_torch.obs import trace as obs_trace
from dpu_operator_tpu_torch.serving import (AdmissionQueue,
                                            ContinuousBatcher, DisaggPool,
                                            GenerateRequest,
                                            PagedKVExecutor, RoleAutoscaler,
                                            SyntheticKVExecutor)
from dpu_operator_tpu_torch.serving.kvcache import CACHE_OWNER, PrefixTree
from dpu_operator_tpu_torch.serving.kvcache.allocator import _ROOT
from dpu_operator_tpu_torch.serving.router import (GossipBoard,
                                                   PrefixRouter,
                                                   ReplicaGossip,
                                                   RouterReplica,
                                                   chain_keys)
from dpu_operator_tpu_torch.utils.metrics import Registry

torch.set_num_threads(1)

PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]  # 3 blocks at bs=4
POOL_OPTS = dict(watchdog_s=0.5, restart_backoff_s=0.01, poll_s=0.005)
PAGED = dict(slots=2, vocab=32, d=16, heads=2, block_size=4,
             num_blocks=32, max_blocks_per_req=8, prefill_chunk=4, seed=0)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    leaked = faults.active_plan()
    faults.uninstall()
    assert leaked is None, "test leaked an installed FaultPlan"


def _req(prompt=PROMPT, max_tokens=5, deadline_s=60.0, cls=GenerateRequest):
    return cls(prompt_vec=None, max_tokens=max_tokens,
               deadline=time.monotonic() + deadline_s,
               prompt_tokens=list(prompt))


def _replica(name, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("vocab", 32)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 32)
    kw.setdefault("host_tier_bytes", 1 << 20)
    ex = SyntheticKVExecutor(**kw)
    return RouterReplica(name, AdmissionQueue(max_depth=64), ex)


def _run_on(rep, reqs, timeout=30.0):
    b = ContinuousBatcher(rep.executor, rep.queue)
    b.start()
    try:
        for r in reqs:
            assert r.wait(timeout=timeout), "request lost"
    finally:
        b.stop()
    for r in reqs:
        assert r.error is None, r.error
    return [list(r.tokens) for r in reqs]


def _assert_clean(rep):
    ex = rep.executor
    ex.prefix.flush()
    ex.allocator.assert_clean()
    if ex.tier is not None:
        ex.tier.assert_clean()


# -- chain keys and gossip ---------------------------------------------------


def test_chain_keys_match_the_prefix_tree_chain():
    keys = chain_keys(PROMPT, 4)
    assert len(keys) == 2
    parent = _ROOT
    for i, key in enumerate(keys):
        chunk = tuple(PROMPT[i * 4:(i + 1) * 4])
        parent = PrefixTree._key(parent, chunk)
        assert key == parent
    assert chain_keys(PROMPT[:4], 4) == []


@pytest.mark.parametrize("bs", [1, 4, 5])
def test_chain_keys_equal_the_reference(bs):
    for n in (0, 4, 12, 13, 40):
        tokens = [(7 * i + 3) % 32 for i in range(n)]
        assert chain_keys(tokens, bs) == ref_chain_keys(tokens, bs)


def test_gossip_staleness_reads_as_empty():
    board = GossipBoard()
    board.publish("a", {"k1": "hbm"}, now=100.0)
    board.publish("b", {"k2": "host"}, now=104.0)
    view = board.snapshot(max_age_s=5.0, now=106.0)
    assert view["a"] == {}
    assert view["b"] == {"k2": "host"}
    assert board.snapshot()["a"] == {"k1": "hbm"}


def test_replica_gossip_collects_hbm_over_host_and_rate_limits():
    rep = _replica("a")
    try:
        _run_on(rep, [rep.queue.submit(r) or r for r in [_req()]])
        board = GossipBoard()
        g = ReplicaGossip(board, "a", [rep.executor], cadence_s=30.0)
        assert g.maybe_publish()
        keymap = board.snapshot()["a"]
        assert set(keymap.values()) == {"hbm"}
        assert len(keymap) == 3
        assert not g.maybe_publish()
        rep.executor.prefix.evict(99)
        assert g.maybe_publish(force=True)
        assert set(board.snapshot()["a"].values()) == {"host"}
        _assert_clean(rep)
    finally:
        rep.close()
        rep.executor.close()


# -- construction contracts --------------------------------------------------


def test_router_refuses_mixed_block_sizes_and_bad_policy():
    a, b = _replica("a"), _replica("b", block_size=8)
    try:
        with pytest.raises(ValueError, match="block_size"):
            PrefixRouter([a, b])
        with pytest.raises(ValueError, match="policy"):
            PrefixRouter([a], policy="sticky")
        with pytest.raises(ValueError, match="at least one"):
            PrefixRouter([])
    finally:
        for r in (a, b):
            r.close()
            r.executor.close()


# -- scoring and placement ---------------------------------------------------


def test_scores_require_contiguous_chain_from_root():
    a, b = _replica("a"), _replica("b")
    router = PrefixRouter([a, b], cadence_s=0.0)
    try:
        keys = chain_keys(PROMPT, 4)
        router.board.publish("a", {k: "hbm" for k in keys})
        router.board.publish("b", {keys[1]: "hbm"})
        scored = router.scores(PROMPT)
        assert scored == {"a": 8, "b": 0}
    finally:
        router.close()
        for r in (a, b):
            r.executor.close()


def test_affinity_routes_to_the_replica_holding_the_prefix():
    a, b = _replica("a"), _replica("b")
    reg = Registry()
    router = PrefixRouter([a, b], cadence_s=0.0, registry=reg)
    try:
        r1 = _req()
        chosen = router.submit(r1)
        first = _run_on(chosen, [r1])[0]

        r2 = _req()
        chosen2 = router.submit(r2)
        assert chosen2 is chosen
        again = _run_on(chosen2, [r2])[0]
        assert again == first
        assert chosen2.executor.kv_stats()["prefix_hit_tokens_hbm"] == 8
        assert reg.counter_value("serving_router_routed_total",
                                 {"outcome": "affinity"}) == 1
        for rep in (a, b):
            _assert_clean(rep)
    finally:
        router.close()
        for r in (a, b):
            r.executor.close()


def test_round_robin_policy_alternates_and_never_pulls():
    a, b = _replica("a"), _replica("b")
    reg = Registry()
    router = PrefixRouter([a, b], policy="round_robin", registry=reg)
    try:
        picks = [router.route(_req()).name for _ in range(4)]
        assert picks == ["a", "b", "a", "b"]
        assert reg.counter_value("serving_router_routed_total",
                                 {"outcome": "rr"}) == 4
    finally:
        router.close()
        for r in (a, b):
            r.executor.close()


# -- the cross-replica pull --------------------------------------------------


def test_load_skew_pulls_prefix_to_the_cold_replica():
    a, b = _replica("a"), _replica("b")
    reg = Registry()
    router = PrefixRouter([a, b], cadence_s=0.0, max_load_skew=2,
                          registry=reg)
    try:
        r1 = _req()
        assert router.submit(r1) is a
        first = _run_on(a, [r1])[0]

        for _ in range(5):
            a.queue.submit(_req())

        r2 = _req()
        chosen = router.submit(r2)
        assert chosen is b
        assert reg.counter_value("serving_router_routed_total",
                                 {"outcome": "load"}) == 1
        assert reg.counter_value(
            "serving_router_pulled_blocks_total") == 2
        again = _run_on(b, [r2])[0]
        assert again == first
        st = b.executor.kv_stats()
        assert st["prefix_hit_tokens_remote"] == 8
        for rep in (a, b):
            _assert_clean(rep)
    finally:
        router.close()
        for r in (a, b):
            r.executor.close()


def _ref_stream(pool_dtype, prompt):
    ex = RefPaged(**PAGED, mode="pipelined", pool_dtype=pool_dtype,
                  kernel="xla")
    q = RefQueue(max_depth=4)
    b = RefBatcher(ex, q)
    r = _req(prompt, cls=RefRequest)
    q.submit(r)
    b.start()
    try:
        assert r.wait(30), "request lost"
    finally:
        b.stop()
        ex.close()
    assert r.error is None, r.error
    return list(r.tokens)


@pytest.mark.parametrize("pool_dtype", ["int8", "fp32"])
def test_load_skew_pull_over_the_paged_executor(pool_dtype):
    """The pull on the port's paged executors: the prefix's pages leave
    the owner through ``_export_pages`` and land in the cold replica's
    pool through ``_import_pages``, the request there decodes the
    reference's stream of the prompt, and both ledgers stay clean."""
    prompt = PROMPT + [7, 7, 2, 9, 11]

    def mk(name):
        ex = PagedKVExecutor(**PAGED, mode="pipelined",
                             pool_dtype=pool_dtype, device="cpu")
        return RouterReplica(name, AdmissionQueue(max_depth=64), ex)

    a, b = mk("a"), mk("b")
    reg = Registry()
    router = PrefixRouter([a, b], cadence_s=0.0, max_load_skew=2,
                          registry=reg)
    try:
        r1 = _req(prompt)
        assert router.submit(r1) is a
        first = _run_on(a, [r1])[0]
        assert first == _ref_stream(pool_dtype, prompt)
        for _ in range(5):
            a.queue.submit(_req(prompt))
        r2 = _req(prompt)
        assert router.submit(r2) is b
        pulled = reg.counter_value("serving_router_pulled_blocks_total")
        assert pulled == len(chain_keys(prompt, 4)) == 4
        assert _run_on(b, [r2])[0] == first
        assert b.executor.kv_stats()["prefix_hit_tokens_remote"] == 16
        for rep in (a, b):
            _assert_clean(rep)
    finally:
        router.close()
        for r in (a, b):
            r.executor.close()


def test_pull_refused_on_kv_spec_mismatch_falls_back_to_prefill():
    a = _replica("a")
    b = _replica("b", max_blocks_per_req=8)
    reg = Registry()
    router = PrefixRouter([a, b], cadence_s=0.0, max_load_skew=2,
                          registry=reg)
    try:
        r1 = _req()
        assert router.submit(r1) is a
        first = _run_on(a, [r1])[0]
        for _ in range(5):
            a.queue.submit(_req())

        r2 = _req()
        chosen = router.submit(r2)
        assert chosen is b
        assert reg.counter_value(
            "serving_router_pull_failed_total") == 1
        again = _run_on(b, [r2])[0]
        assert again == first
        assert b.executor.kv_stats()["prefix_hit_tokens_remote"] == 0
        for rep in (a, b):
            _assert_clean(rep)
    finally:
        router.close()
        for r in (a, b):
            r.executor.close()


def test_pull_import_rejects_lying_chain_keys():
    a = _replica("a")
    try:
        keys = chain_keys(PROMPT, 4)
        meta = {"prefix_pull": True, "req": "x", "xfer": "x",
                "tokens": 8, "n_blocks": 2,
                "prompt_tokens": PROMPT[:8], "settled": [],
                "max_tokens": 0, "keys": [keys[0], "forged"]}
        with pytest.raises(ValueError, match="re-verification"):
            a._pull_import(meta, [])
        meta["keys"] = keys
        meta["n_blocks"] = 3
        with pytest.raises(ValueError, match="geometry"):
            a._pull_import(meta, [])
        assert not a._pull_import.__self__.executor.allocator.leaked(
            ignore=(CACHE_OWNER,))
        _assert_clean(a)
    finally:
        a.close()
        a.executor.close()


# -- chaos: the pull cut mid-stream -------------------------------------------


def _drive_kv(ex, queue, req, timeout=20.0):
    b = ContinuousBatcher(ex, queue)
    b.start()
    try:
        assert req.wait(timeout=timeout), "request lost"
    finally:
        b.stop()
    assert req.error is None, req.error
    return list(req.tokens)


def test_router_pull_cut_midstream_falls_back_to_local_prefill(tmp_path):
    """The prefix pull is cut mid-stream: the request completes on the
    chosen replica by local prefill with the unrouted run's stream, both
    replicas' allocator and tier ledgers stay clean, and one timeline
    carries router decision -> failed pull -> the replica's queue leg."""
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]

    def mk(name):
        ex = SyntheticKVExecutor(slots=2, vocab=32, block_size=4,
                                 num_blocks=32,
                                 host_tier_bytes=1 << 20)
        return RouterReplica(name, AdmissionQueue(max_depth=64), ex)

    reg = Registry()
    with obs_trace.scoped() as tr:
        a, b = mk("a"), mk("b")
        recorder = FlightRecorder(tracer=tr, flight_dir=str(tmp_path))
        router = PrefixRouter([a, b], cadence_s=0.0, max_load_skew=2,
                              registry=reg, tracer=tr)
        try:
            r1 = GenerateRequest(prompt_vec=None, max_tokens=5,
                                 deadline=time.monotonic() + 60.0,
                                 prompt_tokens=list(prompt))
            assert router.submit(r1) is a
            baseline = _drive_kv(a.executor, a.queue, r1)
            for _ in range(5):
                a.queue.submit(_req(prompt))

            with faults.injected() as plan:
                plan.inject("kvstream.send",
                            exc=OSError("mid-stream cut"),
                            at_calls=[1])
                r2 = _req(prompt)
                chosen = router.submit(r2)
            assert chosen is b
            assert reg.counter_value(
                "serving_router_pull_failed_total") == 1
            assert _drive_kv(b.executor, b.queue, r2) == baseline
            st = b.executor.kv_stats()
            assert st["prefix_hit_tokens_remote"] == 0

            for rep in (a, b):
                rep.executor.prefix.flush()
                rep.executor.allocator.assert_clean()
                rep.executor.tier.assert_clean()
            recorder.snapshot("router-pull-cut",
                              extra={"request_id": r2.request_id})
        finally:
            router.close()
            a.executor.close()
            b.executor.close()
        spans = tr.spans_snapshot()

    mine = [s for s in spans if s.request_id == r2.request_id]
    route = [s for s in mine if s.name == "router.route"]
    pull = [s for s in mine if s.name == "router.pull"]
    queued = [s for s in mine if s.name.startswith("queue.")]
    assert route and route[0].attrs["outcome"] == "load"
    assert pull and pull[0].attrs["outcome"] == "failed"
    assert "mid-stream cut" in pull[0].attrs.get("error", "")
    assert queued, "the replica's queue leg is missing"
    assert pull[0].t0 <= route[0].t0 <= min(s.t0 for s in queued)
    files = sorted(tmp_path.glob("flight-router-pull-cut-*.json"))
    assert files, sorted(p.name for p in tmp_path.iterdir())


# -- autoscaler: deterministic tick() decisions -------------------------------


class _StubRole:
    def __init__(self, name_prefix, n_live=2):
        self.name_prefix = name_prefix
        self._names = [f"{name_prefix}{i}" for i in range(n_live)]
        self._parked = []

    def live_count(self):
        return len(self._names) - len(self._parked)

    def park_replica(self, min_live=0):
        live = [n for n in self._names if n not in self._parked]
        if len(live) - 1 < min_live:
            return None
        name = live[-1]
        self._parked.append(name)
        return name

    def unpark_replica(self, i):
        name = self._names[i]
        if name not in self._parked:
            return None
        self._parked.remove(name)
        return name


class _StubDepth:
    def __init__(self):
        self.n = 0

    def depth(self):
        return self.n


class _StubDisagg:
    def __init__(self):
        self.queue = _StubDepth()
        self.decode_queue = _StubDepth()
        self.backlog = 0
        self.prefill_pool = _StubRole("prefill", n_live=2)
        self.decode_pool = _StubRole("decode", n_live=2)
        self.flips = []
        self.flip_ok = True
        self._active = 0

    def transfer_backlog(self):
        return self.backlog

    def active(self):
        return self._active

    def flip_role(self, from_role):
        self.flips.append(from_role)
        return f"moved-{from_role}" if self.flip_ok else None


def test_autoscaler_flip_needs_hysteresis_then_cooldown():
    pool = _StubDisagg()
    asc = RoleAutoscaler(pool, flip_margin=4, hysteresis=3,
                         cooldown_s=10.0)
    pool.queue.n = 9
    assert asc.tick(now=0.0) is None
    assert asc.tick(now=0.1) is None
    assert asc.tick(now=0.2) == "flip_to_prefill"
    assert pool.flips == ["decode"]
    assert asc.tick(now=0.3) is None
    assert asc.tick(now=0.4) is None
    assert asc.tick(now=0.5) is None
    assert pool.flips == ["decode"]
    assert asc.tick(now=11.0) == "flip_to_prefill"
    assert asc.flips == 2


def test_autoscaler_streak_resets_on_balanced_tick():
    pool = _StubDisagg()
    asc = RoleAutoscaler(pool, flip_margin=4, hysteresis=3,
                         cooldown_s=0.0)
    pool.queue.n = 9
    asc.tick(now=0.0)
    asc.tick(now=0.1)
    pool.queue.n = 0
    asc.tick(now=0.2)
    pool.queue.n = 9
    asc.tick(now=0.3)
    asc.tick(now=0.4)
    assert pool.flips == []
    assert asc.tick(now=0.5) == "flip_to_prefill"


def test_autoscaler_decode_pressure_counts_transfer_backlog():
    pool = _StubDisagg()
    asc = RoleAutoscaler(pool, flip_margin=4, hysteresis=1,
                         cooldown_s=0.0)
    pool.decode_queue.n = 2
    pool.backlog = 3
    assert asc.tick(now=0.0) == "flip_to_decode"
    assert pool.flips == ["prefill"]


def test_autoscaler_host_gap_dampens_decode_flip():
    reg = Registry()
    pool = _StubDisagg()
    asc = RoleAutoscaler(pool, registry=reg, flip_margin=4,
                         hysteresis=1, cooldown_s=0.0,
                         host_gap_ceiling=0.9)
    reg.observe("serving_host_gap_seconds", 0.95,
                {"replica": "decode0"})
    reg.observe("serving_step_device_seconds", 0.05,
                {"replica": "decode0"})
    pool.decode_queue.n = 9
    assert asc.tick(now=0.0) is None
    assert pool.flips == [] and asc.dampened == 1
    assert reg.counter_value("serving_autoscale_dampened_total",
                             {"reason": "host_gap"}) == 1
    reg.observe("serving_step_device_seconds", 10.0,
                {"replica": "decode0"})
    assert asc.tick(now=1.0) == "flip_to_decode"
    assert pool.flips == ["prefill"]


def test_autoscaler_parks_on_idle_and_unparks_on_pressure():
    pool = _StubDisagg()
    asc = RoleAutoscaler(pool, flip_margin=4, hysteresis=3,
                         cooldown_s=0.0, idle_park_s=1.0, min_live=1)
    assert asc.tick(now=0.0) is None
    assert asc.tick(now=0.5) is None
    assert asc.tick(now=1.5) == "park"
    assert asc.tick(now=3.0) == "park"
    assert asc.tick(now=5.0) is None
    assert asc.parks == 2
    assert pool.prefill_pool._parked == ["prefill1"]
    assert pool.decode_pool._parked == ["decode1"]
    pool.queue.n = 1
    assert asc.tick(now=6.0) == "unpark"
    assert pool.decode_pool._parked == []
    assert asc.tick(now=6.1) == "unpark"
    assert pool.prefill_pool._parked == []
    assert asc.unparks == 2


def test_autoscaler_never_unparks_breaker_parked_replicas():
    pool = _StubDisagg()
    asc = RoleAutoscaler(pool, idle_park_s=0.1)
    pool.prefill_pool._parked.append("prefill1")
    pool.queue.n = 5
    for i in range(5):
        asc.tick(now=float(i))
    assert pool.prefill_pool._parked == ["prefill1"]
    assert asc.unparks == 0


def test_autoscaler_tick_survives_flip_refusal():
    pool = _StubDisagg()
    pool.flip_ok = False
    asc = RoleAutoscaler(pool, flip_margin=4, hysteresis=1,
                         cooldown_s=0.0)
    pool.queue.n = 9
    assert asc.tick(now=0.0) is None
    assert asc.flips == 0


def test_flip_role_refuses_below_min_live():
    kw = dict(slots=2, block_size=4, num_blocks=64,
              max_blocks_per_req=16, prefill_chunk=8, pipelined=True)
    pre, dec = SyntheticKVExecutor(**kw), SyntheticKVExecutor(**kw)
    q = AdmissionQueue(max_depth=4)
    pool = DisaggPool([pre], [dec], q, pool_opts=dict(POOL_OPTS))
    pool.start()
    try:
        assert pool.flip_role("prefill") is None
        assert pool.flip_role("decode") is None
        assert pool.prefill_pool.live_count() == 1
        assert pool.decode_pool.live_count() == 1
    finally:
        pool.stop()
    pre.close()
    dec.close()
