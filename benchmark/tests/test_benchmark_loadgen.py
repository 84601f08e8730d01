"""The load generator against a ``ServingServer`` over the synthetic KV
executor, at tiny sizes."""

import math

import pytest

from harness.core import LoadGen
from harness.traffic import Traffic, pool_sizes
from harness.window import Window, nearest_rank

MIX = {"loop": "closed", "clients": 6,
       "prompt_len": {"dist": "uniform", "lo": 3, "hi": 12},
       "max_tokens": {"dist": "uniform", "lo": 2, "hi": 8},
       "pool": 64, "deadline_ms": 60000}
SERVING = {"prompt": "tokens", "vocab": 64}


def serve(max_tokens_cap=1024):
    from dpu_operator_tpu_torch.serving.kvcache.executor import \
        SyntheticKVExecutor
    from dpu_operator_tpu_torch.serving.server import ServingServer
    ex = SyntheticKVExecutor(slots=4, vocab=64, block_size=4,
                             num_blocks=256, max_blocks_per_req=8,
                             prefill_chunk=4, step_time_s=0.002)
    srv = ServingServer([ex], max_tokens_cap=max_tokens_cap)
    seen = []
    accept = srv._httpd.process_request

    def counted(request, client_address):
        seen.append(client_address)
        return accept(request, client_address)

    srv._httpd.process_request = counted
    return srv.start(), seen


def drive(srv, mix, seconds=1.0, seed=3):
    gen = LoadGen({"host": "127.0.0.1", "port": srv.port, "mix": mix,
                   "serving": SERVING, "seed": seed, "seconds": seconds})
    try:
        t_open = gen.wait("open", 60)["t"]
        t_close = gen.wait("close", 60)["t"]
        recs = gen.wait("results", 60)["requests"]
    finally:
        gen.stop()
    return Window(t_open=t_open, t_close=t_close, setup_s=0.0,
                  records=recs, counters={}, traffic=None, system=None)


def test_keep_alive_connections_one_a_client():
    srv, seen = serve()
    try:
        w = drive(srv, MIX)
    finally:
        srv.stop()
    assert len(w.records) > 2 * MIX["clients"]
    assert len(set(seen)) == MIX["clients"]      # opened once, reused
    assert not w.failed and w.answered
    for r in w.answered:
        assert len(r["tokens"]) >= 1
        assert r["t_due"] <= r["t_send"] <= r["t_done"]
    assert abs(w.seconds - 1.0) < 0.2
    # Request i is Traffic.body(i): indices are dense from 0.
    idx = sorted(r["i"] for r in w.records)
    assert idx == list(range(len(idx)))


def test_failures_count_against_attempts_as_infinitely_late():
    srv, _ = serve(max_tokens_cap=5)    # max_tokens 6-8 answer 400
    try:
        w = drive(srv, MIX)
    finally:
        srv.stop()
    assert w.failed and w.answered
    lat = w.latencies_ms()
    assert len(lat) == len(w.finished)
    assert sum(math.isinf(x) for x in lat) == len(w.failed)


def test_nearest_rank_reaches_the_worst():
    vals = sorted(float(i) for i in range(1, 51))
    assert nearest_rank(vals, 0.95) == 48.0
    assert nearest_rank(vals, 0.999) == 50.0
    assert nearest_rank([7.0], 0.95) == 7.0


def test_every_seed_gets_the_same_sizes_in_another_order():
    a, b = Traffic(MIX, SERVING, 1), Traffic(MIX, SERVING, 2 ** 40 + 1)
    sa = sorted((a.request(i).prompt_len, a.request(i).max_tokens)
                for i in range(64))
    sb = sorted((b.request(i).prompt_len, b.request(i).max_tokens)
                for i in range(64))
    assert sa == sb == pool_sizes(MIX, SERVING)
    assert [a.request(i).prompt_len for i in range(64)] != \
        [b.request(i).prompt_len for i in range(64)]
    assert a.prompt(5) == Traffic(MIX, SERVING, 1).prompt(5)
    assert a.prompt(5) != b.prompt(5)


def test_shared_prefixes_are_spread_evenly():
    mix = dict(MIX, shared_prefix={"count": 4, "len": 8})
    t = Traffic(mix, SERVING, 9)
    ids = [t.request(i).prefix for i in range(64)]
    assert sorted(set(ids)) == [0, 1, 2, 3]
    assert all(ids.count(k) == 16 for k in range(4))
    p = [t.prompt(i) for i in range(64)]
    same = [x for i, x in enumerate(p) if ids[i] == ids[0]]
    assert all(x[:8] == same[0][:8] for x in same)
    assert len({tuple(x) for x in p}) == 64


def test_each_request_keeps_its_due_time():
    srv, _ = serve()
    try:
        w = drive(srv, MIX)
    finally:
        srv.stop()
    assert w.answered
    assert all(r["t_due"] <= r["t_send"] + 1e-6 for r in w.records)


def test_a_loop_other_than_closed_is_refused():
    from harness.loadgen import Run
    with pytest.raises(ValueError, match="only 'closed'"):
        Run({"host": "127.0.0.1", "port": 1, "mix": dict(MIX, loop="open"),
             "serving": SERVING, "seed": 1, "seconds": 1})
