"""The port's row-plane serving path against the JAX package's.

``serving/infer.py`` (``serving_mesh``, ``make_infer_step``,
``DecodeStep``) and ``LocalExecutor`` through ``ContinuousBatcher`` and
``ServingServer``, on the CPU with the plain all-to-all, against the
reference's on the 8-device virtual CPU mesh, on the same weights
(numpy, in the reference's ``init_params`` layout, carried across by
``train_step.params_from_numpy``).

Bars:
  * tokens and token streams: exact;
  * a step's ``[slots, d]`` output: ``rtol=1e-5, atol=1e-6`` (the same f32
    products in two libraries), the bar of the reference's idle-slot test
    (``tests/test_serving.py``);
  * idle rows: exactly zero.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from dpu_operator_tpu.parallel import train_step as ref_ts
from dpu_operator_tpu.serving import LocalExecutor as RefLocal
from dpu_operator_tpu.serving import infer as ref_infer
from dpu_operator_tpu_torch.parallel import train_step as ts
from dpu_operator_tpu_torch.serving import (AdmissionQueue,
                                            ContinuousBatcher,
                                            GenerateRequest, LocalExecutor,
                                            ServingServer, encode_prompt)
from dpu_operator_tpu_torch.serving import infer

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
CPU = dict(device="cpu")
D, H = 8, 16


def _params(S, E, seed, d=D, h=H):
    """Weights in the reference's ``init_params`` layout and scales."""
    rng = np.random.RandomState(seed)
    shapes = {"w1": ((S, d, h), d), "w2": ((S, h, d), h),
              "router": ((S, d, E), d), "moe_w1": ((S, E, d, h), d),
              "moe_w2": ((S, E, h, d), h)}
    return {k: (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
            for k, (shape, fan_in) in shapes.items()}


def _updates(rng, slots, d, n):
    idx = rng.choice(slots, n, replace=False)
    return [(int(i), rng.randn(d).astype(np.float32)) for i in idx]


# -- DecodeStep -----------------------------------------------------------------


@pytest.mark.parametrize("ep,cf", [(2, 1.0), (4, 4.0)])
def test_decode_step_matches_reference(ep, cf):
    """A fixed sequence of slot updates (none, one, several, a full
    reload, zeroed rows) through both packages' DecodeStep: y within the
    bar at every step, tokens exact."""
    slots = 8
    params = _params(2, ep, seed=ep)
    ref = ref_infer.DecodeStep(ref_infer.serving_mesh(shape={"ep": ep}),
                               ref_ts.shard_params(
                                   params,
                                   ref_infer.serving_mesh(shape={"ep": ep})),
                               slots, capacity_factor=cf)
    port = infer.DecodeStep(infer.serving_mesh(shape={"ep": ep}),
                            ts.params_from_numpy(params, "cpu"), slots, cf,
                            **CPU)
    assert port.kernel == "torch" and port._calls == 0
    rng = np.random.RandomState(7)
    plan = [3, 0, 1, 0, slots, 2, 0]
    rx, px = ref.init_state(), port.init_state()
    for n in plan:
        ups = _updates(rng, slots, D, n)
        if n == 2:
            ups[1] = (ups[1][0], np.zeros(D, np.float32))  # a freed slot
        rx, rtok = ref(rx, ups)
        px, ptok = port(px, ups)
        np.testing.assert_allclose(px.numpy(), np.asarray(rx), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(ptok.numpy(), np.asarray(rtok))
        assert ptok.dtype == torch.int32
    assert port._calls == len(plan)


@pytest.mark.parametrize("via", ["direct", "executor"])
def test_decode_step_overflow_error_names_step_and_requests(via):
    """tests/test_kvcache.py's overflow check on the port: the >slots
    update rejection names the step and the admitting request ids, with
    the reference's text."""
    rows = [(i, np.zeros(8, np.float32)) for i in range(3)]
    msgs = []
    for ex in (RefLocal(slots=2, S=1, d=8, h=8, E=1, warmup=False),
               LocalExecutor(slots=2, S=1, d=8, h=8, E=1, warmup=False,
                             **CPU)):
        with pytest.raises(ValueError) as ei:
            if via == "direct":
                ex._decode(ex._decode.init_state(), rows, step=7,
                           request_ids=["req-a", "req-b", "req-c"])
            else:
                ex.submit(rows, step=7,
                          request_ids=["req-a", "req-b", "req-c"])
        msgs.append(str(ei.value))
    assert "step 7" in msgs[1] and "req-a" in msgs[1] and "req-c" in msgs[1]
    assert msgs[0] == msgs[1]


def test_serving_mesh_errors():
    assert infer.serving_mesh() == {"dp": 1, "pp": 1, "sp": 1, "tp": 1,
                                    "ep": 1}
    assert infer.serving_mesh(shape={"ep": 4})["ep"] == 4
    for bad in ({"pp": 2}, {"sp": 2}):
        with pytest.raises(ValueError) as want:
            ref_infer.serving_mesh(shape=bad)
        with pytest.raises(ValueError) as got:
            infer.serving_mesh(shape=bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        ref_infer.serving_mesh(devices=[None] * 3, shape={"ep": 2})
    with pytest.raises(ValueError) as got:
        infer.serving_mesh(devices=[None] * 3, shape={"ep": 2})
    assert str(got.value) == str(want.value)
    assert infer.serving_mesh(devices=["cpu"] * 2, shape={"ep": 2})["ep"] == 2
    assert infer.serving_mesh(shape={"dp": 2, "tp": 2, "ep": 2}) == {
        "dp": 2, "pp": 1, "sp": 1, "tp": 2, "ep": 2}
    with pytest.raises(ValueError) as want:
        ref_infer.serving_mesh(devices=[None] * 4,
                               shape={"dp": 2, "tp": 2, "ep": 2})
    with pytest.raises(ValueError) as got:
        infer.serving_mesh(devices=[None] * 4,
                           shape={"dp": 2, "tp": 2, "ep": 2})
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="infer_step requires pp=1"):
        infer.make_infer_step(dict(infer.serving_mesh(), pp=2), **CPU)
    with pytest.raises(ValueError, match="CUDA"):
        infer.make_infer_step(infer.serving_mesh(), kernel="cuda", **CPU)


# -- dp and tp > 1 --------------------------------------------------------------


def _batch(rng, B, d, idle):
    """B rows ~ N(0, 1) with the rows of ``idle`` exactly zero."""
    x = rng.randn(B, d).astype(np.float32)
    x[list(idle)] = 0.0
    return x


@pytest.mark.parametrize("dp,tp,ep", [(2, 1, 2), (1, 2, 2), (2, 2, 2)])
def test_dp_tp_rows_match_reference(dp, tp, ep):
    """The row plane at dp, tp > 1 on the reference's 8-device mesh and on
    the port's stacked ranks, on the same weights: ``make_infer_step``
    within the file's bar at capacity factor 1 (rows dropped, so routing
    depends on which rank holds a row: a batch laid out in another order
    than the reference's dp-major ``P(("dp", "ep"), None)`` would route
    differently) and 4, idle rows exactly zero; ``DecodeStep`` tokens
    exactly over a plan of updates; ``LocalExecutor`` streams exactly, more
    requests than slots."""
    from dpu_operator_tpu.serving import (AdmissionQueue as RefQueue,
                                          ContinuousBatcher as RefBatcher,
                                          GenerateRequest as RefRequest,
                                          encode_prompt as ref_encode)

    shape = {"dp": dp, "tp": tp, "ep": ep}
    params = _params(2, ep, seed=40 + 4 * dp + tp)
    mesh, rmesh = infer.serving_mesh(shape=shape), ref_infer.serving_mesh(
        shape=shape)
    assert mesh == dict(rmesh.shape)
    p = ts.shard_params(params, mesh, "cpu")
    rp_ = ref_ts.shard_params(params, rmesh)
    rng = np.random.RandomState(dp * 10 + tp)
    B = 4 * dp * ep
    for cf in (1.0, 4.0):
        step = infer.make_infer_step(mesh, capacity_factor=cf, **CPU)
        rstep = ref_infer.make_infer_step(rmesh, capacity_factor=cf)
        x = _batch(rng, B, D, idle=(1, B - 2))
        y = step(p, x).numpy()
        np.testing.assert_allclose(y, np.asarray(rstep(rp_, x)), rtol=RTOL,
                                   atol=ATOL)
        assert not y[1].any() and not y[B - 2].any()

    slots = 2 * dp * ep
    ref = ref_infer.DecodeStep(rmesh, rp_, slots, capacity_factor=1.0)
    port = infer.DecodeStep(mesh, ts.params_from_numpy(params, "cpu"),
                            slots, 1.0, **CPU)
    rx, px = ref.init_state(), port.init_state()
    for n in (3, 0, slots, 2, 0):
        ups = _updates(rng, slots, D, n)
        rx, rtok = ref(rx, ups)
        px, ptok = port(px, ups)
        np.testing.assert_allclose(px.numpy(), np.asarray(rx), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(ptok.numpy(), np.asarray(rtok))

    kw = dict(params=params, slots=slots, capacity_factor=4.0)
    ref_reqs = [RefRequest(prompt_vec=ref_encode(f"trace-{i}", D),
                           max_tokens=5, deadline=time.monotonic() + 600.0)
                for i in range(slots + 2)]
    want = _drive(RefLocal(mesh=rmesh, **kw), ref_reqs, RefQueue, RefBatcher)
    got = _drive(LocalExecutor(mesh=mesh, **kw, **CPU),
                 _trace(slots + 2, D, 5), AdmissionQueue, ContinuousBatcher)
    assert all(e is None for e, _ in got)
    assert got == want


def test_dp_tp_shape_errors():
    """Batches and slots that do not divide by dp·ep raise with the
    reference's LocalExecutor text, DecodeStep's before it places the
    weights; a dense pair whose width does not cut
    into tp shards raises."""
    mesh = infer.serving_mesh(shape={"dp": 2, "ep": 2})
    p = ts.shard_params(_params(1, 2, seed=6), mesh, "cpu")
    step = infer.make_infer_step(mesh, **CPU)
    with pytest.raises(ValueError, match=r"batch=6 must divide over "
                       r"dp\*ep=4 \(batch rows shard over both\)"):
        step(p, np.ones((6, D), np.float32))
    with pytest.raises(ValueError) as want:
        RefLocal(slots=6, E=2, mesh=ref_infer.serving_mesh(
            shape={"dp": 2, "ep": 2}), warmup=False)
    for make in (lambda: infer.DecodeStep(mesh, p, 6, **CPU),
                 # rejected before the weights are placed: None never is
                 lambda: infer.DecodeStep(mesh, None, 6, **CPU),
                 lambda: LocalExecutor(slots=6, E=2, mesh=mesh, **CPU)):
        with pytest.raises(ValueError) as got:
            make()
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="does not shard over tp=3"):
        ts.shard_params(_params(1, 2, seed=6),
                        infer.serving_mesh(shape={"tp": 3, "ep": 2}), "cpu")


# -- the idle-slot contract -----------------------------------------------------


def test_idle_slots_do_not_steal_moe_capacity_on_ep_mesh():
    """tests/test_serving.py's idle-slot test on the port, and port against
    reference: under capacity pressure (C = 1) the same prompt row decodes
    identically alone in the first slot and alone in the last (rank 0 and
    rank 1), and idle rows stay exactly zero."""
    params = _params(1, 2, seed=2, d=8, h=8)
    mesh = infer.serving_mesh(shape={"ep": 2})
    step = infer.make_infer_step(mesh, capacity_factor=1.0, **CPU)
    p = ts.shard_params(params, mesh, "cpu")
    rmesh = ref_infer.serving_mesh(shape={"ep": 2})
    rstep = ref_infer.make_infer_step(rmesh, capacity_factor=1.0)
    rp_ = ref_ts.shard_params(params, rmesh)
    rng = np.random.RandomState(9)
    for _ in range(8):  # vectors routing to both experts get exercised
        r = rng.randn(8).astype(np.float32)
        first = np.zeros((4, 8), np.float32)
        first[0] = r
        last = np.zeros((4, 8), np.float32)
        last[3] = r
        y_first = step(p, first).numpy()
        y_last = step(p, last).numpy()
        np.testing.assert_allclose(y_first[0], y_last[3], rtol=1e-5,
                                   atol=1e-6)
        assert not y_first[1:].any() and not y_last[:3].any()
        for x, y in ((first, y_first), (last, y_last)):
            np.testing.assert_allclose(y, np.asarray(rstep(rp_, x)),
                                       rtol=RTOL, atol=ATOL)


# -- LocalExecutor --------------------------------------------------------------


def _trace(n, d, toks):
    return [GenerateRequest(prompt_vec=encode_prompt(f"trace-{i}", d),
                            max_tokens=toks,
                            deadline=time.monotonic() + 600.0)
            for i in range(n)]


def _drive(ex, reqs, queue_cls, batcher_cls):
    """A preloaded trace through a ContinuousBatcher (no HTTP)."""
    q = queue_cls(max_depth=len(reqs) + 1)
    b = batcher_cls(ex, q)
    for r in reqs:
        q.submit(r)
    b.start()
    try:
        for r in reqs:
            assert r.wait(timeout=60), "request lost"
    finally:
        b.stop()
        ex.close()
    return [(r.error, list(r.tokens)) for r in reqs]


@pytest.mark.parametrize("ep", [1, 2])
@pytest.mark.parametrize("mode", ["sync", "pipelined"])
def test_local_executor_streams_match_reference(ep, mode):
    """The same trace through the reference's LocalExecutor and the
    port's, on the same weights: token streams byte for byte. More
    requests than slots, so hand-offs are exercised."""
    from dpu_operator_tpu.serving import (AdmissionQueue as RefQueue,
                                          ContinuousBatcher as RefBatcher,
                                          GenerateRequest as RefRequest,
                                          encode_prompt as ref_encode)

    params = _params(2, ep, seed=30 + ep)
    kw = dict(params=params, slots=4, mode=mode, capacity_factor=4.0)
    ref_reqs = [RefRequest(prompt_vec=ref_encode(f"trace-{i}", D),
                           max_tokens=6, deadline=time.monotonic() + 600.0)
                for i in range(6)]
    want = _drive(RefLocal(mesh=ref_infer.serving_mesh(shape={"ep": ep}),
                           **kw), ref_reqs, RefQueue, RefBatcher)
    ex = LocalExecutor(mesh=infer.serving_mesh(shape={"ep": ep}), **kw,
                       **CPU)
    assert ex.pipelined == (mode == "pipelined") and ex.kernel == "torch"
    got = _drive(ex, _trace(6, D, 6), AdmissionQueue, ContinuousBatcher)
    assert all(e is None for e, _ in got)
    assert got == want


def test_pipelined_sync_token_equivalence_local():
    """tests/test_serving.py's sync == pipelined check on the port's
    LocalExecutor (demo weights drawn by the port)."""
    model = dict(S=1, d=8, h=8, E=1)
    streams = {}
    for mode in ("sync", "pipelined"):
        ex = LocalExecutor(slots=4, mode=mode, **model, **CPU)
        streams[mode] = _drive(ex, _trace(8, model["d"], 5),
                               AdmissionQueue, ContinuousBatcher)
    assert all(e is None for e, _ in streams["pipelined"])
    assert streams["sync"] == streams["pipelined"]


def test_local_executor_over_http():
    """One round trip through ServingServer -> LocalExecutor."""
    ex = LocalExecutor(params=_params(1, 2, seed=4),
                       mesh=infer.serving_mesh(shape={"ep": 2}), slots=4,
                       **CPU)
    srv = ServingServer([ex]).start()
    try:
        req = urllib.request.Request(
            srv.url + "/v1/generate",
            data=json.dumps({"prompt": "hello", "max_tokens": 4}).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            code, body = r.status, json.loads(r.read())
    finally:
        srv.stop()
    assert code == 200 and len(body["tokens"]) == 4
    assert all(0 <= t < D for t in body["tokens"])


def _paged_executor():
    from dpu_operator_tpu_torch.serving import PagedKVExecutor

    return PagedKVExecutor(slots=2, vocab=16, d=8, heads=2, block_size=4,
                           num_blocks=32, max_blocks_per_req=4,
                           prefill_chunk=4, **CPU)


def _serve_once_and_drop(make, body):
    """Serve one request through a fresh server on ``make()``'s executor,
    stop the server and drop both; returns weak references to them and
    what the stopped server still reports."""
    import weakref

    ex = make()
    srv = ServingServer([ex]).start()
    try:
        req = urllib.request.Request(srv.url + "/v1/generate",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
    finally:
        srv.stop()
    after = (srv.port, srv.url, srv.draining)
    return weakref.ref(ex), weakref.ref(srv), after


@pytest.mark.parametrize("plane", ["paged", "rows"])
def test_stopped_server_frees_its_executor_without_the_cycle_collector(
        plane):
    """A stopped and dropped ServingServer and its executor are freed by
    reference counting alone: nothing of the server refers back to it
    through its HTTP handler (on a card, an executor kept until the cycle
    collector runs keeps its device memory)."""
    import gc

    if plane == "paged":
        make, body = _paged_executor, {"prompt_tokens": [1, 2, 3],
                                       "max_tokens": 2}
    else:
        def make():
            return LocalExecutor(params=_params(1, 2, seed=4),
                                 mesh=infer.serving_mesh(shape={"ep": 2}),
                                 slots=4, **CPU)
        body = {"prompt": "hello", "max_tokens": 2}
    gc.collect()
    gc.disable()
    try:
        ex_ref, srv_ref, (port, url, draining) = _serve_once_and_drop(
            make, body)
        assert srv_ref() is None, "the stopped server is still alive"
        assert ex_ref() is None, "its executor is still alive"
    finally:
        gc.enable()
    assert port > 0 and url.endswith(f":{port}") and draining


def test_local_executor_step_adapter_and_readback():
    """The pipelined executor's step() adapter equals the sync one's, and
    a step's token handle stays its own however many later steps are
    submitted before it is collected."""
    params = _params(1, 2, seed=5)
    mesh = infer.serving_mesh(shape={"ep": 2})
    pipe = LocalExecutor(params=params, mesh=mesh, slots=4, **CPU)
    sync = LocalExecutor(params=params, mesh=mesh, slots=4, mode="sync",
                         **CPU)
    x = np.random.RandomState(1).randn(4, D).astype(np.float32)
    np.testing.assert_array_equal(pipe.step(x), sync.step(x))
    ups = [[(i, x[i])] for i in range(4)] + [[]] * 4
    pipe.reset()
    handles = [pipe.submit(u) for u in ups]
    late = [pipe.collect(hd) for hd in reversed(handles)][::-1]
    pipe.reset()
    prompt = [pipe.collect(pipe.submit(u)) for u in ups]
    for got, want in zip(late, prompt):
        assert got.shape == (4,) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_local_executor_device_handling():
    kw = dict(slots=2, S=1, d=8, h=8, E=1, warmup=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalExecutor(**kw)
    with pytest.raises(ValueError, match="CUDA"):
        LocalExecutor(**kw, kernel="cuda", device="cpu")
    for mode in ("pipelined", "sync"):
        assert LocalExecutor(**kw, mode=mode, **CPU).kernel == "torch"
    with pytest.raises(ValueError, match="demo params need E == ep"):
        LocalExecutor(**dict(kw, E=2), **CPU)
    with pytest.raises(ValueError, match="must divide over dp\\*ep=2"):
        LocalExecutor(slots=3, E=2, mesh=infer.serving_mesh(
            shape={"ep": 2}), **CPU)
