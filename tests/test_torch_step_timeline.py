"""The served step's timeline in the port, on the CPU.

The batcher's per-request step sums (``timings.steps``, ``submit_ms``,
``device_ms``, ``gap_ms``, ``starved_steps``, ``gc_ms``) against the
spans it records and against the synthetic executors' own step
intervals; the spans of one step and their parts; the GC pause hook;
the tracer's bounded buffer keeping its newest spans; and the CUDA step
clock's anchor on stand-in events.
"""

import gc
import json
import math
import time
import urllib.request

import numpy as np
import pytest

from dpu_operator_tpu_torch.obs.trace import Tracer, gc_pauses
from dpu_operator_tpu_torch.serving import (AdmissionQueue,
                                            ContinuousBatcher,
                                            GenerateRequest, ServingServer)
from dpu_operator_tpu_torch.serving import scheduler, stepclock
from dpu_operator_tpu_torch.serving.executor import SyntheticExecutor
from dpu_operator_tpu_torch.serving.kvcache.executor import \
    SyntheticKVExecutor

SHAPES = [("row", False), ("row", True), ("kv", False), ("kv", True)]
STEP_S = 0.002


class _RowTimed(SyntheticExecutor):
    """Records each step's own interval where the step runs."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.intervals = []

    def step(self, x):
        t0 = time.monotonic()
        y = super().step(x)
        self.intervals.append((t0, time.monotonic()))
        return y


class _KVTimed(SyntheticKVExecutor):
    def __init__(self, **kw):
        self.intervals = []
        super().__init__(**kw)

    def _device_step(self, plan):
        t0 = time.monotonic()
        out = super()._device_step(plan)
        self.intervals.append((t0, time.monotonic()))
        return out


def _executor(plane, pipelined, cls=None, **kw):
    if plane == "row":
        return (cls or _RowTimed)(slots=2, d=8, step_time_s=STEP_S,
                                  pipelined=pipelined, **kw)
    return (cls or _KVTimed)(slots=2, step_time_s=STEP_S,
                             pipelined=pipelined, **kw)


def _request(plane, k, max_tokens):
    if plane == "row":
        return GenerateRequest(
            prompt_vec=np.random.RandomState(k).randn(8).astype(np.float32),
            max_tokens=max_tokens, deadline=time.monotonic() + 60)
    return GenerateRequest(prompt_vec=None, max_tokens=max_tokens,
                           deadline=time.monotonic() + 60,
                           prompt_tokens=[1 + k, 2, 3, 4, 5])


def _serve(ex, plans, tracer):
    """Run ``plans`` [(plane, max_tokens, delay_s)] through one batcher;
    each request is queued ``delay_s`` after the previous one."""
    q = AdmissionQueue(max_depth=len(plans) + 1)
    b = ContinuousBatcher(ex, q, tracer=tracer)
    reqs = []
    b.start()
    try:
        for k, (plane, max_tokens, delay_s) in enumerate(plans):
            time.sleep(delay_s)
            r = _request(plane, k, max_tokens)
            reqs.append(r)
            q.submit(r)
        for r in reqs:
            assert r.wait(timeout=30), "request lost"
        # The pipelined hand-off's last step is collected after the
        # retire that answered the requests.
        time.sleep(0.05)
    finally:
        b.stop()
    for r in reqs:
        assert r.error is None, r.error
    return reqs, tracer.spans_snapshot()


@pytest.mark.parametrize("plane, pipelined", SHAPES)
def test_steps_equal_the_step_spans_that_list_the_request(plane, pipelined):
    tr = Tracer()
    ex = _executor(plane, pipelined)
    try:
        reqs, spans = _serve(ex, [(plane, 7, 0.0), (plane, 4, 0.0),
                                  (plane, 5, 0.0)], tr)
    finally:
        ex.close()
    dev = [s for s in spans if s.name == "step.device"]
    for r in reqs:
        t = r.timings_ms()
        listed = sum(1 for s in dev
                     if r.request_id in s.attrs["request_ids"])
        assert t["steps"] == listed > 0
        assert set(t) >= {"device_ms", "gap_ms", "starved_steps"}
        assert 0 <= t["starved_steps"] <= t["steps"]
        assert t["device_ms"] >= t["steps"] * STEP_S * 1e3 * 0.9
        # Two-phase loops time their submits; the sync row loop has none.
        assert ("submit_ms" in t) == (plane == "kv" or pipelined)


@pytest.mark.parametrize("plane, pipelined", SHAPES)
def test_device_and_gap_add_up_to_the_worker_intervals(plane, pipelined):
    tr = Tracer()
    ex = _executor(plane, pipelined)
    try:
        (r,), _ = _serve(ex, [(plane, 6, 0.0)], tr)
    finally:
        ex.close()
    t = r.timings_ms()
    n = t["steps"]
    # The request ran alone: its steps are the executor's first n.
    own = ex.intervals[:n]
    dev_ms = sum(b - a for a, b in own) * 1e3
    span_ms = (own[-1][1] - own[0][0]) * 1e3
    # Its first step came after a drained loop: no gap is counted before
    # it, nor, in a pipelined loop, before its second (submitted before
    # the loop had collected a step).
    gaps = [own[i][0] - own[i - 1][1] for i in range(1, n)]
    skip = 1 if pipelined else 0
    gap_ms = sum(gaps[skip:]) * 1e3
    tol = 0.05 * n + 0.01
    assert t["device_ms"] == pytest.approx(dev_ms, abs=tol)
    assert t["gap_ms"] == pytest.approx(gap_ms, abs=tol)
    assert (t["device_ms"] + t["gap_ms"] + sum(gaps[:skip]) * 1e3
            == pytest.approx(span_ms, abs=tol))


# A host delay before each dispatch, long against a step on a loaded box.
DELAY_S = 0.02


def _host_delay(worker):
    """The host's delay before a dispatch, outlasting the step before it
    even where a loaded box holds the worker's thread back."""
    time.sleep(DELAY_S)
    last = worker._last
    if last is not None:
        last.event.wait(10)


class _SlowSubmitKV(_KVTimed):
    def submit(self, *a, **kw):
        _host_delay(self._worker)
        return super().submit(*a, **kw)


class _SlowSubmitRow(_RowTimed):
    def submit(self, *a, **kw):
        _host_delay(self._worker)
        return super().submit(*a, **kw)


@pytest.mark.parametrize("plane", ["row", "kv"])
def test_a_host_delay_in_submit_starves_every_step(plane):
    tr = Tracer()
    ex = _executor(plane, True,
                   cls=_SlowSubmitRow if plane == "row" else _SlowSubmitKV)
    try:
        # The second request joins a running loop: none of its steps
        # follows a drained one.
        (first, second), spans = _serve(
            ex, [(plane, 30, 0.0), (plane, 5, 0.2)], tr)
    finally:
        ex.close()
    t = second.timings_ms()
    assert t["steps"] == 5
    assert t["starved_steps"] == t["steps"]
    assert t["submit_ms"] >= t["steps"] * DELAY_S * 1e3
    # The first request's first two steps were submitted before the
    # pipelined loop had collected a step since it drained: no host gap
    # and no starved step is counted for them.
    t1 = first.timings_ms()
    assert t1["starved_steps"] == t1["steps"] - 2
    starved = [s.attrs["starved"] for s in spans if s.name == "step.device"
               and second.request_id in s.attrs["request_ids"]]
    assert starved == [True] * 5


@pytest.mark.parametrize("plane, pipelined", [("row", True), ("kv", True),
                                              ("kv", False)])
def test_no_two_spans_of_a_step_share_an_interval(plane, pipelined,
                                                  monkeypatch):
    # The CPU clock read on every second step, not every 32nd.
    monkeypatch.setattr(scheduler, "CPU_EVERY", 2)
    tr = Tracer()
    ex = _executor(plane, pipelined)
    try:
        _serve(ex, [(plane, 6, 0.0), (plane, 3, 0.0)], tr)
    finally:
        ex.close()
    spans = tr.spans_snapshot()
    by_step = {}
    for s in spans:
        if s.name.startswith(("step.", "executor.", "submit.",
                              "collect.")):
            by_step.setdefault(s.attrs["step"], []).append(s)
    assert by_step
    for step, group in by_step.items():
        spans_of = {}
        for s in group:
            spans_of.setdefault((s.t0, s.t1), []).append(s.name)
        shared = [v for v in spans_of.values() if len(v) > 1]
        assert not shared, (step, shared)
    ids = {s.span_id: s for s in spans}
    for s in spans:
        if s.name.startswith(("submit.", "collect.")):
            parent = ids[s.parent_id]
            assert parent.name == ("executor.submit"
                                   if s.name.startswith("submit.")
                                   else "executor.collect")
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
    names = {s.name for s in spans}
    assert {"submit.launch", "collect.wait"} <= names or plane == "row"
    if plane == "kv":
        assert {"submit.plan", "collect.copy"} <= names
    sampled = [s for s in spans
               if s.name in ("executor.submit", "step.host")]
    for s in sampled:
        if s.attrs["step"] % 2:
            assert "cpu_ms" not in s.attrs
        elif s.name == "executor.submit" or s.attrs["step"] > 2:
            assert s.attrs["cpu_ms"] >= 0.0
    assert any("cpu_ms" in s.attrs for s in sampled)


class _GcKV(SyntheticKVExecutor):
    """Forces a cyclic collection on its third step."""

    def __init__(self, **kw):
        self.n = 0
        self.gc_at = None
        super().__init__(**kw)

    def _device_step(self, plan):
        self.n += 1
        if self.n == 3:
            t0 = time.monotonic()
            gc.collect()
            self.gc_at = (t0, time.monotonic())
        return super()._device_step(plan)


def _post(url, body):
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(body).encode())
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def test_a_forced_collection_lands_in_gc_ms_and_a_span():
    tr = Tracer()
    ex = _GcKV(slots=2, step_time_s=STEP_S, pipelined=True)
    srv = ServingServer([ex], tracer=tr).start()
    try:
        assert tr in gc_pauses._tracers
        out = _post(srv.url, {"prompt_tokens": [1, 2, 3, 4, 5],
                              "max_tokens": 6, "deadline_ms": 20000})
        metrics = urllib.request.urlopen(srv.url + "/metrics",
                                         timeout=10).read().decode()
    finally:
        srv.stop()
        ex.close()
    assert tr not in gc_pauses._tracers
    assert gc_pauses.installed or gc_pauses._hook not in gc.callbacks
    t = out["timings"]
    assert ex.gc_at is not None
    gcs = [s for s in tr.spans_snapshot() if s.name == "host.gc"
           and ex.gc_at[0] <= s.t0 and s.t1 <= ex.gc_at[1]]
    assert len(gcs) == 1
    assert gcs[0].attrs["generation"] == 2
    assert {"collected", "uncollectable"} <= set(gcs[0].attrs)
    assert t["gc_ms"] >= (gcs[0].t1 - gcs[0].t0) * 1e3 - 1e-3
    assert t["gc_ms"] <= t["decode_ms"]
    # One step-time series: the blocked-time alias beside it is gone.
    series = {line.split("{")[0].split(" ")[0].rsplit("_", 1)[0]
              for line in metrics.splitlines()
              if line.startswith("serving_step_")}
    assert series == {"serving_step_device_seconds"}


def test_gc_hook_is_counted_across_installs():
    a, b = Tracer(), Tracer()
    gc_pauses.install(a)
    gc_pauses.install(b)
    try:
        assert gc.callbacks.count(gc_pauses._hook) == 1
        before = gc_pauses.total_s
        gc.collect()
        assert gc_pauses.total_s > before
        for tr in (a, b):
            assert "host.gc" in {s.name for s in tr.spans_snapshot()}
        gc_pauses.remove(a)
        assert gc_pauses.installed
        na = len(a.spans_snapshot())
        nb = len(b.spans_snapshot())
        gc.collect()
        assert len(a.spans_snapshot()) == na
        assert len(b.spans_snapshot()) > nb
    finally:
        gc_pauses.remove(a)
        gc_pauses.remove(b)
    assert a not in gc_pauses._tracers and b not in gc_pauses._tracers


def test_thread_buffer_keeps_its_newest_spans():
    cap = 8
    tr = Tracer(capacity=64, per_thread_cap=cap)
    for i in range(2 * cap):
        tr.record_span(f"s{i}", float(i), float(i) + 0.5)
    assert [s.name for s in tr.spans_snapshot()] == [
        f"s{i}" for i in range(cap, 2 * cap)]
    assert tr.dropped_total() == cap


def test_loose_spans_reach_the_ring_and_stay_bounded():
    tr = Tracer(capacity=64, per_thread_cap=4)
    import threading
    th = threading.Thread(target=lambda: [
        tr.record_loose(f"g{i}", float(i), float(i) + 1.0)
        for i in range(6)])
    th.start()
    th.join()
    assert [s.name for s in tr.spans_snapshot()] == ["g2", "g3", "g4",
                                                     "g5"]
    assert tr.dropped_total() == 2


# -- the CUDA step clock's anchor, on stand-in events ------------------------


class _Dev:
    """A device clock: ``now`` seconds; events stamp it when recorded. A
    host blocked on an event that has not completed wakes at ``wake``."""

    def __init__(self, host):
        self.now = 0.0
        self.host = host
        self.wake = None


class _Event:
    def __init__(self, dev):
        self.dev = dev
        self.t = None
        self.complete = True

    def record(self, stream=None):
        self.t = self.dev.now

    def query(self):
        return self.complete

    def synchronize(self):
        if not self.complete and self.dev.wake is not None:
            self.dev.host["t"] = self.dev.wake
        self.complete = True

    def elapsed_time(self, other):
        # Whole microseconds, truncated, as coarse as a card's events.
        return math.floor(round((other.t - self.t) * 1e6, 6)) * 1e-3


def _clock(monkeypatch):
    """A CudaStepClock on stand-in events; the host's clock reads
    ``host["t"]``, the device's ``dev.now`` plus ``host["offset"]``."""
    host = {"t": 0.0, "offset": 0.0}
    dev = _Dev(host)
    clk = stepclock.CudaStepClock()
    clk._event = lambda enable_timing=True: _Event(dev)
    monkeypatch.setattr(stepclock.time, "monotonic", lambda: host["t"])

    def step(start, end, rec_lead, latency, idle=True, blocks=True):
        """One step on the device [start, end]: the host records its
        start ``rec_lead`` before it runs and sees its end ``latency``
        after, blocked on it from before it ends (``blocks``) or coming
        to it late; ``idle``: the step before had ended by the record."""
        if clk._last is not None:
            clk._last.done.complete = idle
        host["t"] = start + host["offset"] - rec_lead
        dev.now = start
        st = clk.start(None)
        dev.now = end
        clk.done(st, None)
        st.done.complete = False
        clk.submitted(st)
        seen = end + host["offset"] + latency
        if blocks:
            host["t"] = end + host["offset"] - 1e-3
            dev.wake = seen
        else:
            host["t"] = seen
            st.done.complete = True
        clk.wait(st)
        return clk.clock(st)

    return step, clk, dev, host


def _run(step, host, steps, period, work, latency, blocks=True):
    """Steps recorded by the host every ``period`` s, each ``work`` s (and
    0.7 us, which the events round away) on the device, which runs a
    start 5.3 us after its record or when the step before it ends; the
    host sees each end ``latency`` late, and its clock runs ``rate``
    faster than the device's. Returns the largest error of the clocked
    starts and ends."""
    worst = 0.0
    work += 7e-7
    for _ in range(steps):
        rec = host["rec"]
        host["rec"] += period
        host["offset"] += host.get("rate", 0.0) * period
        start = max(rec + 5.3e-6, host["done"])
        host["done"] = start + work
        c = step(start, start + work, start - rec, latency,
                 idle=start <= rec + 5.3e-6, blocks=blocks)
        truth = start + host["offset"]
        worst = max(worst, abs(c.t0 - truth),
                    abs(c.t1 - (truth + work)))
    return worst


def test_step_clock_brackets_the_device_from_both_sides(monkeypatch):
    step, clk, dev, host = _clock(monkeypatch)
    host.update(offset=100.0, rec=1.0, done=0.0)
    # Bound by the host: each start runs 5 us after its record, on an
    # idle stream; the host comes to each end 3 ms late. The records
    # place the steps, the events' whole microseconds adding no drift.
    _run(step, host, 2, 0.010, 0.004, 0.003, blocks=False)
    assert _run(step, host, 400, 0.010, 0.004, 0.003, blocks=False) <= 7e-6
    # Bound by the device: each start runs when the step before it ends,
    # later than its record, with no start event; the host waits for each
    # end and wakes 50 us late. The waits place the steps at once, the
    # idle starts' bound having aged.
    assert _run(step, host, 40, 0.004, 0.006, 5e-5) <= 5.2e-5
    # The host's clock drifts 500 parts a million from the device's, one
    # way, then the other: the bounds age faster, so the freshest still
    # place the steps, whichever kind they are.
    for rate in (5e-4, -5e-4):
        host["rate"] = rate
        host["rec"] = host["done"] + 0.01
        _run(step, host, 2, 0.010, 0.004, 0.003, blocks=False)
        assert _run(step, host, 200, 0.010, 0.004, 0.003,
                    blocks=False) <= 1.2e-5
        assert _run(step, host, 200, 0.004, 0.006, 5e-5) <= 5.8e-5
    assert len(clk._free) <= 4


def test_step_clock_starved_and_event_pool(monkeypatch):
    step, clk, dev, host = _clock(monkeypatch)
    # Two steps in flight: the second is submitted while the first runs.
    dev.now = 0.0
    a = clk.start(None)
    dev.now = 0.010
    clk.done(a, None)
    a.done.complete = False
    clk.submitted(a)
    b = clk.start(None)
    dev.now = 0.020
    clk.done(b, None)
    clk.submitted(b)
    assert a.starved and not b.starved
    b.done.complete = False
    host["t"] = 0.010
    clk.wait(a)
    clk.clock(a)
    host["t"] = 0.021
    clk.wait(b)
    cb = clk.clock(b)
    assert not cb.starved and cb.gap_s == pytest.approx(0.0)
    # The first step's wait bounds it (its done seen at once); aged by the
    # drift allowance over the 10 ms since, that bound places the second.
    assert cb.t1 == pytest.approx(0.020, abs=clk.DRIFT * 0.010 + 1e-9)
    # Submitted behind a step still running, the second step took no
    # start event: it began as the first ended.
    assert a.start is not None and b.start is None
    assert cb.t0 == pytest.approx(0.010, abs=clk.DRIFT * 0.010 + 1e-9)
    # Every clocked event went back to the pool but the reference (the
    # first start) and the last step's done, which the next submit may
    # still query.
    pool = [id(e) for e in clk._free]
    assert id(a.done) in pool
    assert id(a.start) not in pool and id(b.done) not in pool
    # After a reset the first step is starved; its gap still runs from
    # the last clocked step (the batcher counts no gap after a drain).
    clk.reset()
    c = step(0.100, 0.110, 0.0, 0.0)
    assert c.starved and c.gap_s == pytest.approx(0.080)
    # In the sync shape the next submit queries the done just clocked:
    # the pool must not hand it out again first.
    last = clk._last
    nxt = clk.start(None)
    assert nxt.start is not last.done
    clk.done(nxt, None)
    clk.submitted(nxt)
    assert nxt.starved