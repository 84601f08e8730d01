"""bench_serving -- open- and closed-loop load over the real HTTP path,
on the port's executors.

    python -m dpu_operator_tpu_torch.serving.bench_serving [--device cpu]
        [--skip-local] [--decode-S 4 --decode-d 4096 --decode-h 14336]

Counterpart of the JAX package's ``serving/bench_serving.py``: the same
sections, flags, defaults and keys, and the same protocol (exactly one
JSON object on stdout, progress on stderr). The plane under test is the
serving plane: HTTP front end -> admission queue -> continuous-batching
scheduler -> executor seam. The headline figures drive fixed-cost
executors (``SyntheticExecutor``, ``SyntheticKVExecutor``, the
``SyntheticShardSet`` double, ``--step-ms``), so they move on
scheduler, queue and HTTP regressions and nothing else; the model
sections drive the port's real executors on the device.

Host only (synthetic executors; nothing runs on the device):
  1-2. closed loop, continuous batching vs serial batch 1 ->
       serving_reqs_per_s, serving_tok_per_s, serving_p50/p95/p99_ms,
       serving_serial_reqs_per_s, serving_batching_speedup
  3.   open loop at ~2x measured capacity, small queue ->
       serving_overload_* (p99 of admitted work, 503 shed fraction,
       /healthz answered after the storm)
  6.   fault recovery: one replica killed at 2x overload ->
       serving_recovery_ms, serving_fault_goodput_retention
  8.   paged-KV decode over synthetic token-plane replicas, shared and
       unique prompts -> serving_tokens_per_s, serving_kv_prefix_*,
       serving_prefill_stall_frac
  9.   sharded vs local decode over the SyntheticShardSet double, overlap
       on and off -> serving_sharded_*, serving_shard_*
  10.  cross-process tracing overhead, a direct-cost decomposition ->
       serving_sharded_trace_*
  12.  disaggregated vs colocated serving under a prefill flood, and the
       page stream's loopback rate -> serving_decode_p99_ms,
       serving_kv_transfer_*
  13.  speculative draft/verify vs one-token decode -> serving_spec_*
  15.  the cluster-wide prefix cache, routed vs round-robin ->
       serving_prefix_*, serving_ttft_*, serving_tier_*, serving_router_*
  16.  pipelined speculative decode -> serving_pspec_*
  17.  multi-tenant QoS -> serving_tenant_*, serving_burst_recovery_ms
  Sections 9 and 10 resolve ``--device`` (the shard set does) and compute
  on the host.

On the device (``--skip-local`` skips them):
  4.   the row-plane model (``LocalExecutor``, S=1 d=8 h=8 E=1) over HTTP
       -> serving_local_*
  5.   sync vs pipelined ``LocalExecutor`` at ``--decode-S/-d/-h`` (E=1),
       queue preloaded, no HTTP -> serving_steps_per_s,
       serving_sync_steps_per_s, serving_pipeline_speedup, and the
       device vs host-gap split (serving_step_device_ms,
       serving_host_gap_ms, serving_host_gap_frac)
  7.   the section-5 pipelined loop traced vs untraced ->
       serving_trace_overhead_frac, serving_traced_steps_per_s
  11.  one ``PagedDecodeStep`` step at steady full-slot decode: the CUDA
       paged-attention kernel (on a CUDA device), its plain version and
       the plain fp32-pool twin; on a CUDA device the kernel against its
       plain version at reduced shapes (serving_paged_attn_equiv_ok:
       pools bitwise, tokens identical); and the int8 vs fp32 residency
       accounting (serving_kv_bytes_*)
  14.  context-parallel paged KV: resident context per replica vs world
       (KVSpec arithmetic), measured decode over the page-axis
       ``ShardedPagedKVExecutor`` (plain ranks) against the single-worker
       ``PagedKVExecutor`` twin (the kernel on a CUDA device), and the
       per-rank transfer rate -> serving_ctx_per_replica_scaling*,
       serving_shard_kv_*

Renamed keys (section 11's arms are the port's kernels; no other key
differs from the reference's): ``serving_paged_attn_cuda_ms`` and
``serving_paged_attn_torch_ms`` for ``_pallas_ms`` and ``_xla_ms``, and
``serving_paged_attn_kernel`` is ``"cuda"`` or ``"torch"``. On the CPU
section 11 has no kernel to time or compare: no ``_cuda_ms`` and no
``serving_paged_attn_equiv_ok``.

``--device`` defaults to the CUDA card; with none, ``main`` prints nothing
on stdout and exits 2 before any section runs, and it never falls back
to the CPU (``--device cpu`` runs every section there). A section that
fails leaves its ``<section>_error`` key beside the others' numbers, and
``main`` then exits 1 after printing the object. This harness holds no
gate and no threshold.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional, Tuple


def _post_full(url: str, body: dict, timeout: float = 120.0
               ) -> Tuple[int, float, Optional[dict]]:
    """(status, latency_ms, parsed_200_body_or_None): ONE copy of the
    request/error discipline every section shares — HTTPError bodies
    drained, connection-level failures under an overload thread storm
    counted as code 0 instead of crashing the client thread."""
    data = json.dumps(body).encode()
    parsed = None
    t0 = time.perf_counter()
    try:
        r = urllib.request.urlopen(
            urllib.request.Request(url + "/v1/generate", data=data),
            timeout=timeout)
        raw = r.read()
        code = r.status
        if code == 200:
            try:
                parsed = json.loads(raw)
            except ValueError:
                pass
    except urllib.error.HTTPError as e:
        try:
            e.read()
        except OSError:
            pass
        code = e.code
    except OSError:
        code = 0
    return code, (time.perf_counter() - t0) * 1000.0, parsed


def _post(url: str, body: dict, timeout: float = 120.0
          ) -> Tuple[int, float, int]:
    """(status, latency_ms, n_tokens). n_tokens is the ACTUAL decoded
    token count from a 200 body (-1 otherwise): deadline-truncated
    responses are 200s with fewer than max_tokens tokens, and any
    per-user throughput derived from the request's max_tokens would
    overstate exactly the overloaded regime the bench measures."""
    code, ms, parsed = _post_full(url, body, timeout)
    ntok = -1
    if parsed is not None:
        try:
            ntok = len(parsed.get("tokens", ()))
        except (AttributeError, TypeError):
            pass
    return code, ms, ntok


def nearest_rank(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank (ceil) percentile over a SORTED sample list: p99
    over <100 samples must still be able to land on the worst
    observation — int() truncation would exclude it. The one percentile
    convention for serving measurements (tests import it too)."""
    n = len(sorted_vals)
    return sorted_vals[min(n - 1, max(0, math.ceil(n * q) - 1))]


def _quantiles(lat: List[float]) -> dict:
    if not lat:
        return {"p50": None, "p95": None, "p99": None}
    s = sorted(lat)
    return {"p50": round(nearest_rank(s, 0.50), 2),
            "p95": round(nearest_rank(s, 0.95), 2),
            "p99": round(nearest_rank(s, 0.99), 2)}


def closed_loop(url: str, clients: int, per_client: int,
                max_tokens: int, deadline_ms: float = 120_000.0):
    lat, codes = [], []
    lock = threading.Lock()

    def run(c):
        for i in range(per_client):
            code, ms, _ = _post(url, {"prompt": f"c{c}-{i}",
                                      "max_tokens": max_tokens,
                                      "deadline_ms": deadline_ms})
            with lock:
                codes.append(code)
                if code == 200:
                    lat.append(ms)

    ts = [threading.Thread(target=run, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    return wall, lat, codes


def open_loop(url: str, rate_per_s: float, seconds: float,
              max_tokens: int, deadline_ms: float,
              on_tick=None, completions: Optional[list] = None,
              body_fn=None, tok_lat: Optional[list] = None):
    """Fixed-rate arrivals regardless of completions — the load shape
    that exposes queue growth (closed-loop self-throttles; an open
    loop does not, which is why overload must be measured this way).
    `on_tick(elapsed_s)` runs once per arrival before it is paced
    (the fault-recovery section arms its mid-run kill there);
    `completions`, when given, collects (code, time.monotonic())
    per finished request (same section's goodput windows); `body_fn(i)`
    overrides the request body (the paged-KV section posts
    prompt_tokens instead of a prompt string); `tok_lat`, when given,
    collects (n_tokens, latency_ms) per 200 — the actual decoded
    count, so truncated responses weigh what they delivered."""
    lat, codes = [], []
    lock = threading.Lock()
    threads: List[threading.Thread] = []

    def one(i):
        body = (body_fn(i) if body_fn is not None
                else {"prompt": f"o{i}"})
        body.setdefault("max_tokens", max_tokens)
        body.setdefault("deadline_ms", deadline_ms)
        code, ms, ntok = _post(url, body)
        with lock:
            codes.append(code)
            if code == 200:
                lat.append(ms)
                if tok_lat is not None and ntok >= 0:
                    tok_lat.append((ntok, ms))
            if completions is not None:
                completions.append((code, time.monotonic()))

    n = int(rate_per_s * seconds)
    t0 = time.perf_counter()
    for i in range(n):
        now = time.perf_counter()
        if on_tick is not None:
            on_tick(now - t0)
        target = t0 + i / rate_per_s
        if target > now:
            time.sleep(target - now)
        th = threading.Thread(target=one, args=(i,))
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=deadline_ms / 1000.0 + 30)
    wall = time.perf_counter() - t0
    return wall, lat, codes


def decode_loop_rates(slots: int, model: dict, n_req: int,
                      toks: int, trace, repeats: int = 3, *,
                      device=None) -> dict:
    """Section 5: steps/s through the real ContinuousBatcher for the
    sync vs pipelined LocalExecutor on ``device`` (None: the CUDA
    card). The queue is preloaded and driven
    without HTTP so the figure measures the decode loop (scheduler
    bookkeeping vs device step), not the GIL-bound front-end. Each
    executor compiles once, then the modes run INTERLEAVED `repeats`
    times and the best wall per mode is kept — the shared-box defense:
    a noisy neighbour lands on both modes or neither, and best-of
    discards the hits (same reasoning as the fabric bench's paired
    in-bench samples). The device/host-gap split comes from the
    scheduler's own histograms on the best pipelined run."""
    import time as _time

    from ..utils.metrics import Registry
    from .api import GenerateRequest, encode_prompt
    from .executor import LocalExecutor
    from .queue import AdmissionQueue
    from .scheduler import ContinuousBatcher

    out: dict = {}
    tok_total = n_req * toks
    execs: dict = {}
    for mode in ("sync", "pipelined"):
        t0 = _time.perf_counter()
        execs[mode] = LocalExecutor(slots=slots, mode=mode,
                                    device=device, **model)
        if mode == "pipelined":
            out["serving_decode_compile_s"] = round(
                _time.perf_counter() - t0, 2)

    def one_run(mode):
        ex = execs[mode]
        reg = Registry()
        q = AdmissionQueue(max_depth=n_req + 1)
        b = ContinuousBatcher(ex, q, registry=reg)
        reqs = [GenerateRequest(
            prompt_vec=encode_prompt(f"decode-{i}", ex.d),
            max_tokens=toks, deadline=_time.monotonic() + 600.0)
            for i in range(n_req)]
        for r in reqs:
            q.submit(r)
        t0 = _time.perf_counter()
        b.start()
        ok = all(r.wait(timeout=600) for r in reqs)
        wall = _time.perf_counter() - t0
        b.stop()
        if not ok or any(r.error for r in reqs):
            raise RuntimeError(next(
                (r.error for r in reqs if r.error), "request lost"))
        # Useful steps: tokens delivered / slots — pipeline hand-off
        # steps and drain-tail partial occupancy count AGAINST the
        # rate, so stale-row decodes can't inflate it.
        return (tok_total / slots) / wall, reg, b.steps

    try:
        for mode in ("sync", "pipelined"):
            one_run(mode)  # unrecorded warm-up: first post-compile
            # loop runs measurably cold (allocator/cache warmth)
        best: dict = {}
        for rep in range(repeats):
            for mode in ("sync", "pipelined"):
                rate, reg, steps = one_run(mode)
                trace(f"decode {mode} rep{rep}: {rate:.0f} useful "
                      f"steps/s ({steps} loop steps)")
                if mode not in best or rate > best[mode][0]:
                    best[mode] = (rate, reg)
    finally:
        for ex in execs.values():
            ex.close()

    out["serving_sync_steps_per_s"] = round(best["sync"][0], 1)
    out["serving_steps_per_s"] = round(best["pipelined"][0], 1)
    out["serving_pipeline_speedup"] = round(
        best["pipelined"][0] / best["sync"][0], 2)
    reg = best["pipelined"][1]
    dev = sum(s for s, _ in reg.histogram_totals(
        "serving_step_device_seconds").values())
    dev_n = sum(n for _, n in reg.histogram_totals(
        "serving_step_device_seconds").values())
    gap = sum(s for s, _ in reg.histogram_totals(
        "serving_host_gap_seconds").values())
    gap_n = sum(n for _, n in reg.histogram_totals(
        "serving_host_gap_seconds").values())
    if dev + gap > 0:
        out["serving_host_gap_frac"] = round(gap / (dev + gap), 3)
    if dev_n:
        out["serving_step_device_ms"] = round(dev / dev_n * 1000, 3)
    if gap_n:
        out["serving_host_gap_ms"] = round(gap / gap_n * 1000, 3)
    trace(f"decode: pipelined {out['serving_steps_per_s']} vs sync "
          f"{out['serving_sync_steps_per_s']} useful steps/s = "
          f"{out['serving_pipeline_speedup']}x, host-gap frac "
          f"{out.get('serving_host_gap_frac')}")
    return out


def trace_overhead(slots: int, model: dict, n_req: int, toks: int,
                   trace, repeats: int = 5, *, device=None) -> dict:
    """Section 7, tracing overhead: the always-on price of tracing. The
    SAME pipelined decode loop as section 5 (on ``device``; None: the
    CUDA card), run with the tracer enabled vs
    disabled in back-to-back INTERLEAVED pairs; the figure is the
    MEDIAN of the per-pair rate ratios:

      serving_trace_overhead_frac = max(0, 1 - median(on_i / off_i))

    Per-pair ratios, not best-of-per-arm: each run here is a few
    hundred ms, and on a shared 2-core box run-to-run swing (~10-15%)
    dwarfs the effect being measured — a slow patch lands on BOTH
    halves of a pair and cancels in the ratio, and the median discards
    the pairs a noisy neighbour split down the middle (best-of compares
    two different patches of box weather and measured tracing as
    *negative* overhead as often as 15%).

    The reference's bench.py gates it ABSOLUTE at <= 0.02 — tracing
    that costs more than 2% of steps/s is a regression no rolling median
    should ever absorb, because the whole design premise ("always-on
    cheap") dies with it; this harness holds no gate."""
    import statistics
    import time as _time

    from ..obs import trace as obs_trace
    from .api import GenerateRequest, encode_prompt
    from .executor import LocalExecutor
    from .queue import AdmissionQueue
    from .scheduler import ContinuousBatcher

    ex = LocalExecutor(slots=slots, mode="pipelined", device=device,
                       **model)
    tok_total = n_req * toks

    def one_run() -> float:
        q = AdmissionQueue(max_depth=n_req + 1)
        b = ContinuousBatcher(ex, q)
        reqs = [GenerateRequest(
            prompt_vec=encode_prompt(f"trace-{i}", ex.d),
            max_tokens=toks, deadline=_time.monotonic() + 600.0)
            for i in range(n_req)]
        for r in reqs:
            q.submit(r)
        t0 = _time.perf_counter()
        b.start()
        ok = all(r.wait(timeout=600) for r in reqs)
        wall = _time.perf_counter() - t0
        b.stop()
        if not ok or any(r.error for r in reqs):
            raise RuntimeError(next(
                (r.error for r in reqs if r.error), "request lost"))
        return (tok_total / slots) / wall

    out: dict = {}
    tr = obs_trace.get_tracer()
    ratios: List[float] = []
    rates = {"on": [], "off": []}
    try:
        for arm in (True, False):  # unrecorded warm-up per arm
            tr.enabled = arm
            one_run()
        for rep in range(repeats):
            pair = {"on": 0.0, "off": 0.0}
            # Best-of-2 per arm INSIDE the pair, arms alternating and
            # the leading arm flipping per pair: a CPU-throttle window
            # (the dominant noise on CI-class containers — whole runs
            # halve) is discarded by the inner best-of, and slow drift
            # cannot systematically favour one arm.
            order = ("on", "off", "on", "off") if rep % 2 == 0 \
                else ("off", "on", "off", "on")
            for arm in order:
                tr.enabled = arm == "on"
                r = one_run()
                pair[arm] = max(pair[arm], r)
                rates[arm].append(r)
            ratios.append(pair["on"] / pair["off"])
            trace(f"trace pair {rep}: on {pair['on']:.0f} / off "
                  f"{pair['off']:.0f} steps/s = ratio "
                  f"{ratios[-1]:.3f}")
            # Bound tracer memory across reps: each run's batcher
            # thread leaves a buffer until drained.
            tr.clear()
    finally:
        tr.enabled = True
        ex.close()

    out["serving_traced_steps_per_s"] = round(max(rates["on"]), 1)
    out["serving_untraced_steps_per_s"] = round(max(rates["off"]), 1)
    out["serving_trace_overhead_frac"] = round(
        max(0.0, 1.0 - statistics.median(ratios)), 4)
    trace(f"trace overhead: {out['serving_trace_overhead_frac']} "
          f"(median of {len(ratios)} paired ratios)")
    return out


def sharded_trace_overhead(slots: int, trace, world: int = 3,
                           iters: int = 4000,
                           step_ms: float = 2.0,
                           coll_ms: float = 1.0, *,
                           device=None) -> dict:
    """Section 10, cross-process tracing overhead: the always-on price
    of CROSS-PROCESS tracing, as a DIRECT-COST decomposition:

      serving_sharded_trace_overhead_frac =
          (per-step tracing cost) / (untraced sharded step wall)

    The numerator is measured as a tight loop over the EXACT per-step
    op sequences the traced plane adds — the worker side (reserve +
    shard.compute/reduce_blocked records + tracer harvest + ship
    flush + the reply's spans json) and the coordinator side
    (shard.step reserve/record + per-rank ClockSync.observe/estimate
    + per-rank Tracer.ingest of a representative shipment, ×world) —
    deterministic CPU-bound work a throttled container measures to µs
    precision. The denominator is the untraced sharded pipelined step
    wall: the section-9 cost model (2 ms compute + 1 ms collective)
    driven through the FabricExecutor seam with one step in flight,
    median of 3 runs.

    Why not a traced-vs-untraced throughput ratio like section 7?
    Three of them were built and rejected with data: (a) synthetic
    thread shards share the GIL with the coordinator, so µs of
    coordinator-side recording amplify through the interpreter's 5 ms
    switch interval into a fake ~7% "overhead" no multi-process
    deployment pays; (b/c) real shard_worker subprocesses (world 1
    and 2) put the effect under genuine shipping, but this
    cpu-share-throttled container swings identical runs 3-5x, so a
    ±2% bound is unresolvable at any affordable repeat count (pair
    ratios observed 0.6-2.2). The direct decomposition prices every
    op the traced plane adds to the hot path — a regression in any of
    them (a slow record, an O(n²) ingest, a leaking harvest) moves
    the numerator immediately — while staying deterministic. (The
    reference's bench.py gates it ABSOLUTE at ≤ 0.02.) The shard set
    resolves ``device`` (None: the CUDA card) and computes on the host.
    The piggyback itself adds zero
    protocol round trips by construction (spans/metrics/clock stamps
    ride reply frames that exist anyway); the json term above is its
    entire marginal wire-side CPU."""
    import json as _json
    import statistics
    import time as _time

    from ..obs import trace as obs_trace
    from ..obs.xproc import ClockSync, SpanShip
    from ..utils.metrics import Registry
    from .sharded import FabricExecutor, SyntheticShardSet

    import numpy as np

    d = 16
    out: dict = {}

    # -- numerator: per-step tracing cost, worker side ------------------------
    wtr = obs_trace.Tracer()
    ship = SpanShip(cap=512)
    wreg = Registry()
    t0 = _time.perf_counter()
    for k in range(iters):
        sid = wtr.reserve_id()
        m = _time.monotonic()
        wtr.record_span("shard.reduce_blocked", m, m + 0.001,
                        parent_id=sid,
                        attrs={"rank": 0, "step": k, "stage": 0})
        wtr.record_span("shard.compute", m, m + 0.002, span_id=sid,
                        attrs={"rank": 0, "step": k,
                               "compute_s": 0.001,
                               "collective_s": 0.001,
                               "xparent": 12345})
        wreg.observe("shard_step_compute_seconds", 0.001)
        wreg.observe("shard_step_collective_seconds", 0.001)
        wreg.counter_inc("shard_steps_total")
        ship.harvest(wtr)
        wire = ship.flush()
        _json.dumps({"op": "tokens", "step": k, "compute_s": 0.001,
                     "collective_s": 0.001, "t_rx": m, "t_tx": m,
                     "spans": wire, "spans_dropped": 0})
    worker_us = (_time.perf_counter() - t0) / iters * 1e6

    # -- numerator: coordinator side (ingest scales with world) ---------------
    def rank_shipment(r):
        # FRESH tuples+dicts per iteration, like the real path (each
        # reply's spans parse off the wire into new objects): ingest
        # takes ownership and mutates attrs in place, so reusing one
        # shipment would measure the xparent branch exactly once and
        # alias every ingested span onto one dict.
        return [
            ("shard.compute", 2 * r + 1, None, None, "span", 1.0,
             1.002, {"rank": r, "step": 1, "compute_s": 0.001,
                     "collective_s": 0.001, "xparent": 12345}),
            ("shard.reduce_blocked", 2 * r + 2, 2 * r + 1, None,
             "span", 1.0, 1.001, {"rank": r, "step": 1, "stage": 0}),
        ]

    ctr = obs_trace.Tracer()
    syncs = [ClockSync() for _ in range(world)]
    rids = [f"req-{i}" for i in range(slots)]
    coord_acc = 0.0
    for k in range(iters):
        # Shipment construction sits OUTSIDE the timed region: on the
        # real path those dicts come off the wire via recv_msg's json
        # parse — protocol cost, not the tracing plane's.
        ships = [rank_shipment(r) for r in range(world)]
        t0 = _time.perf_counter()
        sid = ctr.reserve_id()
        m = _time.monotonic()
        ctr.record_span("shard.step", m, m + 0.003, span_id=sid,
                        attrs={"replica": "bench", "step": k,
                               "world": world, "codec": "fp32",
                               "request_ids": rids})
        for r in range(world):
            syncs[r].observe(m, m + 0.0005, m + 0.0025, m + 0.003)
            off, unc = syncs[r].estimate
            ctr.ingest(ships[r], offset=off,
                       attrs={"clock_offset_s": round(off, 6),
                              "clock_unc_s": round(unc, 6)})
        coord_acc += _time.perf_counter() - t0
        if k % 64 == 0:
            # Realistic ring churn: a server's scrape path drains.
            ctr.clear()
    coord_us = coord_acc / iters * 1e6

    # -- denominator + informational steps/s: the seam loop -------------------
    def seam_run(ex, n_steps=200):
        row = np.ones(d, np.float32)
        t0 = _time.perf_counter()
        prev = ex.submit([(0, row)], occupants=rids[:1])
        for _ in range(n_steps - 1):
            h = ex.submit([(0, row)], occupants=rids[:1])
            # Bounded inside: FabricExecutor.collect gathers under
            # its own step_timeout_s deadline (the GL010 contract
            # lives one layer down).
            ex.collect(prev)  # graftlint: disable=GL010
            prev = h
        ex.collect(prev)
        return n_steps / (_time.perf_counter() - t0)

    tr = obs_trace.get_tracer()
    rates = {"on": [], "off": []}
    ex = FabricExecutor(
        SyntheticShardSet(world=world, slots=slots, d=d, seed=7,
                          step_time_s=step_ms / 1000.0,
                          collective_time_s=coll_ms / 1000.0,
                          device=device),
        mode="pipelined", name="trace-bench")
    try:
        ex.reset()
        for arm in ("on", "off"):
            tr.enabled = arm == "on"
            seam_run(ex, n_steps=50)  # warm-up
            for _ in range(3):
                rates[arm].append(seam_run(ex))
            tr.clear()
    finally:
        tr.enabled = True
        ex.close()
    step_wall_us = 1e6 / statistics.median(rates["off"])

    frac = (worker_us + coord_us) / step_wall_us
    out["serving_sharded_trace_cost_us"] = round(
        worker_us + coord_us, 1)
    out["serving_sharded_trace_worker_us"] = round(worker_us, 1)
    out["serving_sharded_trace_coord_us"] = round(coord_us, 1)
    out["serving_sharded_traced_steps_per_s"] = round(
        statistics.median(rates["on"]), 1)
    out["serving_sharded_untraced_steps_per_s"] = round(
        statistics.median(rates["off"]), 1)
    out["serving_sharded_trace_overhead_frac"] = round(frac, 4)
    trace(f"sharded trace overhead: worker {worker_us:.1f}us + "
          f"coord {coord_us:.1f}us per step over a "
          f"{step_wall_us:.0f}us untraced step = {frac:.4f}")
    return out


def fault_recovery(slots: int, step_s: float, reqs_per_s: float,
                   trace, seconds: float = 4.0, kill_at_s: float = 1.2
                   ) -> dict:
    """Section 6: self-healing under fire. Two synthetic
    replicas behind the supervised pool, an open loop at ~2x measured
    capacity, and ONE deterministic injected replica kill mid-run
    (times=1 spec armed at t=kill_at_s; the fire timestamp is the
    kill's ground truth). Records:

      serving_recovery_ms            kill -> pool back to full live
                                     replica count (sampled at 2 ms)
      serving_fault_goodput_retention  200-completions/s inside the
                                     outage window / the pre-kill rate
      serving_fault_requeued         requests seized + re-admitted

    The recovery gate in bench.py holds serving_recovery_ms to 1.35x
    its rolling median — restart/backoff/watchdog regressions move it
    even when throughput noise hides them."""
    from dpu_operator_tpu_torch import faults

    from .executor import SyntheticExecutor
    from .server import ServingServer

    plan = faults.install(seed=0)
    site = "bench-r0"
    ex0 = faults.FaultyExecutor(
        SyntheticExecutor(slots=slots, d=16, step_time_s=step_s),
        site=site)
    ex1 = SyntheticExecutor(slots=slots, d=16, step_time_s=step_s)
    srv = ServingServer(
        [ex0, ex1], max_queue_depth=4 * slots,
        pool_opts=dict(watchdog_s=1.0, restart_backoff_s=0.02,
                       poll_s=0.002, max_attempts=5)).start()
    out: dict = {}
    try:
        closed_loop(srv.url, 2, 2, 2)  # warm the path
        rate = 2.0 * max(reqs_per_s, 1.0)
        done: List[Tuple[int, float]] = []  # (code, finish time)
        live_samples: List[Tuple[float, int, int]] = []
        stop_sampler = threading.Event()

        def sampler():
            while not stop_sampler.is_set():
                live_samples.append(
                    (time.monotonic(), srv.pool.live_count(),
                     sum(srv.pool.restarts)))
                stop_sampler.wait(0.002)

        armed = [False]

        def arm_kill(elapsed_s):
            if not armed[0] and elapsed_s >= kill_at_s:
                plan.inject(f"{site}.step",
                            exc=RuntimeError("bench: injected kill"),
                            times=1)
                armed[0] = True

        samp = threading.Thread(target=sampler, daemon=True)
        samp.start()
        t0 = time.monotonic()
        open_loop(srv.url, rate, seconds, 8, 4000.0,
                  on_tick=arm_kill, completions=done)
        stop_sampler.set()
        samp.join(timeout=1.0)

        kill_ts = plan.fired_at.get(f"{site}.step")
        if not kill_ts:
            out["serving_fault_error"] = "kill never fired"
            return out
        kill_t = kill_ts[0]
        # Recovery = kill -> (a restart has happened AND the pool is
        # back at full strength). Gating on the restart counter keeps
        # a pre-detection "still looks live" sample from reading as an
        # instant recovery.
        recovered_t = next(
            (ts for ts, live, restarts in live_samples
             if ts > kill_t and restarts >= 1 and live == 2), None)
        if recovered_t is None:
            out["serving_fault_error"] = "pool never recovered"
            return out
        out["serving_recovery_ms"] = round(
            (recovered_t - kill_t) * 1000.0, 1)

        # Goodput retention: completion RATE inside the outage window
        # against the pre-kill steady rate. Windows padded to 0.25 s
        # (a sub-poll recovery must not divide by a sliver) and the
        # pre-kill window clamped to the load's actual start — letting
        # it reach before t0 would count an empty stretch as "steady
        # state" and flatter the retention figure.
        window = max(recovered_t - kill_t, 0.25)
        pre_window = min(window, max(kill_t - t0, 0.25))
        pre = sum(1 for c, ts in done
                  if c == 200 and kill_t - pre_window <= ts < kill_t)
        during = sum(1 for c, ts in done
                     if c == 200 and kill_t <= ts < kill_t + window)
        if pre > 0:
            out["serving_fault_goodput_retention"] = round(
                min((during / window) / (pre / pre_window), 1.0), 3)
        out["serving_fault_requeued"] = int(srv.queue.requeued)
        out["serving_fault_restarts"] = int(sum(srv.pool.restarts))
        trace(f"fault recovery: {out['serving_recovery_ms']} ms to "
              f"full strength, goodput retention "
              f"{out.get('serving_fault_goodput_retention')}, "
              f"{out['serving_fault_requeued']} requeued")
        return out
    finally:
        faults.uninstall()
        srv.stop()


def kv_paged_serving(slots: int, step_s: float, trace,
                     seconds: float = 2.5, max_tokens: int = 12,
                     prompt_len: int = 24) -> dict:
    """Section 8: paged-KV decode through the REAL HTTP
    path. Two open-loop arms at ~2x measured capacity over synthetic
    token-plane replicas (fixed step cost — the scheduler/KV plane is
    what moves, not the host's FLOPs):

      * SHARED — every request draws one of 4 prompts, so after the
        first wave the prefix cache absorbs most prefill: the
        headline serving_tokens_per_s and serving_kv_prefix_hit_frac;
      * UNIQUE — per-request prompts, no sharing possible: the
        prefill-heavy arm, whose serving_prefill_stall_frac (decode
        steps that co-ran with prefill chunks / all decode steps) is
        the chunked-prefill interleave exposure the gate watches.

    serving_kv_prefix_speedup = shared/unique decode-token throughput:
    what prefix reuse is worth at 2x overload."""
    import statistics

    from .api import encode_prompt_tokens
    from .kvcache import SyntheticKVExecutor
    from .server import ServingServer

    out: dict = {}
    arms: dict = {}
    chunk = 8
    for arm in ("shared", "unique"):
        ex = SyntheticKVExecutor(
            slots=slots, vocab=64, block_size=4, num_blocks=1024,
            max_blocks_per_req=16, prefill_chunk=chunk,
            step_time_s=step_s, pipelined=True)
        srv = ServingServer([ex], max_queue_depth=4 * slots).start()
        try:
            def body(i, arm=arm):
                text = (f"kv-{i % 4}" if arm == "shared"
                        else f"kv-uniq-{i}")
                return {"prompt_tokens": encode_prompt_tokens(
                    text, prompt_len, 64)}

            # Warm the path (indices far outside the measured range so
            # the unique arm's cache stays cold), then drive 2x the
            # ANALYTIC capacity: slots / (per-request steps x step
            # cost) — the serial warm posts under-measure a
            # continuous-batching server by ~slots x.
            for i in range(2 * slots):
                _post(srv.url, dict(body(10 ** 6 + i),
                                    max_tokens=max_tokens,
                                    deadline_ms=30000))
            steps_per_req = -(-prompt_len // chunk) + max_tokens
            cap = slots / max(steps_per_req * step_s, 1e-4)
            rate = 2.0 * max(cap, 4.0)
            pre = ex.kv_stats()
            tok_lat: list = []
            t0 = time.perf_counter()
            wall, lat, codes = open_loop(
                srv.url, rate, seconds, max_tokens, 4000.0,
                body_fn=body, tok_lat=tok_lat)
            post = ex.kv_stats()
            n_ok = sum(1 for c in codes if c == 200)
            dec = post["decode_tokens"] - pre["decode_tokens"]
            lookup = (post["prefix_lookup_tokens"]
                      - pre["prefix_lookup_tokens"])
            hit = (post["prefix_hit_tokens"]
                   - pre["prefix_hit_tokens"])
            dsteps = post["steps_decode"] - pre["steps_decode"]
            msteps = post["steps_mixed"] - pre["steps_mixed"]
            arms[arm] = {
                "tok_per_s": dec / wall,
                # Actual decoded tokens per response, NOT max_tokens:
                # deadline-truncated 200s deliver fewer, and they
                # cluster exactly in the overload this section drives.
                "tok_per_s_user": (statistics.mean(
                    n / (ms / 1000.0) for n, ms in tok_lat)
                    if tok_lat else 0.0),
                "hit_frac": hit / lookup if lookup else 0.0,
                "stall_frac": msteps / dsteps if dsteps else 0.0,
                "admitted_per_s": n_ok / wall,
                "shed_frac": sum(1 for c in codes
                                 if c == 503) / max(1, len(codes)),
            }
            trace(f"kv {arm} @{rate:.0f}/s: "
                  f"{arms[arm]['tok_per_s']:.0f} tok/s "
                  f"({arms[arm]['tok_per_s_user']:.0f}/user), hit "
                  f"{arms[arm]['hit_frac']:.2f}, stall "
                  f"{arms[arm]['stall_frac']:.2f}, shed "
                  f"{arms[arm]['shed_frac']:.2f}")
        finally:
            srv.stop()
            ex.close()
        ex.allocator.assert_clean()

    out["serving_tokens_per_s"] = round(arms["shared"]["tok_per_s"], 1)
    out["serving_tokens_per_s_user"] = round(
        arms["shared"]["tok_per_s_user"], 1)
    out["serving_kv_prefix_hit_frac"] = round(
        arms["shared"]["hit_frac"], 3)
    # Stall exposure from the prefill-heavy arm: the shared arm's
    # cache absorbs prefill, which would make the gate's signal (a
    # rotting chunk budget) vanish into cache-hit noise.
    out["serving_prefill_stall_frac"] = round(
        arms["unique"]["stall_frac"], 3)
    if arms["unique"]["tok_per_s"] > 0:
        out["serving_kv_prefix_speedup"] = round(
            arms["shared"]["tok_per_s"] / arms["unique"]["tok_per_s"],
            2)
    return out


def disagg_serving(trace, slots: int = 4, step_ms: float = 2.0,
                   tok_ms: float = 0.4, seconds: float = 2.5) -> dict:
    """Section 12: disaggregated vs colocated serving
    under a PREFILL FLOOD — the cross-replica isolation claim,
    measured. Cost model: SyntheticKVExecutor with a per-planned-
    token cost on top of the fixed floor (a step co-running an
    8-token prefill chunk really costs more than a pure-decode
    step — the physics that makes prefill able to stall decode
    INSIDE a shared batcher at all). Two arms, same total hardware
    (2 replicas), same workload:

      * decode-class requests (short prompt, 12 tokens) closed-loop,
        measuring PER-TOKEN decode latency from the response's own
        decode_ms/tokens decomposition;
      * a concurrent open-loop flood of long prompts (96 tokens,
        max_tokens=1 — pure prefill work) at ~2x the prefill plane's
        analytic capacity.

    Colocated: flood chunks co-run in the decode requests' steps, so
    every decode token pays the chunk's token cost (the prefill budget
    bounds prefill per step; it cannot make co-scheduled tokens
    free). Disagg: no decode replica ever plans a prefill chunk, so
    decode per-token p99 holds flat — gated <= 1.35x rolling median
    as serving_decode_p99_ms, with the colocated twin and the
    isolation ratio informational. Also measured here: the page
    stream's transfer Gb/s on a realistic block payload (a pure
    loopback microbench of the framing + int8 codec path) and the
    transfer-vs-re-prefill breakeven."""
    from ..utils.metrics import Registry
    from .api import encode_prompt_tokens
    from .disagg import DisaggPool, KVPageStream, KVPageStreamServer
    from .disagg.spec import KVSpec
    from .kvcache import SyntheticKVExecutor
    from .server import ServingServer

    out: dict = {}
    step_s, tok_s = step_ms / 1000.0, tok_ms / 1000.0
    dec_prompt, dec_toks = 8, 12
    flood_prompt, chunk = 96, 8

    def mk():
        return SyntheticKVExecutor(
            slots=slots, vocab=64, block_size=4, num_blocks=4096,
            max_blocks_per_req=32, prefill_chunk=chunk,
            step_time_s=step_s, token_time_s=tok_s, pipelined=True)

    def post_body(url, body):
        code, _ms, parsed = _post_full(url, body, timeout=60)
        return code, parsed

    def run_arm(kind):
        reg = Registry()
        if kind == "disagg":
            pre, dec = mk(), mk()
            execs = [pre, dec]

            def factory(_execs, q, registry, tracer, flight_recorder):
                return DisaggPool([pre], [dec], q, registry=registry,
                                  tracer=tracer,
                                  flight_recorder=flight_recorder)

            srv = ServingServer(execs, registry=reg,
                                max_queue_depth=max(64, 8 * slots),
                                pool_factory=factory).start()
        else:
            execs = [mk(), mk()]
            srv = ServingServer(execs, registry=reg,
                                max_queue_depth=max(64, 8 * slots)
                                ).start()
        per_tok: list = []
        lock = threading.Lock()
        stop = threading.Event()
        try:
            # Warm both classes through the path once.
            post_body(srv.url, {
                "prompt_tokens": encode_prompt_tokens(
                    "warm-d", dec_prompt, 64),
                "max_tokens": 2, "deadline_ms": 20000})

            def decode_client(c):
                i = 0
                while not stop.is_set():
                    code, body = post_body(srv.url, {
                        "prompt_tokens": encode_prompt_tokens(
                            f"dec-{kind}-{c}-{i}", dec_prompt, 64),
                        "max_tokens": dec_toks,
                        "deadline_ms": 20000})
                    if code == 200 and body and body["tokens"]:
                        with lock:
                            per_tok.append(
                                body["timings"]["decode_ms"]
                                / len(body["tokens"]))
                    i += 1

            def flood_client(i):
                post_body(srv.url, {
                    "prompt_tokens": encode_prompt_tokens(
                        f"fl-{kind}-{i}", flood_prompt, 64),
                    "max_tokens": 1, "deadline_ms": 20000})

            dec_threads = [threading.Thread(target=decode_client,
                                            args=(c,), daemon=True)
                           for c in range(2)]
            for t in dec_threads:
                t.start()
            # Open-loop flood at ~2x the prefill plane's analytic
            # capacity: one flood request = ceil(96/8) chunk-steps,
            # each costing ~(step + slots*chunk*tok) at full
            # occupancy, over `slots` slots of one replica.
            steps_per_flood = -(-flood_prompt // chunk)
            step_wall = step_s + slots * chunk * tok_s
            cap = slots / max(steps_per_flood * step_wall, 1e-4)
            rate = 2.0 * cap
            n = int(rate * seconds)
            t0 = time.perf_counter()
            flood_threads = []
            for i in range(n):
                target = t0 + i / rate
                now = time.perf_counter()
                if target > now:
                    time.sleep(target - now)
                th = threading.Thread(target=flood_client, args=(i,),
                                      daemon=True)
                th.start()
                flood_threads.append(th)
            for th in flood_threads:
                th.join(timeout=60)
            stop.set()
            for t in dec_threads:
                t.join(timeout=60)
        finally:
            stop.set()
            srv.stop()
        for ex in execs:
            ex.allocator.assert_clean()
            ex.close()
        samples = sorted(per_tok)
        res = {
            "p99_ms_per_tok": (nearest_rank(samples, 0.99)
                               if samples else None),
            "p50_ms_per_tok": (nearest_rank(samples, 0.50)
                               if samples else None),
            "n_decode": len(samples),
            "flood_rate": rate,
        }
        if kind == "disagg":
            bt = reg.counter_value("serving_kv_transfer_bytes_total",
                                   {"codec": "fp32"}) or 0.0
            totals = reg.histogram_totals("serving_kv_transfer_seconds")
            ssum = sum(v[0] for v in totals.values())
            scnt = sum(v[1] for v in totals.values())
            res["transfers"] = scnt
            res["transfer_ms_mean"] = (1000.0 * ssum / scnt
                                       if scnt else None)
            res["transfer_bytes"] = bt
        return res

    arms = {kind: run_arm(kind) for kind in ("colocated", "disagg")}
    for kind, a in arms.items():
        p99, p50 = (round(a[k], 2) if a[k] is not None else None
                    for k in ("p99_ms_per_tok", "p50_ms_per_tok"))
        trace(f"disagg arm {kind}: decode p99 {p99} ms/tok "
              f"(p50 {p50}) over {a['n_decode']} requests, "
              f"flood @{a['flood_rate']:.0f}/s")
    dis, col = arms["disagg"], arms["colocated"]
    # A loaded box can starve one arm's decode clients for the whole
    # window (all 503/deadline): report what exists instead of
    # crashing the section out of the gated metric.
    if dis["p99_ms_per_tok"] is not None:
        out["serving_decode_p99_ms"] = round(dis["p99_ms_per_tok"], 3)
    if col["p99_ms_per_tok"] is not None:
        out["serving_colocated_decode_p99_ms"] = round(
            col["p99_ms_per_tok"], 3)
    if dis["p99_ms_per_tok"] and col["p99_ms_per_tok"]:
        out["serving_disagg_isolation_x"] = round(
            col["p99_ms_per_tok"] / dis["p99_ms_per_tok"], 2)
    out["serving_kv_transfers"] = dis["transfers"]
    if dis["transfer_ms_mean"]:
        out["serving_kv_transfer_ms"] = round(dis["transfer_ms_mean"],
                                              3)
        # Breakeven: what re-prefilling a FLOOD-sized context would
        # cost in this cost model vs shipping its pages.
        reprefill_ms = (-(-flood_prompt // chunk)
                        * (step_ms + chunk * tok_ms))
        out["serving_kv_transfer_breakeven_x"] = round(
            reprefill_ms / dis["transfer_ms_mean"], 1)

    # The page stream's wire throughput on a REALISTIC block payload
    # (16-token blocks, 8 heads x 128 d_head, int8 codes + scales —
    # ~2 MiB/plane for 64 blocks), loopback, import discarded: prices
    # the framing + codec path itself, not the serving plane around
    # it.
    spec = KVSpec(model="paged", block_size=16, heads=8, d_head=128,
                  vocab=64, max_blocks_per_req=64, pool_dtype="int8")
    gb_srv = KVPageStreamServer(spec, lambda meta, planes: {})
    try:
        st = KVPageStream(spec, gb_srv.addr)
        n_blocks = 64
        rng = __import__("numpy").random.RandomState(0)
        codes = rng.randint(-127, 127, size=(
            n_blocks, 16, 8, 128)).astype("int8")
        scales = rng.rand(n_blocks).astype("float32")
        meta = {"req": "bench", "n_blocks": n_blocks,
                "tokens": n_blocks * 16}
        wire_bytes = spec.wire_block_nbytes("int8") * n_blocks
        st.send_pages(meta, [(codes, scales), (codes, scales)])  # warm
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            st.send_pages(meta, [(codes, scales), (codes, scales)])
            walls.append(time.perf_counter() - t0)
        st.close()
        best = min(walls)
        out["serving_kv_transfer_gbps"] = round(
            wire_bytes * 8 / 1e9 / best, 3)
        trace(f"kv page stream: {wire_bytes / 1e6:.1f} MB in "
              f"{best * 1e3:.2f} ms = "
              f"{out['serving_kv_transfer_gbps']} Gb/s (loopback)")
    finally:
        gb_srv.close()
    return out


def speculative_decode(trace, slots: int = 4, n_req: int = 24,
                       toks: int = 16, step_ms: float = 2.0,
                       tok_ms: float = 0.05, k: int = 4,
                       accept: float = 0.75, repeats: int = 3) -> dict:
    """Section 13: speculative draft/verify decode vs the
    one-token baseline — ACCEPTED tokens/s/slot through the real
    ContinuousBatcher (queue preloaded, no HTTP), interleaved
    best-of-3. Cost model: SyntheticKVExecutor with a fixed per-step
    floor plus a per-planned-token cost, so a verify step really
    costs more than a one-token step (its window is k+1 wide) and
    the speedup is the honest ratio of that physics — fixed floor
    amortized over ~E[accepted+1] tokens — not a free lunch. The
    draft is the OracleDraft at a CONTROLLED per-position acceptance
    rate (`accept`), the dial the speculation acceptance criterion
    (>= 1.5x at the controlled rate) is stated against.

      * serving_spec_tokens_per_s — accepted tokens/s/slot, spec arm
        (gated >= 0.85x rolling median in bench.py);
      * serving_spec_baseline_tokens_per_s — the one-token
        pipelined arm on the same cost model;
      * serving_spec_speedup — the paired ratio (gated ABSOLUTE
        >= 1.5 in bench.py: the acceptance criterion itself);
      * serving_spec_accept_rate / serving_spec_tokens_per_step —
        the acceptance decomposition (realized rate: positions after
        a run's first miss count as rejected);
      * serving_spec_step_ms / serving_spec_baseline_step_ms — the
        per-step-cost decomposition (a verify step IS dearer; the
        win is tokens per step, and these two lines prove both
        halves)."""
    import time as _time

    from .api import GenerateRequest
    from .kvcache import SyntheticKVExecutor
    from .queue import AdmissionQueue
    from .scheduler import ContinuousBatcher
    from .spec import OracleDraft, SpecConfig

    out: dict = {}
    step_s, tok_s = step_ms / 1000.0, tok_ms / 1000.0
    prompt_len, vocab = 8, 64
    tok_total = n_req * toks

    def one_run(kind):
        spec = None
        if kind == "spec":
            spec = SpecConfig(OracleDraft(k=k, accept_rate=accept,
                                          vocab=vocab, target_seed=0),
                              k)
        ex = SyntheticKVExecutor(
            slots=slots, vocab=vocab, block_size=4, num_blocks=2048,
            max_blocks_per_req=16, prefill_chunk=8,
            step_time_s=step_s, token_time_s=tok_s,
            pipelined=kind == "baseline", spec=spec,
            prefix_cache=False)
        q = AdmissionQueue(max_depth=n_req + 1)
        b = ContinuousBatcher(ex, q)
        reqs = [GenerateRequest(
            prompt_vec=None, max_tokens=toks,
            deadline=_time.monotonic() + 600.0,
            prompt_tokens=[(3 * i + j) % vocab
                           for j in range(prompt_len)])
            for i in range(n_req)]
        for r in reqs:
            q.submit(r)
        t0 = _time.perf_counter()
        b.start()
        ok = all(r.wait(timeout=600) for r in reqs)
        wall = _time.perf_counter() - t0
        b.stop()
        if not ok or any(r.error for r in reqs):
            raise RuntimeError(next(
                (r.error for r in reqs if r.error), "request lost"))
        delivered = sum(len(r.tokens) for r in reqs)
        assert delivered == tok_total, (delivered, tok_total)
        stats = ex.kv_stats()
        steps = ex._step_no
        ex.allocator.assert_clean()
        ex.close()
        return (tok_total / slots) / wall, wall, steps, stats

    # Interleaved best-of-3: both arms share each rep's box weather,
    # the section-5/9 shared-box defense.
    best: dict = {}
    for rep in range(repeats):
        for kind in ("spec", "baseline"):
            rate, wall, steps, stats = one_run(kind)
            trace(f"spec-decode {kind} rep{rep}: {rate:.0f} accepted "
                  f"tok/s/slot over {steps} steps")
            if kind not in best or rate > best[kind][0]:
                best[kind] = (rate, wall, steps, stats)

    sp_rate, sp_wall, sp_steps, sp_stats = best["spec"]
    bl_rate, bl_wall, bl_steps, _ = best["baseline"]
    out["serving_spec_tokens_per_s"] = round(sp_rate, 1)
    out["serving_spec_baseline_tokens_per_s"] = round(bl_rate, 1)
    if bl_rate > 0:
        out["serving_spec_speedup"] = round(sp_rate / bl_rate, 2)
    out["serving_spec_accept_rate"] = sp_stats["spec_accept_rate"]
    out["serving_spec_tokens_per_step"] = sp_stats[
        "spec_tokens_per_step"]
    out["serving_spec_step_ms"] = round(sp_wall / sp_steps * 1000, 3)
    out["serving_spec_baseline_step_ms"] = round(
        bl_wall / bl_steps * 1000, 3)
    trace(f"speculative decode: {out['serving_spec_tokens_per_s']} "
          f"vs baseline {out['serving_spec_baseline_tokens_per_s']} "
          f"accepted tok/s/slot = "
          f"{out.get('serving_spec_speedup')}x at realized accept "
          f"rate {out['serving_spec_accept_rate']} "
          f"({out['serving_spec_tokens_per_step']} tok/verify-step; "
          f"step cost {out['serving_spec_step_ms']} vs "
          f"{out['serving_spec_baseline_step_ms']} ms)")
    return out


def pipelined_speculative_decode(trace, slots: int = 4,
                                 n_req: int = 16, toks: int = 32,
                                 step_ms: float = 2.0,
                                 tok_ms: float = 0.05,
                                 draft_ms: float = 2.8, k: int = 4,
                                 accept: float = 0.97,
                                 repeats: int = 3) -> dict:
    """Section 16: pipelined speculative decode vs the
    sync-spec loop vs the one-token pipelined loop — ACCEPTED
    tokens/s/slot through the real ContinuousBatcher, interleaved
    best-of-3. Cost model: the section-13 SyntheticKVExecutor physics
    (fixed per-step floor + per-planned-token cost) PLUS a priced
    draft — DelayDraft sleeps ``draft_ms`` per batched proposal on
    the batcher thread, the host-side compute a real draft model
    costs. The sync loop SERIALIZES that sleep behind every device
    step; the pipelined loop plans window w+1 (draft included) while
    window w's device step runs on the worker thread, so the draft
    cost hides under the device floor — and mis-speculated plan-ahead
    windows burn a device step each (the re-plan price), so the
    speedup is the honest net of overlap minus waste at the
    controlled acceptance rate.

      * serving_pspec_tokens_per_s — accepted tokens/s/slot,
        pipelined-spec arm (rolling-median gated in bench.py);
      * serving_pspec_sync_tokens_per_s — the sync-spec arm on
        the same cost model (same draft price);
      * serving_pspec_onetok_tokens_per_s — the one-token
        pipelined arm (no draft, no spec);
      * serving_pspec_speedup — pipelined-spec / sync-spec (gated
        ABSOLUTE >= 1.25 in bench.py: the pipelining criterion);
      * serving_pspec_speedup_vs_onetok — the compounded figure
        (~1.8-2x the one-token loop at the default dials);
      * serving_pspec_accept_rate / serving_pspec_replan_rate — the
        acceptance decomposition: realized accept rate and stale
        plan-ahead windows per verify run (the overlap's waste term);
      * serving_pspec_step_ms / _sync_step_ms / _onetok_step_ms —
        the per-step-cost decomposition (a pipelined step costs
        max(draft, device), a sync step their sum)."""
    import time as _time

    import numpy as np

    from .api import GenerateRequest
    from .kvcache import SyntheticKVExecutor
    from .queue import AdmissionQueue
    from .scheduler import ContinuousBatcher
    from .spec import OracleDraft, SpecConfig

    out: dict = {}
    step_s, tok_s = step_ms / 1000.0, tok_ms / 1000.0
    draft_s = draft_ms / 1000.0
    prompt_len, vocab = 8, 64
    tok_total = n_req * toks

    class DelayDraft:
        """OracleDraft with a priced proposal: one ``draft_ms`` sleep
        per batched draft call — propose() and the fused
        propose_full() each cost one window latency, the way a real
        draft model's single forward pass does."""

        def __init__(self, inner):
            self._inner = inner
            self.k = inner.k

        def propose(self, last, ctx):
            _time.sleep(draft_s)
            return self._inner.propose(last, ctx)

        def propose_full(self, last, ctx):
            _time.sleep(draft_s)
            p = np.asarray(self._inner.propose(last, ctx), np.int32)
            q = np.asarray(self._inner.propose(
                p[:, -1], np.asarray(ctx, np.int64) + self.k),
                np.int32)
            return np.concatenate([p, q[:, :1]], axis=1)

    def one_run(kind):
        spec = None
        if kind in ("pspec", "sspec"):
            spec = SpecConfig(DelayDraft(OracleDraft(
                k=k, accept_rate=accept, vocab=vocab,
                target_seed=0)), k)
        ex = SyntheticKVExecutor(
            slots=slots, vocab=vocab, block_size=4, num_blocks=2048,
            max_blocks_per_req=16, prefill_chunk=8,
            step_time_s=step_s, token_time_s=tok_s,
            pipelined=kind in ("pspec", "onetok"), spec=spec,
            prefix_cache=False)
        q = AdmissionQueue(max_depth=n_req + 1)
        b = ContinuousBatcher(ex, q)
        reqs = [GenerateRequest(
            prompt_vec=None, max_tokens=toks,
            deadline=_time.monotonic() + 600.0,
            prompt_tokens=[(3 * i + j) % vocab
                           for j in range(prompt_len)])
            for i in range(n_req)]
        for r in reqs:
            q.submit(r)
        t0 = _time.perf_counter()
        b.start()
        ok = all(r.wait(timeout=600) for r in reqs)
        wall = _time.perf_counter() - t0
        b.stop()
        if not ok or any(r.error for r in reqs):
            raise RuntimeError(next(
                (r.error for r in reqs if r.error), "request lost"))
        delivered = sum(len(r.tokens) for r in reqs)
        assert delivered == tok_total, (delivered, tok_total)
        stats = ex.kv_stats()
        steps = ex._step_no
        ex.allocator.assert_clean()
        ex.close()
        return (tok_total / slots) / wall, wall, steps, stats

    # Interleaved best-of-3: all three arms share each rep's box
    # weather, the section-5/9/13 shared-box defense.
    best: dict = {}
    for rep in range(repeats):
        for kind in ("pspec", "sspec", "onetok"):
            rate, wall, steps, stats = one_run(kind)
            trace(f"pipelined-spec {kind} rep{rep}: {rate:.0f} "
                  f"accepted tok/s/slot over {steps} steps")
            if kind not in best or rate > best[kind][0]:
                best[kind] = (rate, wall, steps, stats)

    pp_rate, pp_wall, pp_steps, pp_stats = best["pspec"]
    sy_rate, sy_wall, sy_steps, _ = best["sspec"]
    ot_rate, ot_wall, ot_steps, _ = best["onetok"]
    out["serving_pspec_tokens_per_s"] = round(pp_rate, 1)
    out["serving_pspec_sync_tokens_per_s"] = round(sy_rate, 1)
    out["serving_pspec_onetok_tokens_per_s"] = round(ot_rate, 1)
    if sy_rate > 0:
        out["serving_pspec_speedup"] = round(pp_rate / sy_rate, 2)
    if ot_rate > 0:
        out["serving_pspec_speedup_vs_onetok"] = round(
            pp_rate / ot_rate, 2)
    out["serving_pspec_accept_rate"] = pp_stats["spec_accept_rate"]
    runs = max(1, pp_stats["spec_verify_steps"])
    out["serving_pspec_replan_rate"] = round(
        pp_stats["spec_replans"] / runs, 3)
    out["serving_pspec_step_ms"] = round(
        pp_wall / pp_steps * 1000, 3)
    out["serving_pspec_sync_step_ms"] = round(
        sy_wall / sy_steps * 1000, 3)
    out["serving_pspec_onetok_step_ms"] = round(
        ot_wall / ot_steps * 1000, 3)
    trace(f"pipelined spec: {out['serving_pspec_tokens_per_s']} vs "
          f"sync-spec {out['serving_pspec_sync_tokens_per_s']} vs "
          f"one-token {out['serving_pspec_onetok_tokens_per_s']} "
          f"accepted tok/s/slot = {out.get('serving_pspec_speedup')}x "
          f"over sync spec "
          f"({out.get('serving_pspec_speedup_vs_onetok')}x over "
          f"one-token; replan rate "
          f"{out['serving_pspec_replan_rate']}/run; step cost "
          f"{out['serving_pspec_step_ms']} vs "
          f"{out['serving_pspec_sync_step_ms']} vs "
          f"{out['serving_pspec_onetok_step_ms']} ms)")
    return out


def sharded_decode(slots: int, trace, world: int = 3, n_req: int = 48,
                   toks: int = 16, step_ms: float = 2.0,
                   coll_ms: float = 1.0, repeats: int = 3, *,
                   device=None) -> dict:
    """Section 9: one replica sharded across `world` shard
    workers vs the same decode single-host, through the REAL
    ContinuousBatcher (queue preloaded, no HTTP). The shard plane is
    the SyntheticShardSet with a fixed per-shard compute cost and a
    fixed modelled collective cost — the deterministic cost model, so
    the figures regress on coordinator/scheduler changes (broadcast
    fan-out, collect gather, pipelined overlap) and nothing else.

    serving_sharded_steps_per_s is USEFUL steps/s (decoded tokens ÷
    slots per second — hand-off steps count against it, same
    definition as section 5). serving_shard_collective_frac is the
    share of the best run's wall the step spent inside the collective
    (sum of per-step slowest-shard collective time / wall): with a
    preloaded queue the shard plane is near-saturated, so the ratio
    is the decode decomposition, not an idle-time artifact.

    With overlap: the sharded arm runs TWICE per rep — overlap ON
    (forward_overlapped's double-buffered block schedule; the gated
    collective frac, which counts only the NON-HIDDEN wait) and
    overlap OFF (the serialized loop; the `_off` twins) — interleaved
    so the on-vs-off comparison is a paired best-of-3."""
    import time as _time

    from ..utils.metrics import Registry
    from .api import GenerateRequest, encode_prompt
    from .executor import SyntheticExecutor
    from .queue import AdmissionQueue
    from .scheduler import ContinuousBatcher
    from .sharded import FabricExecutor, SyntheticShardSet

    out: dict = {}
    d = 16
    tok_total = n_req * toks
    step_s, coll_s = step_ms / 1000.0, coll_ms / 1000.0

    def one_run(kind):
        reg = Registry()
        if kind in ("sharded", "sharded-off"):
            # "sharded" = overlap ON (forward_overlapped's double-
            # buffered block schedule — the headline arm); "sharded-
            # off" = the serialized partial→reduce→finish loop, kept
            # as the paired comparison the overlap claim is made
            # against.
            ex = FabricExecutor(
                SyntheticShardSet(world=world, slots=slots, d=d,
                                  seed=7, step_time_s=step_s,
                                  collective_time_s=coll_s,
                                  overlap=(kind == "sharded"),
                                  device=device),
                mode="pipelined", registry=reg, name="bench")
        else:
            # The single-host twin pays the compute but no collective
            # — the delta is the fabric tax at this cost model.
            ex = SyntheticExecutor(slots=slots, d=d, seed=7,
                                   step_time_s=step_s, pipelined=True)
        q = AdmissionQueue(max_depth=n_req + 1)
        b = ContinuousBatcher(ex, q, registry=reg)
        reqs = [GenerateRequest(
            prompt_vec=encode_prompt(f"sh-{i}", d),
            max_tokens=toks, deadline=_time.monotonic() + 600.0)
            for i in range(n_req)]
        for r in reqs:
            q.submit(r)
        t0 = _time.perf_counter()
        b.start()
        ok = all(r.wait(timeout=600) for r in reqs)
        wall = _time.perf_counter() - t0
        b.stop()
        ex.close()
        if not ok or any(r.error for r in reqs):
            raise RuntimeError(next(
                (r.error for r in reqs if r.error), "request lost"))
        return (tok_total / slots) / wall, wall, reg

    # No warm-up arm: every run constructs its own executor/shard set
    # (spawns included in its wall), so runs are iid and best-of-N
    # already discards any first-call python/allocator cold cost. The
    # three arms run INTERLEAVED so overlap-on vs overlap-off is a
    # paired best-of-3 (the overlap acceptance comparison), same
    # shared-box defense as section 5.
    best: dict = {}
    for rep in range(repeats):
        for kind in ("sharded", "sharded-off", "local"):
            rate, wall, reg = one_run(kind)
            trace(f"sharded-decode {kind} rep{rep}: {rate:.0f} "
                  f"useful steps/s")
            if kind not in best or rate > best[kind][0]:
                best[kind] = (rate, wall, reg)

    def coll_frac(kind):
        rate, wall, reg = best[kind]
        coll = reg.histogram_totals("serving_shard_collective_seconds")
        return sum(s for s, _ in coll.values()) / wall

    # Headline steps/s: the FASTER sharded configuration. The overlap
    # win is payload- and box-dependent (at the synthetic plane's ms
    # scale, per-block thread handoffs on a 2-cpu box can cost more
    # than the compute they hide; on the real ring the hidden time is
    # socket time), so the headline tracks what an operator would
    # deploy, and both arms stay in the artifact.
    sh_rate = max(best["sharded"][0], best["sharded-off"][0])
    sh_reg = best["sharded"][2]
    out["serving_sharded_steps_per_s"] = round(sh_rate, 1)
    out["serving_sharded_tok_per_s"] = round(sh_rate * slots, 1)
    # The gated collective fraction is the OVERLAP-ON arm's: under
    # overlap the executor observes only the non-hidden wait, so the
    # figure is "what the fabric still costs after hiding" — creep
    # means the overlap schedule is rotting back toward serialized.
    # The acceptance comparison (overlap lowers the blocked fraction)
    # is the _off twin next to it, from the same paired best-of-3.
    out["serving_shard_collective_frac"] = round(coll_frac("sharded"),
                                                 3)
    out["serving_shard_collective_frac_off"] = round(
        coll_frac("sharded-off"), 3)
    out["serving_sharded_steps_per_s_overlap"] = round(
        best["sharded"][0], 1)
    out["serving_sharded_steps_per_s_off"] = round(
        best["sharded-off"][0], 1)
    if best["sharded-off"][0] > 0:
        out["serving_shard_overlap_speedup"] = round(
            best["sharded"][0] / best["sharded-off"][0], 2)
    skew = sh_reg.histogram_totals("serving_shard_step_skew_seconds")
    skew_sum = sum(s for s, _ in skew.values())
    skew_n = sum(n for _, n in skew.values())
    if skew_n:
        out["serving_shard_step_skew_ms"] = round(
            skew_sum / skew_n * 1000, 3)
    if best["local"][0] > 0:
        out["serving_sharded_vs_local_frac"] = round(
            sh_rate / best["local"][0], 3)
    trace(f"sharded decode: {out['serving_sharded_steps_per_s']} "
          f"useful steps/s over {world} shards, collective frac "
          f"{out['serving_shard_collective_frac']} (overlap off "
          f"{out['serving_shard_collective_frac_off']}), vs local "
          f"{out.get('serving_sharded_vs_local_frac')}x")
    return out


def paged_attn_equiv_lane(kernel: str, device, steps: int = 4):
    """Section 11's equivalence lane: ``steps`` steps of one
    ``PagedDecodeStep`` with int8 pools at reduced shapes (2 slots, vocab
    32, d 16, 2 heads, blocks of 4, 32 blocks, 4 a request, chunk 4, seed
    5): a 4-token prefill, then single tokens, host-fed from
    ``RandomState(11)`` -- the reference's lane, token for token.
    ``kernel`` is ``"cuda"`` (the hand-written kernel; a CUDA
    ``device``) or ``"torch"`` (its plain version). Returns (tokens, a
    list of ``steps`` lists of the slots' tokens; pools, the four pool
    arrays (kpool, kscale, vpool, vscale) as numpy)."""
    import numpy as np
    import torch

    from .kvcache.paged import PagedDecodeStep

    small = dict(slots=2, vocab=32, d=16, heads=2, block_size=4,
                 num_blocks=32, max_blocks_per_req=4, chunk=4, seed=5)
    st = PagedDecodeStep(kernel=kernel, pool_dtype="int8", device=device,
                         **small)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(st.device)

    p = st.init_pools()
    prev = st.init_prev()
    tables = on_dev(np.arange(8, dtype=np.int32).reshape(2, 4))
    ctx = np.zeros((2,), np.int32)
    rng = np.random.RandomState(11)
    emitted = []
    for stepno in range(steps):
        host = rng.randint(0, 32, size=(2, 4)).astype(np.int32)
        n_new = np.full((2,), 4 if stepno == 0 else 1, np.int32)
        use_host = np.ones((2,), bool)
        r = st(*p, prev, on_dev(host), on_dev(use_host), on_dev(ctx),
               on_dev(n_new), tables)
        p, tok = r[:4], r[4]
        ctx = ctx + n_new
        prev = tok
        emitted.append(tok.cpu().numpy().tolist())
    return emitted, [a.cpu().numpy() for a in p]


def paged_attn_bench(trace, iters: int = 40, repeats: int = 3, *,
                     dims: Optional[dict] = None, device=None) -> dict:
    """Section 11, fused paged attention and quantized KV residency.

    Times ONE PagedDecodeStep step (embed → append → paged attention
    → logits, synchronized — pure device wall, no scheduler) at
    steady-state full-slot decode over the arms below on the same
    shapes (``dims``; default the reference's: 4 slots, vocab 256, d 64,
    4 heads, blocks of 16, 256 blocks, 16 a request, chunk 8, seed 3),
    each the wall of ``iters`` steps after one warm step, best of
    ``repeats``:

      * ``serving_paged_attn_device_ms`` — the DEPLOYED kernel's
        per-step time: the hand-written CUDA kernel on a CUDA
        ``device``, its plain PyTorch version on the CPU.
      * ``serving_paged_attn_torch_ms`` / ``_cuda_ms`` — the
        decomposition pair (``_cuda_ms`` only on a CUDA device).
      * ``serving_paged_attn_fp32_ms`` — the fp32-resident twin on the
        plain arm: the dtype half of the decomposition (int8 reads 4x
        fewer pool bytes per gather).

    On a CUDA device ``serving_paged_attn_equiv_ok`` records the kernel
    against its plain version on the card at reduced shapes
    (``paged_attn_equiv_lane``: bitwise pools, identical argmax
    tokens). On the CPU there is no kernel, and no such key.

    Residency accounting rides along: ``serving_kv_bytes_per_slot``
    (int8 resident layout), its fp32 twin, and
    ``serving_kv_bytes_reduction`` (the reference's bench.py holds it
    ABSOLUTE at >= 3.5x)."""
    import time as _time

    import numpy as np
    import torch

    from ..device import resolve_device
    from .kvcache.paged import PagedDecodeStep, kv_bytes_per_slot

    dev = resolve_device(device, "paged_attn_bench")
    on_cuda = dev.type == "cuda"
    if dims is None:
        dims = dict(slots=4, vocab=256, d=64, heads=4, block_size=16,
                    num_blocks=256, max_blocks_per_req=16, chunk=8, seed=3)
    out: dict = {}

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    def steady_plan(step_obj):
        """Full-occupancy decode plan: every slot mid-decode with a
        half-full table — the shape the decode hot path actually
        runs."""
        S, C = step_obj.slots, step_obj.chunk
        B, bs = step_obj.max_blocks_per_req, step_obj.block_size
        rng = np.random.RandomState(7)
        tables = np.arange(S * B, dtype=np.int32).reshape(S, B)
        ctx = np.full((S,), (B // 2) * bs, np.int32)
        n_new = np.ones((S,), np.int32)
        host = rng.randint(0, step_obj.vocab,
                           size=(S, C)).astype(np.int32)
        use_host = np.ones((S,), bool)
        return (step_obj.init_prev(), on_dev(host), on_dev(use_host),
                on_dev(ctx), on_dev(n_new), on_dev(tables))

    def time_arm(kernel, pool_dtype):
        st = PagedDecodeStep(kernel=kernel, pool_dtype=pool_dtype,
                             device=dev, **dims)
        pools = st.init_pools()
        prev, host, use_host, ctx, n_new, tables = steady_plan(st)
        best = float("inf")
        for _ in range(repeats):
            # Warm one step, then time the loop; the step updates the
            # pools in place and returns them.
            p = st(*pools, prev, host, use_host, ctx, n_new, tables)
            pools, tok = p[:4], p[4]
            sync()
            t0 = _time.perf_counter()
            for _ in range(iters):
                p = st(*pools, prev, host, use_host, ctx, n_new,
                       tables)
                pools, tok = p[:4], p[4]
            sync()
            best = min(best,
                       (_time.perf_counter() - t0) / iters * 1000.0)
        return best

    torch_ms = time_arm("torch", "int8")
    fp32_ms = time_arm("torch", "fp32")
    out["serving_paged_attn_torch_ms"] = round(torch_ms, 3)
    out["serving_paged_attn_fp32_ms"] = round(fp32_ms, 3)
    if on_cuda:
        cuda_ms = time_arm("cuda", "int8")
        out["serving_paged_attn_cuda_ms"] = round(cuda_ms, 3)
        # The headline tracks the DEPLOY-DEFAULT kernel — on a CUDA
        # device unconditionally the hand-written one (PagedDecodeStep's
        # kernel=None), NOT min(cuda, torch): a kernel-only regression
        # must move the figure, and the recorded pair carries the
        # comparison.
        out["serving_paged_attn_device_ms"] = round(cuda_ms, 3)
        out["serving_paged_attn_kernel"] = "cuda"
        # Correctness beside speed: the kernel against its plain
        # version on the card at reduced shapes.
        toks, pools = {}, {}
        for kern in ("torch", "cuda"):
            toks[kern], pools[kern] = paged_attn_equiv_lane(kern, dev)
        out["serving_paged_attn_equiv_ok"] = bool(
            toks["torch"] == toks["cuda"] and all(
                np.array_equal(a, b) for a, b in zip(pools["torch"],
                                                     pools["cuda"])))
    else:
        out["serving_paged_attn_device_ms"] = round(torch_ms, 3)
        out["serving_paged_attn_kernel"] = "torch"

    d = dims
    dh = d["d"] // d["heads"]
    int8_bytes = kv_bytes_per_slot(d["max_blocks_per_req"],
                                   d["block_size"], d["heads"], dh,
                                   "int8")
    fp32_bytes = kv_bytes_per_slot(d["max_blocks_per_req"],
                                   d["block_size"], d["heads"], dh,
                                   "fp32")
    out["serving_kv_bytes_per_slot"] = int8_bytes
    out["serving_kv_bytes_per_slot_fp32"] = fp32_bytes
    out["serving_kv_bytes_reduction"] = round(fp32_bytes / int8_bytes,
                                              2)
    trace(f"paged-attn: {out['serving_paged_attn_kernel']} "
          f"{out['serving_paged_attn_device_ms']} ms/step (torch int8 "
          f"{out['serving_paged_attn_torch_ms']}, fp32 "
          f"{out['serving_paged_attn_fp32_ms']}, cuda "
          f"{out.get('serving_paged_attn_cuda_ms', 'n/a — cpu')}); "
          f"kv bytes/slot {int8_bytes} vs fp32 {fp32_bytes} = "
          f"{out['serving_kv_bytes_reduction']}x"
          + (f"; kernel vs plain equivalence "
             f"{'ok' if out['serving_paged_attn_equiv_ok'] else 'FAILED'}"
             if on_cuda else ""))
    return out


def sharded_kv_scaling(trace, slots: int = 2, n_req: int = 6,
                       toks: int = 8, repeats: int = 2, *,
                       dims: Optional[dict] = None, prompt_len: int = 12,
                       device=None) -> dict:
    """Section 14, context-parallel paged KV — what sharding the K/V
    pools across shard workers buys, in three measurements.

    1. Resident context per replica vs world (1, 2, 4): PURE KVSpec
       arithmetic from the blessed derivation site
       (``rank_resident_nbytes`` on the realistic paged-attention
       layout — 16-token blocks, 8 heads x 128 d_head, int8 codes +
       scales). Fix the per-worker HBM budget at what a single worker
       pins for a 4096-block pool, then size the largest replica pool
       whose WORST rank still fits that budget.
       serving_ctx_per_replica_scaling is the world-2/world-1 token
       ratio, taken as the MIN over both shard axes (page keeps full
       heads per block; head pays the unsharded per-block scale); the
       reference's bench.py holds it ABSOLUTE at >= 1.7. Arithmetic,
       not a timing: a layout regression is never box weather. The _w4
       twin is the linearity artifact.

    2. Measured decode: tokens/s and per-token p99 through the REAL
       ContinuousBatcher over ShardedPagedKVExecutor (page axis — the
       ring/long-context path; its ranks run the plain composition) at
       world 1/2/4 thread shards, paired interleaved with the
       single-worker PagedKVExecutor twin (the CUDA kernel on a CUDA
       ``device``) on the same ``dims`` (default the reference's tiny
       model; ``prompt_len``-token prompts), best-of-N:
       serving_shard_kv_tokens_per_s and serving_shard_kv_p99_ms at
       world 2, the twin's and world 1's and 4's beside them. At the
       default dims real attention compute is microseconds, so the
       sharded figure IS the coordinator hand-off + partial merge cost
       and the vs-single comparison (serving_shard_kv_p99_vs_single) is
       structurally >1x; at full width attention weighs in.

    3. Per-rank transfer decomposition: a sharded lease ships as
       ``world`` point-to-point sub-streams, each framed by its
       ``rank_view``. Loopback microbench with both rank streams
       CONCURRENT (the bandwidth-multiplication claim is parallelism
       of independent links): aggregate Gb/s across both links plus
       the per-rank figures."""
    import numpy as np

    from .api import GenerateRequest
    from .disagg import KVPageStream, KVPageStreamServer
    from .disagg.spec import KVSpec
    from .kvcache import PagedKVExecutor
    from .kvcache.sharded import ShardedPagedKVExecutor
    from .queue import AdmissionQueue
    from .scheduler import ContinuousBatcher

    out: dict = {}

    # -- 1: resident context per replica (KVSpec arithmetic) -------------
    layout = dict(model="paged", block_size=16, heads=8, d_head=128,
                  vocab=64, max_blocks_per_req=64, pool_dtype="int8")
    base_blocks = 4096
    budget = KVSpec(**layout).rank_resident_nbytes(0, base_blocks)

    def ctx_tokens(axis, world):
        if world == 1:
            return base_blocks * layout["block_size"]
        spec = KVSpec(**layout, shard_axis=axis, world=world)

        def fits(m):
            return all(spec.rank_resident_nbytes(r, m) <= budget
                       for r in range(world))

        lo, hi = world, 2 * world * base_blocks
        while lo < hi:  # largest pool whose worst rank fits the budget
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
        return lo * spec.block_size

    w1_tokens = ctx_tokens("none", 1)
    scal = {(axis, w): ctx_tokens(axis, w) / w1_tokens
            for axis in ("page", "head") for w in (2, 4)}
    out["serving_ctx_per_replica_scaling"] = round(
        min(scal[("page", 2)], scal[("head", 2)]), 3)
    out["serving_ctx_per_replica_scaling_w4"] = round(
        min(scal[("page", 4)], scal[("head", 4)]), 3)
    trace(f"sharded-kv context scaling: {w1_tokens} tokens/replica at "
          f"world 1 -> x{out['serving_ctx_per_replica_scaling']} at "
          f"world 2 (page {scal[('page', 2)]:.3f} / head "
          f"{scal[('head', 2)]:.3f}), "
          f"x{out['serving_ctx_per_replica_scaling_w4']} at world 4")

    # -- 2: measured decode vs world (real batcher, the port's paged
    # executors on ``device``) --------------------------------------------
    if dims is None:
        dims = dict(slots=slots, vocab=32, d=16, heads=2, block_size=4,
                    num_blocks=64, max_blocks_per_req=8, prefill_chunk=8,
                    seed=0)

    def one_run(world):
        # world 0 = the single-worker PagedKVExecutor twin (the CUDA
        # kernel on a CUDA device); otherwise the page-axis thread-shard
        # set (plain ranks; rep 0 pays each world's first-use costs once
        # and best-of-N discards them).
        if world == 0:
            ex = PagedKVExecutor(mode="pipelined", device=device, **dims)
        else:
            ex = ShardedPagedKVExecutor(world=world, shard_axis="page",
                                        mode="pipelined", device=device,
                                        **dims)
        q = AdmissionQueue(max_depth=n_req + 1)
        b = ContinuousBatcher(ex, q)
        reqs = [GenerateRequest(
            prompt_vec=None, max_tokens=toks,
            deadline=time.monotonic() + 600.0,
            prompt_tokens=[(5 * i + j) % dims["vocab"]
                           for j in range(prompt_len)])
            for i in range(n_req)]
        for r in reqs:
            q.submit(r)
        t0 = time.perf_counter()
        b.start()
        ok = all(r.wait(timeout=600) for r in reqs)
        wall = time.perf_counter() - t0
        b.stop()
        if not ok or any(r.error for r in reqs):
            raise RuntimeError(next(
                (r.error for r in reqs if r.error), "request lost"))
        ex.allocator.assert_clean()
        if world:
            assert ex.shards.outstanding() == 0
        ex.close()
        per_tok = sorted(
            (r.finished_at - r.admitted_at) * 1000.0 / len(r.tokens)
            for r in reqs)
        return n_req * toks / wall, nearest_rank(per_tok, 0.99)

    best: dict = {}
    for rep in range(repeats):
        for world in (0, 1, 2, 4):
            name = "single" if world == 0 else f"w{world}"
            rate, p99 = one_run(world)
            trace(f"sharded-kv decode {name} rep{rep}: {rate:.0f} "
                  f"tok/s, p99 {p99:.2f} ms/tok")
            if name not in best or rate > best[name][0]:
                best[name] = (rate, p99)

    out["serving_shard_kv_tokens_per_s"] = round(best["w2"][0], 1)
    out["serving_shard_kv_p99_ms"] = round(best["w2"][1], 3)
    out["serving_shard_kv_single_tokens_per_s"] = round(
        best["single"][0], 1)
    out["serving_shard_kv_single_p99_ms"] = round(best["single"][1], 3)
    out["serving_shard_kv_tokens_per_s_w1"] = round(best["w1"][0], 1)
    out["serving_shard_kv_tokens_per_s_w4"] = round(best["w4"][0], 1)
    if best["single"][1] > 0:
        out["serving_shard_kv_p99_vs_single"] = round(
            best["w2"][1] / best["single"][1], 2)
    trace(f"sharded-kv decode: world 2 "
          f"{out['serving_shard_kv_tokens_per_s']} tok/s at p99 "
          f"{out['serving_shard_kv_p99_ms']} ms/tok "
          f"({out.get('serving_shard_kv_p99_vs_single')}x the "
          f"single-worker twin)")

    # -- 3: per-rank transfer decomposition (concurrent loopback) --------
    spec = KVSpec(**layout, shard_axis="head", world=2)
    n_blocks, iters = 64, 3
    barrier = threading.Barrier(spec.world + 1)
    rank_res: dict = {}

    def pump(rank):
        rv = spec.rank_view(rank)
        srv = KVPageStreamServer(rv, lambda meta, planes: {})
        try:
            st = KVPageStream(rv, srv.addr)
            rng = np.random.RandomState(rank)
            codes = rng.randint(-127, 127, size=(
                n_blocks, rv.block_size, rv.heads,
                rv.d_head)).astype("int8")
            scales = rng.rand(n_blocks).astype("float32")
            meta = {"req": f"bench-r{rank}", "n_blocks": n_blocks,
                    "tokens": n_blocks * rv.block_size}
            planes = [(codes, scales), (codes, scales)]
            st.send_pages(meta, planes)  # warm (connect + first frame)
            barrier.wait()
            t0 = time.perf_counter()
            for _ in range(iters):
                st.send_pages(meta, planes)
            rank_res[rank] = (t0, time.perf_counter())
            st.close()
        finally:
            srv.close()

    threads = [threading.Thread(target=pump, args=(r,), daemon=True)
               for r in range(spec.world)]
    for t in threads:
        t.start()
    barrier.wait()
    for t in threads:
        t.join(timeout=60)
    rank_bytes = {r: spec.rank_wire_block_nbytes(r, "int8") * n_blocks
                  for r in range(spec.world)}
    if len(rank_res) == spec.world:
        # Aggregate over the union of the timed windows (close/shutdown
        # costs after a rank's last send don't count against the wire).
        agg_wall = (max(t1 for _, t1 in rank_res.values())
                    - min(t0 for t0, _ in rank_res.values()))
        out["serving_shard_kv_transfer_gbps"] = round(
            sum(rank_bytes.values()) * iters * 8 / 1e9 / agg_wall, 3)
        for r in range(spec.world):
            t0, t1 = rank_res[r]
            out[f"serving_shard_kv_transfer_rank{r}_gbps"] = round(
                rank_bytes[r] * iters * 8 / 1e9 / (t1 - t0), 3)
        trace(f"sharded-kv transfer: "
              f"{out['serving_shard_kv_transfer_gbps']} Gb/s aggregate "
              f"over {spec.world} concurrent rank streams (rank0 "
              f"{out['serving_shard_kv_transfer_rank0_gbps']}, rank1 "
              f"{out['serving_shard_kv_transfer_rank1_gbps']})")
    return out


def cluster_prefix(trace, n_tenants: int = 7, reqs_per_tenant: int = 8,
                   prefix_tokens: int = 24, suffix_tokens: int = 4,
                   max_tokens: int = 6, block_size: int = 4,
                   slots: int = 2, num_blocks: int = 28,
                   tier_budget_bytes: int = 640,
                   token_time_ms: float = 0.5) -> dict:
    """Section 15: the cluster-wide prefix cache — what
    prefix-aware routing + KV tiering buy over prefix-blind placement.

    Workload: ``n_tenants`` tenants, each with a shared
    ``prefix_tokens``-token system prompt and per-request unique
    suffixes — the multi-tenant shape where the same bytes get
    prefilled again and again. Capacity is the forcing function: HBM
    (``num_blocks``) holds in-flight work plus only ~2 resident
    chains, and the host tier (``tier_budget_bytes``) holds roughly
    HALF the tenant set's spilled chains — so a replica can keep the
    tenants it OWNS warm but not everybody's. The routed arm
    partitions tenants across replicas (each chain lives HBM-or-host
    on one owner); round-robin sprays every tenant across BOTH
    replicas, overflows both tiers, and the LRU drops chains that
    then re-prefill from scratch. ``n_tenants`` is deliberately odd:
    with an even tenant count a 2-replica round-robin degenerates
    into perfect parity affinity (tenant t -> replica t%2) and
    measures nothing.

    Two arms on identical machinery and identical request order:

      * routed  — PrefixRouter(policy="prefix"), gossip + affinity +
        the affinity-miss pull;
      * rr      — PrefixRouter(policy="round_robin"), same replicas,
        no scoring, no pulls.

    Headline (gated in bench.py): serving_prefix_hit_frac holds an
    ABSOLUTE floor AND serving_prefix_route_uplift_x (routed hit frac
    / rr hit frac) >= 1.5 — the prefix-cache acceptance; TTFT p99 is
    gated via serving_ttft_vs_rr_x <= 0.7 (absolute) plus a 1.35x
    rolling-median band on serving_ttft_p99_ms. The spill/restore/
    pull byte rates decompose where the moved bytes actually went."""
    from .api import GenerateRequest
    from .kvcache import SyntheticKVExecutor
    from .queue import AdmissionQueue
    from .router import PrefixRouter, RouterReplica
    from .scheduler import ContinuousBatcher
    from ..utils.metrics import Registry

    rng = __import__("numpy").random.RandomState(1717)
    vocab = 32
    tenant_prefix = [
        [int(t) for t in rng.randint(0, vocab, size=prefix_tokens)]
        for _ in range(n_tenants)]
    suffixes = [
        [[int(t) for t in rng.randint(0, vocab, size=suffix_tokens)]
         for _ in range(reqs_per_tenant)]
        for _ in range(n_tenants)]
    deadline = lambda: time.monotonic() + 120.0

    def mk_replica(name):
        ex = SyntheticKVExecutor(
            slots=slots, vocab=vocab, block_size=block_size,
            num_blocks=num_blocks, max_blocks_per_req=16,
            token_time_s=token_time_ms / 1000.0,
            host_tier_bytes=tier_budget_bytes)
        return RouterReplica(name, AdmissionQueue(max_depth=256), ex)

    def run_arm(policy):
        replicas = [mk_replica("a"), mk_replica("b")]
        reg = Registry()
        router = PrefixRouter(replicas, policy=policy, cadence_s=0.0,
                              max_load_skew=8, registry=reg)
        batchers = [ContinuousBatcher(r.executor, r.queue)
                    for r in replicas]
        for b in batchers:
            b.start()
        reqs = []
        steady = []
        t0 = time.monotonic()
        try:
            # Tenant-interleaved arrival, closed-loop per wave: the
            # next wave is routed against the gossip the last one
            # produced — submit-all-upfront would route every round
            # against an EMPTY board and measure only tie-breaks.
            for i in range(reqs_per_tenant):
                wave = []
                for t in range(n_tenants):
                    r = GenerateRequest(
                        prompt_vec=None, max_tokens=max_tokens,
                        deadline=deadline(),
                        prompt_tokens=(tenant_prefix[t]
                                       + suffixes[t][i]))
                    wave.append(r)
                    router.submit(r)
                for r in wave:
                    if not r.wait(timeout=120.0):
                        raise RuntimeError("bench request lost")
                reqs.extend(wave)
                # TTFT is a STEADY-STATE figure: wave 0 is the
                # unavoidable first-touch prefill in EITHER arm, and
                # with it in-sample p99 measures cold-start, not
                # placement. Hit-frac accounting keeps every wave.
                if i > 0:
                    steady.extend(wave)
        finally:
            for b in batchers:
                b.stop()
        wall = time.monotonic() - t0
        errs = [r.error for r in reqs if r.error]
        if errs:
            raise RuntimeError(f"{len(errs)} request(s) failed: "
                               f"{errs[0]}")
        ttfts = sorted(r.timings_ms()["ttft_ms"] for r in steady)
        hits = lookups = 0
        tier = {"spilled_bytes": 0, "restored_bytes": 0,
                "spilled_blocks": 0, "restored_blocks": 0,
                "corrupt_blocks": 0}
        for rep in replicas:
            st = rep.executor.kv_stats()
            hits += st["prefix_hit_tokens"]
            lookups += st["prefix_lookup_tokens"]
            for k in tier:
                tier[k] += st[f"tier_{k}"]
        pulls = dict(
            blocks=reg.counter_value(
                "serving_router_pulled_blocks_total") or 0.0,
            nbytes=reg.counter_value(
                "serving_router_pull_bytes_total") or 0.0,
            seconds=reg.counter_value(
                "serving_router_pull_seconds_total") or 0.0,
            failed=reg.counter_value(
                "serving_router_pull_failed_total") or 0.0)
        # Teardown hygiene: the bench enforces the same two-ledger
        # contract the tests do — a leak here is a real leak.
        for rep in replicas:
            rep.executor.prefix.flush()
            rep.executor.allocator.assert_clean()
            rep.executor.tier.assert_clean()
        router.close()
        for rep in replicas:
            rep.executor.close()
        return dict(wall=wall, ttfts=ttfts,
                    hit_frac=hits / max(1, lookups), tier=tier,
                    pulls=pulls, n=len(reqs))

    out: dict = {}
    routed = run_arm("prefix")
    rr = run_arm("round_robin")

    out["serving_prefix_hit_frac"] = round(routed["hit_frac"], 4)
    out["serving_prefix_hit_frac_rr"] = round(rr["hit_frac"], 4)
    out["serving_prefix_route_uplift_x"] = round(
        routed["hit_frac"] / max(1e-9, rr["hit_frac"]), 3)
    p99 = lambda xs: nearest_rank(xs, 0.99)
    out["serving_ttft_p99_ms"] = round(p99(routed["ttfts"]), 3)
    out["serving_ttft_p99_rr_ms"] = round(p99(rr["ttfts"]), 3)
    out["serving_ttft_vs_rr_x"] = round(
        out["serving_ttft_p99_ms"]
        / max(1e-9, out["serving_ttft_p99_rr_ms"]), 3)
    out["serving_cluster_reqs"] = routed["n"]
    out["serving_tier_spilled_blocks"] = routed["tier"][
        "spilled_blocks"]
    out["serving_tier_restored_blocks"] = routed["tier"][
        "restored_blocks"]
    out["serving_router_pulled_blocks"] = int(routed["pulls"]["blocks"])
    out["serving_router_pull_failed"] = int(routed["pulls"]["failed"])
    if routed["pulls"]["seconds"] > 0:
        out["serving_router_pull_gbps"] = round(
            routed["pulls"]["nbytes"] * 8
            / routed["pulls"]["seconds"] / 1e9, 4)

    # Spill/restore bandwidth micro (same tier machinery, timed in
    # isolation — the arm runs interleave spills with decode, so their
    # rate is not separable there). Synthetic pool planes are tiny;
    # the figure tracks the tier's per-block overhead, and real-pool
    # byte rates ride the disagg section's stream numbers.
    ex = SyntheticKVExecutor(slots=2, vocab=vocab,
                             block_size=block_size, num_blocks=64,
                             max_blocks_per_req=16,
                             host_tier_bytes=8 << 20)
    try:
        q = AdmissionQueue(max_depth=4)
        b = ContinuousBatcher(ex, q)
        long_prompt = [int(t) for t in rng.randint(0, vocab, size=56)]
        r = GenerateRequest(prompt_vec=None, max_tokens=4,
                            deadline=deadline(),
                            prompt_tokens=long_prompt)
        q.submit(r)
        b.start()
        try:
            if not r.wait(timeout=60.0):
                raise RuntimeError("bench request lost")
        finally:
            b.stop()
        t0 = time.perf_counter()
        ex.prefix.evict(99)
        spill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        blocks, cached = ex.kv_match_prefix(long_prompt, "bw")
        restore_s = time.perf_counter() - t0
        ex.allocator.release(blocks, "bw")
        st = ex.tier.stats()
        if spill_s > 0 and st["spilled_bytes"]:
            out["serving_tier_spill_gbps"] = round(
                st["spilled_bytes"] * 8 / spill_s / 1e9, 4)
        if restore_s > 0 and st["restored_bytes"]:
            out["serving_tier_restore_gbps"] = round(
                st["restored_bytes"] * 8 / restore_s / 1e9, 4)
        ex.prefix.flush()
        ex.allocator.assert_clean()
        ex.tier.assert_clean()
    finally:
        ex.close()

    trace(f"cluster-prefix: hit {out['serving_prefix_hit_frac']} vs "
          f"rr {out['serving_prefix_hit_frac_rr']} "
          f"(uplift {out['serving_prefix_route_uplift_x']}x), ttft "
          f"p99 {out['serving_ttft_p99_ms']} vs "
          f"{out['serving_ttft_p99_rr_ms']} ms "
          f"({out['serving_ttft_vs_rr_x']}x), pulled "
          f"{out['serving_router_pulled_blocks']} block(s)")
    return out


def multi_tenant_qos(trace, slots: int = 4, step_ms: float = 2.0,
                     good_rate: float = 40.0, flood_x: float = 10.0,
                     seconds: float = 2.0,
                     flood_budget_rate: float = 40.0,
                     prompt_tokens: int = 16, good_tokens: int = 16,
                     flood_tokens: int = 16,
                     burst_n: int = 24, reps: int = 3) -> dict:
    """Section 17: trace-driven open-loop multi-tenant QoS
    on the paged-KV plane.

    One submission thread walks a precomputed arrival schedule into
    the AdmissionQueue (a "trace", in the request-log sense) and the
    requests settle through a real kv-mode ContinuousBatcher —
    latency is stamped server-side (arrival -> finished_at), so the
    figures move on admission/preemption regressions, never on bench
    client threads. SyntheticKVExecutor with a fixed per-step cost is
    the accelerator model; the host tier is armed so preemption has
    somewhere to park.

    Two claims, each its own arm pair:

      * isolation — the good tenant's interactive p99 with an
        adversarial tenant submitting batch-class work at ``flood_x``
        its rate vs the same schedule alone.
        ``serving_tenant_p99_isolation`` is the contended/solo ratio,
        gated ABSOLUTE (<= 1.35) in bench.py. Three mechanisms carry
        it: the flood's token bucket sheds most of its arrivals
        (429s it pays for itself), strict priority pops interactive
        ahead of every queued flood, and — the QoS plane's own addition —
        KV-aware preemption parks a batch occupant the moment an
        interactive arrival finds every slot full, so the tail never
        waits out a flood request's full decode.
        ``serving_tenant_preemptions`` rides along: the gate passing
        WITHOUT parks would mean the test stopped exercising the
        mechanism. Each arm runs ``reps`` times and reports its BEST
        p99 — OS scheduler jitter only ever inflates a wall-clock
        tail, so the minimum over repetitions is the estimator
        closest to the arm's true p99 and keeps an absolute gate from
        flaking on a noisy host.
      * burst recovery — ``burst_n`` batch-class requests land at
        once on a quiet batcher; sequential interactive probes
        measure how long until latency returns under 2x the
        pre-burst baseline. ``serving_burst_recovery_ms`` rides the
        1.35x rolling-median band in bench.py (first-run-safe: no
        history, no gate).
    """
    import numpy as _np

    from .api import GenerateRequest, ServingError
    from .kvcache import SyntheticKVExecutor
    from .queue import AdmissionQueue, TenantBudget
    from .scheduler import ContinuousBatcher

    step_s = step_ms / 1000.0
    vocab = 32
    rng = _np.random.RandomState(2020)
    out: dict = {}

    def mk_req(tenant, priority, max_tokens):
        return GenerateRequest(
            prompt_vec=None, max_tokens=max_tokens,
            deadline=time.monotonic() + 30.0,
            prompt_tokens=[int(t) for t in
                           rng.randint(0, vocab, size=prompt_tokens)],
            tenant=tenant, priority=priority)

    def mk_plane():
        # prefill_budget covers every occupant's chunk in one step so
        # a flood prefill can delay a good-tenant prefill only through
        # slot occupancy (which preemption resolves), not by
        # serializing the chunk queue.
        ex = SyntheticKVExecutor(
            slots=slots, vocab=vocab, block_size=4, num_blocks=256,
            max_blocks_per_req=16, prefill_chunk=8,
            prefill_budget=8 * slots,
            step_time_s=step_s, host_tier_bytes=1 << 20)
        q = AdmissionQueue(
            max_depth=max(64, 4 * slots),
            tenants={"good": TenantBudget(weight=4.0),
                     "flood": TenantBudget(rate=flood_budget_rate,
                                           burst=8.0, weight=1.0)})
        return ex, q, ContinuousBatcher(ex, q)

    def run_arm(with_flood):
        ex, q, b = mk_plane()
        # The arrival trace: (t_offset, tenant) merged in time order.
        sched = [(i / good_rate, "good")
                 for i in range(int(good_rate * seconds))]
        if with_flood:
            fr = flood_x * good_rate
            sched += [(i / fr, "flood")
                      for i in range(int(fr * seconds))]
        sched.sort()
        good, sheds, flood_n = [], 0, 0
        b.start()
        t0 = time.perf_counter()
        try:
            for t_at, tenant in sched:
                dt = t0 + t_at - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)
                if tenant == "good":
                    r = mk_req("good", "interactive", good_tokens)
                    q.submit(r)
                    good.append(r)
                else:
                    flood_n += 1
                    try:
                        q.submit(mk_req("flood", "batch",
                                        flood_tokens))
                    except ServingError:
                        sheds += 1  # 429/503: the flood pays itself
            for r in good:
                if not r.wait(timeout=30.0):
                    raise RuntimeError("good-tenant request lost")
                if r.error is not None:
                    raise RuntimeError(f"good-tenant request failed: "
                                       f"{r.error}")
        finally:
            b.stop()
        lat = sorted(r.timings_ms()["total_ms"] for r in good)
        stats = dict(p99=nearest_rank(lat, 0.99),
                     preempted=ex.preempted_total,
                     resumed=ex.preempt_resumed_total,
                     shed_frac=sheds / max(1, flood_n))
        ex.prefix.flush()
        ex.tier.flush()
        ex.allocator.assert_clean()
        ex.tier.assert_clean()
        ex.close()
        return stats

    solos = [run_arm(with_flood=False) for _ in range(reps)]
    conts = [run_arm(with_flood=True) for _ in range(reps)]
    solo_p99 = min(s["p99"] for s in solos)
    cont_p99 = min(c["p99"] for c in conts)
    out["serving_tenant_p99_solo_ms"] = round(solo_p99, 3)
    out["serving_tenant_p99_contended_ms"] = round(cont_p99, 3)
    out["serving_tenant_p99_isolation"] = round(
        cont_p99 / max(1e-9, solo_p99), 3)
    out["serving_tenant_flood_shed_frac"] = round(
        sum(c["shed_frac"] for c in conts) / len(conts), 3)
    out["serving_tenant_preemptions"] = sum(
        c["preempted"] for c in conts)

    # Burst recovery: quiet batcher, pre-burst probe baseline, then a
    # batch-class wall of work and sequential interactive probes until
    # latency settles back under 2x the baseline.
    ex, q, b = mk_plane()
    b.start()
    try:
        def probe():
            r = mk_req("good", "interactive", good_tokens)
            q.submit(r)
            if not r.wait(timeout=30.0) or r.error is not None:
                raise RuntimeError(f"probe failed: {r.error}")
            return r.timings_ms()["total_ms"]

        base = sorted(probe() for _ in range(8))
        base_med = base[len(base) // 2]
        burst = [mk_req("good", "batch", flood_tokens)
                 for _ in range(burst_n)]
        t_burst = time.perf_counter()
        for r in burst:
            q.submit(r)
        recovery_ms = None
        while time.perf_counter() - t_burst < 10.0:
            if probe() <= 2.0 * base_med:
                recovery_ms = (time.perf_counter() - t_burst) * 1000
                break
        if recovery_ms is None:
            raise RuntimeError("burst never recovered inside 10s")
        for r in burst:
            r.wait(timeout=30.0)
        out["serving_burst_recovery_ms"] = round(recovery_ms, 3)
    finally:
        b.stop()
    ex.prefix.flush()
    ex.tier.flush()
    ex.allocator.assert_clean()
    ex.tier.assert_clean()
    ex.close()

    trace(f"multi-tenant qos: good p99 "
          f"{out['serving_tenant_p99_contended_ms']} ms contended vs "
          f"{out['serving_tenant_p99_solo_ms']} ms solo = "
          f"{out['serving_tenant_p99_isolation']}x (flood shed "
          f"{out['serving_tenant_flood_shed_frac']}, "
          f"{out['serving_tenant_preemptions']} preemption(s)); "
          f"burst recovery {out['serving_burst_recovery_ms']} ms")
    return out


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--step-ms", type=float, default=4.0,
                    help="fixed per-step executor cost (the accelerator "
                         "cost model)")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--per-client", type=int, default=3)
    ap.add_argument("--max-tokens", type=int, default=32)
    ap.add_argument("--overload-x", type=float, default=2.0)
    ap.add_argument("--overload-seconds", type=float, default=3.0)
    ap.add_argument("--overload-deadline-ms", type=float, default=2000.0)
    ap.add_argument("--skip-local", action="store_true",
                    help="skip the model sections (4, 5, 7, 11, 14)")
    ap.add_argument("--decode-reqs", type=int, default=64)
    ap.add_argument("--decode-tokens", type=int, default=32)
    ap.add_argument("--decode-S", type=int, default=2)
    ap.add_argument("--decode-d", type=int, default=64)
    ap.add_argument("--decode-h", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="where the sections run (default: the CUDA "
                         "card; 'cpu' runs them on the CPU)")
    args = ap.parse_args(argv)

    import torch

    if args.device is None and not torch.cuda.is_available():
        print("bench_serving: no CUDA device; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 2
    device = args.device or "cuda"

    from .executor import SyntheticExecutor
    from .server import ServingServer

    def trace(msg):
        print(f"bench_serving: {msg}", file=sys.stderr, flush=True)

    out: dict = {}
    step_s = args.step_ms / 1000.0

    # 1+2: closed-loop, continuous vs serial, same fixed step cost.
    mk = lambda slots: ServingServer(
        [SyntheticExecutor(slots=slots, d=16, step_time_s=step_s)],
        max_queue_depth=max(64, 4 * args.clients)).start()
    cont, serial = mk(args.slots), mk(1)
    try:
        closed_loop(cont.url, 2, 2, 2)
        closed_loop(serial.url, 2, 2, 2)
        wall, lat, codes = closed_loop(
            cont.url, args.clients, args.per_client, args.max_tokens)
        n_ok = sum(1 for c in codes if c == 200)
        q = _quantiles(lat)
        out.update(
            serving_reqs_per_s=round(n_ok / wall, 2),
            serving_tok_per_s=round(n_ok * args.max_tokens / wall, 1),
            serving_p50_ms=q["p50"], serving_p95_ms=q["p95"],
            serving_p99_ms=q["p99"])
        trace(f"continuous: {out['serving_reqs_per_s']} req/s "
              f"p99={q['p99']} ms over {n_ok} reqs")

        wall_s, lat_s, codes_s = closed_loop(
            serial.url, args.clients, args.per_client, args.max_tokens)
        n_ok_s = sum(1 for c in codes_s if c == 200)
        out["serving_serial_reqs_per_s"] = round(n_ok_s / wall_s, 2)
        if out["serving_serial_reqs_per_s"]:
            out["serving_batching_speedup"] = round(
                out["serving_reqs_per_s"]
                / out["serving_serial_reqs_per_s"], 2)
        trace(f"serial: {out['serving_serial_reqs_per_s']} req/s → "
              f"speedup {out.get('serving_batching_speedup')}x")
    finally:
        cont.stop()
        serial.stop()

    # 3: open-loop overload at ~2x the measured closed-loop capacity,
    # queue barely deeper than the batch — the shed-don't-park test.
    ov = ServingServer(
        [SyntheticExecutor(slots=args.slots, d=16, step_time_s=step_s)],
        max_queue_depth=args.slots).start()
    try:
        closed_loop(ov.url, 2, 2, 2)
        rate = args.overload_x * max(out["serving_reqs_per_s"], 1.0)
        wall, lat, codes = open_loop(
            ov.url, rate, args.overload_seconds, args.max_tokens,
            args.overload_deadline_ms)
        n_ok = sum(1 for c in codes if c == 200)
        n_503 = sum(1 for c in codes if c == 503)
        q = _quantiles(lat)
        alive = False
        try:
            alive = urllib.request.urlopen(
                ov.url + "/healthz", timeout=5).status == 200
        except OSError:
            pass
        out.update(
            serving_overload_offered_per_s=round(rate, 1),
            serving_overload_admitted_per_s=round(n_ok / wall, 2),
            serving_overload_shed_frac=round(
                n_503 / max(1, len(codes)), 3),
            serving_overload_p99_ms=q["p99"],
            serving_overload_healthz_ok=alive,
            serving_overload_other_codes=sorted(
                {c for c in codes if c not in (200, 503)}))
        trace(f"overload @{rate:.0f}/s: admitted "
              f"{out['serving_overload_admitted_per_s']}/s, shed "
              f"{out['serving_overload_shed_frac']}, p99 {q['p99']} ms, "
              f"healthz={alive}")
    finally:
        ov.stop()

    # On a CUDA device each section's launches of the port's serving
    # kernels go to stderr: the paged-attention kernel (kernel 1) and the
    # all-to-all of the row plane's expert exchanges (kernel 10, at
    # ep > 1 only).
    counters = {}
    if torch.device(device).type == "cuda":
        from ..parallel.paged_attn import paged_attn_step_cuda
        from ..parallel.ring_probe import all_to_all_cuda

        counters = {"paged attention": paged_attn_step_cuda,
                    "all-to-all": all_to_all_cuda}

    # Sections 6-17 each leave a <section>_error key when they fail, so
    # the other sections' numbers still stand.
    def section(err_key, label, fn, *a, **kw):
        before = {k: c.launches for k, c in counters.items()}
        try:
            out.update(fn(*a, **kw))
        except Exception as e:
            out[err_key] = str(e)[:200]
            trace(f"{label} section failed: {e}")
        if counters:
            trace(f"{label}: kernel launches " + ", ".join(
                f"{k} {c.launches - before[k]}"
                for k, c in counters.items()))

    # 6: fault recovery — a deterministic replica kill at 2x overload;
    # the self-healing plane's headline numbers.
    section("serving_fault_error", "fault-recovery", fault_recovery,
            args.slots, step_s, out.get("serving_reqs_per_s", 0.0), trace)
    # 8: paged-KV decode at 2x overload, with/without prefix sharing.
    # Synthetic token-plane replicas: the figure moves on scheduler/KV
    # regressions, nothing else.
    section("serving_kv_error", "paged-kv", kv_paged_serving, args.slots,
            step_s, trace)
    # 9: sharded-vs-local decode decomposition. Synthetic shard plane
    # (fixed compute + collective cost): the figures move on
    # coordinator/shard scheduling regressions, nothing else.
    section("serving_sharded_error", "sharded-decode", sharded_decode,
            args.slots, trace, device=device)
    # 10: cross-process tracing overhead — the per-step cost of the
    # traced shard plane over the untraced section-9 pipelined step.
    section("serving_sharded_trace_error", "sharded-trace-overhead",
            sharded_trace_overhead, args.slots, trace, device=device)
    # 12: disaggregated prefill/decode vs colocated under a prefill
    # flood — decode p99 per token, page-stream Gb/s and the
    # transfer-vs-re-prefill breakeven, on the synthetic cost model.
    section("serving_disagg_error", "disagg", disagg_serving, trace)
    # 13: speculative draft/verify decode vs the one-token baseline —
    # accepted tokens/s/slot at a controlled acceptance rate on the
    # synthetic cost model.
    section("serving_spec_error", "speculative-decode",
            speculative_decode, trace)
    # 16: pipelined speculative decode — the priced draft overlapped
    # with the verify step; pipelined-spec vs sync-spec vs one-token,
    # with the accept-rate, replan-rate and step-cost decomposition.
    section("serving_pspec_error", "pipelined-spec",
            pipelined_speculative_decode, trace)
    # 15: cluster-wide prefix cache — prefix-aware routing + host-RAM
    # KV tiering vs prefix-blind round-robin on identical replicas and
    # request order.
    section("serving_cluster_prefix_error", "cluster-prefix",
            cluster_prefix, trace)
    # 17: multi-tenant QoS — the tenant-isolation p99 ratio under an
    # adversarial batch-class flood and the interactive burst-recovery
    # time, on the synthetic fixed-step cost model.
    section("serving_qos_error", "multi-tenant-qos", multi_tenant_qos,
            trace)

    if not args.skip_local:
        # 4: the row-plane model (the forward-only train_step stack)
        # over HTTP on the device.
        def local_http():
            from .executor import LocalExecutor

            res: dict = {}
            t0 = time.perf_counter()
            ex = LocalExecutor(slots=args.slots, S=1, d=8, h=8, E=1,
                               device=device)
            res["serving_local_compile_s"] = round(
                time.perf_counter() - t0, 2)
            local = ServingServer([ex], max_queue_depth=64).start()
            try:
                closed_loop(local.url, 2, 2, 2)
                wall, lat, codes = closed_loop(
                    local.url, args.clients, args.per_client,
                    args.max_tokens)
                n_ok = sum(1 for c in codes if c == 200)
                res["serving_local_reqs_per_s"] = round(n_ok / wall, 2)
                res["serving_local_p99_ms"] = _quantiles(lat)["p99"]
                trace(f"local model: "
                      f"{res['serving_local_reqs_per_s']} req/s")
            finally:
                local.stop()
            return res

        section("serving_local_error", "local", local_http)
        model = dict(S=args.decode_S, d=args.decode_d, h=args.decode_h,
                     E=1)
        # 5: decode-loop decomposition — sync vs device-resident
        # pipelined over the same model at the same slot count.
        section("serving_decode_error", "decode", decode_loop_rates,
                args.slots, model, args.decode_reqs, args.decode_tokens,
                trace, device=device)
        # 7: tracing overhead — traced vs untraced pipelined decode over
        # the same model.
        section("serving_trace_error", "trace-overhead", trace_overhead,
                args.slots, model, args.decode_reqs, args.decode_tokens,
                trace, device=device)
        # 11: fused paged attention + quantized KV residency — the CUDA
        # kernel vs its plain version, int8 bytes/slot accounting, and
        # the kernel's equivalence lane on a CUDA device.
        section("serving_paged_attn_error", "paged-attn",
                paged_attn_bench, trace, device=device)
        # 14: context-parallel paged KV — resident context per replica
        # vs world (KVSpec arithmetic), measured sharded decode tokens/s
        # + p99 vs the single-worker twin, per-rank transfer
        # decomposition.
        section("serving_shard_kv_error", "sharded-kv",
                sharded_kv_scaling, trace, device=device)

    print(json.dumps(out), flush=True)
    # A partial run must never read as a whole one.
    return 1 if any(k.endswith("_error") for k in out) else 0


if __name__ == "__main__":
    sys.exit(main())
