"""HTTP front-end of the serving plane: /v1/generate, /healthz, /metrics.

Follows the k8s/http_server.py idiom (ThreadingHTTPServer, handler
back-references through the server object, quiet logs) with the
serving-specific contract on top:

  POST /v1/generate   {"prompt": str | "prompt_vec": [d floats],
                       "max_tokens": int, "deadline_ms": int}
      200 {"id", "tokens", "truncated", "timings": {queue_ms,
           decode_ms, total_ms, and the batcher's step sums: steps,
           submit_ms, device_ms, gap_ms, starved_steps, gc_ms}}
      400 malformed body / wrong prompt_vec width
      503 + Retry-After on queue-full, drain, or deadline shed — the
          backpressure answer: overload is REJECTED at the door so
          admitted requests keep a bounded p99 (never parked into an
          unbounded queue).
  GET /healthz        liveness: 200 while anything serves or is coming
                      back; 503 "dead" only when zero replicas are
                      live AND every breaker is open (nothing will
                      ever restart — a process restart is the only
                      medicine left)
  GET /readyz         readiness — what a k8s Service endpoint should
                      key on: 503 while draining, 503 "degraded" while
                      live replicas < the pool's quorum, else 200
  GET /metrics        utils/metrics.Registry exposition
  GET /debug/traces?request_id=...
                      span tree for one request (obs/trace.py): queue
                      wait → admit → per-step segments → retire, plus
                      any supervisor recovery chain. Every generate
                      response carries its id in X-Request-Id.
  GET /debug/flight   on-demand flight-recorder snapshot (the same
                      JSON the supervisor writes to disk on wedge/
                      death/breaker — see docs/observability.md)

SIGTERM drain (install_signal_handlers): stop admitting (everything new
gets 503), let queued + in-flight requests finish, then — when a
drain.Drainer and node name are wired — cordon the node and evict
fabric pods exactly as the daemon's repartition path does, so the
replica disappears from scheduling before the process exits.
"""

from __future__ import annotations

import json
import logging
import math
import signal
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..obs import trace as obs_trace
from ..obs.flight import FlightRecorder
from ..utils.metrics import Registry
from .api import (DEADLINE_QUEUED_ERROR, KV_OOM_ERROR, PRIORITIES,
                  RETRIES_EXHAUSTED_ERROR, Draining, QueueFull,
                  TenantOverBudget, GenerateRequest,
                  bounded_tenant_label, encode_prompt,
                  encode_prompt_tokens)
from .executor import Executor, ReplicaPool
from .queue import AdmissionQueue

log = logging.getLogger(__name__)

_DEADLINE_CAP_MS = 24 * 3600 * 1000.0  # nobody waits a day for tokens
_MAX_BODY_BYTES = 1 << 20  # prompt_vec of a few thousand floats fits 100x over


class ServingServer:
    def __init__(self, executors: Sequence[Executor], *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_queue_depth: int = 64,
                 default_max_tokens: int = 16,
                 max_tokens_cap: int = 1024,
                 default_deadline_s: float = 30.0,
                 retry_after_s: float = 1.0,
                 tenants: Optional[dict] = None,
                 default_budget=None,
                 registry: Optional[Registry] = None,
                 drainer=None, node_name: Optional[str] = None,
                 pool_opts: Optional[dict] = None,
                 pool_factory=None,
                 tracer=None, flight_dir: Optional[str] = None):
        # Per-server registry by default: tests and benches run several
        # servers in one process; sharing default_registry would blend
        # their series.
        self.registry = registry if registry is not None else Registry()
        # The tracer is process-global by default (spans carry request
        # ids and replica names, so cross-server series disambiguate by
        # id) — faults and the fabric transport record into the same
        # one, which is what puts an injected fault on the same
        # timeline as the recovery that answers it.
        self.tracer = (tracer if tracer is not None
                       else obs_trace.get_tracer())
        self.flight = FlightRecorder(tracer=self.tracer,
                                     flight_dir=flight_dir,
                                     registry=self.registry)
        # tenants maps tenant name → queue.TenantBudget (rate/burst/
        # weight); default_budget meters tenants not named there. Both
        # None (the default) keeps the single-tenant contract: one
        # global depth bound, FIFO, nobody ever sees a 429.
        self.queue = AdmissionQueue(max_depth=max_queue_depth,
                                    retry_after_s=retry_after_s,
                                    registry=self.registry,
                                    tracer=self.tracer,
                                    tenants=tenants,
                                    default_budget=default_budget)
        # Bounded tenant label values for THIS server's request series
        # (api.bounded_tenant_label): tenant names arrive from the
        # wire, and metrics cardinality must not be client-controlled.
        self._tenant_seen: set = set()
        self._tenant_seen_lock = threading.Lock()
        # pool_opts passes supervision knobs through (supervise,
        # watchdog_s, max_attempts, quorum, backoff/breaker tuning) —
        # the pool's defaults are the production contract.
        # pool_factory swaps the scheduler layer wholesale (the
        # disagg plane's role-typed DisaggPool): called with
        # (executors, queue, registry, tracer=, flight_recorder=), it
        # must return a ReplicaPool-shaped object — start/stop/
        # quiesce/live_count/states/all_parked/quorum/supervised/
        # executors — and `executors` passed to THIS constructor must
        # be the factory pool's full executor list (the front door
        # validates vocab/max_context/d across all of them).
        opts = dict(pool_opts or {})
        opts.setdefault("tracer", self.tracer)
        opts.setdefault("flight_recorder", self.flight)
        if pool_factory is not None:
            self.pool = pool_factory(executors, self.queue,
                                     self.registry,
                                     tracer=self.tracer,
                                     flight_recorder=self.flight)
        else:
            self.pool = ReplicaPool(executors, self.queue,
                                    registry=self.registry, **opts)
        # serving_trace_dropped_total is published as a DELTA against
        # the tracer's monotonic drop count at scrape time; init the
        # series so a zero-drop run still proves the bound exists.
        self._trace_dropped_pub = 0
        self._trace_pub_lock = threading.Lock()
        self.registry.counter_inc(
            "serving_trace_dropped_total", by=0.0,
            help="spans dropped by the tracer's bounded buffers "
                 "(per-thread overflow + ring eviction)")
        self.default_max_tokens = default_max_tokens
        self.max_tokens_cap = max_tokens_cap
        self.default_deadline_s = default_deadline_s
        kvs = {bool(getattr(ex, "kv", False)) for ex in executors}
        if len(kvs) != 1:
            # One front door, one request vocabulary: a pool mixing
            # token-plane and row-plane replicas could not validate a
            # prompt once at admission.
            raise ValueError("pool mixes paged-KV and row-plane "
                             "replicas")
        self.kv = kvs.pop()
        if self.kv:
            vocabs = {ex.vocab for ex in executors}
            ctxs = {ex.max_context for ex in executors}
            if len(vocabs) != 1 or len(ctxs) != 1:
                raise ValueError(
                    f"all KV replicas must share one vocab/max_context,"
                    f" got {sorted(vocabs)}/{sorted(ctxs)}")
            self.vocab = executors[0].vocab
            self.max_context = executors[0].max_context
            # Scrape-time delta state for the kv token counters
            # (published like serving_trace_dropped_total).
            self._kv_pub: dict = {}
            # Same discipline for the speculative-decoding counters
            # (present only on executors running mode="speculative").
            self._spec_pub: dict = {}
            # Per-tier prefix-hit deltas: hbm/host/remote.
            self._tier_pub: dict = {}
        dims = {ex.d for ex in executors}
        if len(dims) != 1:
            # prompt_vec width is validated once at the front door; a
            # mixed-d pool would admit vectors some replica cannot hold.
            raise ValueError(f"all replicas must share one feature dim, "
                             f"got {sorted(dims)}")
        self.d = executors[0].d
        self.drainer = drainer
        self.node_name = node_name
        self._draining = threading.Event()
        self._drained = threading.Event()
        self._drain_ok = False
        self._stopped = False

        # The handler class is held by the HTTP server, which the server
        # holds, and lives until the cycle collector runs (a class is its
        # own cycle): a strong reference back from it would keep a
        # stopped, dropped server (its pool, executors and their device
        # memory) alive as long. A request holds the server for its span.
        server_weak = weakref.ref(self)

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _send(self, code: int, body: dict,
                      headers: Optional[dict] = None) -> None:
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                for k, val in (headers or {}).items():
                    self.send_header(k, val)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                server_ref = server_weak()
                if server_ref is None:  # dropped after stop()
                    return self._send(503, {"status": "stopped"})
                if self.path == "/healthz":
                    # Liveness goes red ONLY when zero replicas are
                    # live AND none is coming back (every breaker
                    # open) — then a process restart is the only
                    # medicine left. A replica mid-backoff is seconds
                    # from returning; killing the pod for that would
                    # turn every transient fault into a full restart.
                    # Degraded and draining are readiness problems.
                    live = server_ref.pool.live_count()
                    if server_ref.pool.supervised and live == 0 \
                            and server_ref.pool.all_parked():
                        return self._send(
                            503, {"status": "dead", "live_replicas": 0})
                    return self._send(
                        200, {"status": "ok", "live_replicas": live})
                if self.path == "/readyz":
                    if server_ref.draining:
                        return self._send(503, {"status": "draining"})
                    live = server_ref.pool.live_count()
                    quorum = server_ref.pool.quorum
                    if live < quorum:
                        # Below quorum: stop routing NEW traffic here
                        # (a Service endpoint keyed on readiness drops
                        # out) while in-flight work keeps completing.
                        return self._send(
                            503, {"status": "degraded",
                                  "live_replicas": live,
                                  "quorum": quorum})
                    return self._send(
                        200, {"status": "ready",
                              "live_replicas": live})
                if self.path == "/metrics":
                    server_ref.update_derived_metrics()
                    data = server_ref.registry.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                parsed = urlparse(self.path)
                if parsed.path == "/debug/traces":
                    # Span tree for one request: queue → admit →
                    # per-step → retire (+ any recovery chain), JSON.
                    # ?recent=N lists the most recently active
                    # request ids instead — the discoverability mode
                    # for an operator with no X-Request-Id in hand.
                    qs = parse_qs(parsed.query)
                    recent = qs.get("recent", [None])[0]
                    if recent is not None:
                        try:
                            n = int(recent)
                            if not 1 <= n <= 1000:
                                raise ValueError(recent)
                        except (TypeError, ValueError):
                            return self._send(
                                400, {"error": "recent must be an "
                                               "int in [1, 1000]"})
                        return self._send(
                            200, {"recent":
                                  server_ref.tracer
                                  .recent_requests(n)})
                    rid = qs.get("request_id", [None])[0]
                    if not rid:
                        return self._send(
                            400, {"error": "need ?request_id= "
                                           "(or ?recent=N)"})
                    tree = server_ref.tracer.span_tree(rid)
                    if tree["span_count"] == 0:
                        # Stable contract under concurrency: an
                        # unknown (or fully evicted) id is ALWAYS
                        # this 404 — span_tree works on one snapshot,
                        # so a concurrently-draining tracer can never
                        # surface a half-drained tree.
                        return self._send(
                            404, {"error": f"no spans for request "
                                           f"{rid!r} (evicted or "
                                           f"unknown)"})
                    return self._send(200, tree)
                if parsed.path == "/debug/flight":
                    # On-demand flight snapshot: same payload the
                    # supervisor writes on wedge/death/breaker, served
                    # without touching disk.
                    return self._send(
                        200, server_ref.flight.snapshot(
                            "on_demand", write=False))
                self._send(404, {"error": "not found"})

            def do_POST(self):
                # Read the declared body BEFORE any reply: these are
                # HTTP/1.1 keep-alive connections, and replying with the
                # body still unread would desync the stream (the next
                # request line would parse from our leftover JSON).
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except (ValueError, TypeError):
                    self.close_connection = True
                    return self._send(400,
                                      {"error": "bad Content-Length"})
                if length > _MAX_BODY_BYTES:
                    # Bounded like everything else on this front door —
                    # a declared multi-GB body must not buffer into a
                    # handler thread while /healthz stays green.
                    self.close_connection = True
                    return self._send(
                        413, {"error": f"body over {_MAX_BODY_BYTES} "
                                       f"bytes"})
                raw = self.rfile.read(length) if length > 0 else b""
                if self.path != "/v1/generate":
                    return self._send(404, {"error": "not found"})
                server_ref = server_weak()
                if server_ref is None:  # dropped after stop()
                    return self._send(503, {"error": "server stopped"})
                server_ref.handle_generate(self, raw)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def start(self) -> "ServingServer":
        # Cyclic-GC pauses: host.gc spans and the per-request gc_ms.
        obs_trace.gc_pauses.install(self.tracer)
        self.pool.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="serving")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        # Refuse-new FIRST: a POST racing this teardown must get a
        # prompt 503, not a submit into a queue no batcher will ever
        # pop again (the handler would park its full wait timeout).
        self._draining.set()
        self.queue.begin_drain()
        self._httpd.shutdown()
        self._httpd.server_close()
        self.queue.fail_all("server stopped")
        self.pool.stop()
        # Again after the pool is down: a replica that died during
        # teardown may have requeued its occupants between the first
        # fail_all and the supervisor stopping — nobody will ever pop
        # them, so fail them here instead of parking their handlers.
        self.queue.fail_all("server stopped")
        if self._thread:
            self._thread.join(timeout=5)
        obs_trace.gc_pauses.remove(self.tracer)

    # -- drain ----------------------------------------------------------------

    def begin_drain(self, timeout: float = 30.0) -> bool:
        """SIGTERM path: refuse new work (503), finish queued +
        in-flight work, then cordon/evict via drain.Drainer when wired.
        Idempotent; returns True once quiesced."""
        self._draining.set()
        self.queue.begin_drain()
        ok = self.pool.quiesce(timeout)
        if ok and self.drainer is not None and self.node_name:
            try:
                self.drainer.drain_node(self.node_name)
            except Exception:
                log.exception("drain: Drainer.drain_node failed")
        self._drain_ok = ok
        self._drained.set()
        return ok

    def install_signal_handlers(self, stop_after: bool = True,
                                drain_timeout: float = 30.0):
        """SIGTERM → drain in a background thread (the handler itself
        must return immediately — it runs on the main thread mid-
        whatever). Returns the previous handler."""

        def _on_sigterm(signum, frame):
            log.info("SIGTERM: draining serving plane")
            t = threading.Thread(target=self._drain_and_stop,
                                 args=(drain_timeout, stop_after),
                                 daemon=True, name="serving-drain")
            t.start()

        return signal.signal(signal.SIGTERM, _on_sigterm)

    def _drain_and_stop(self, timeout: float, stop_after: bool) -> None:
        self.begin_drain(timeout)
        if stop_after:
            self.stop()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """True only for a COMPLETED drain (everything in flight
        finished). A quiesce timeout unblocks waiters but returns
        False — an orchestrator keyed on this must not tear down a
        process still holding requests."""
        return self._drained.wait(timeout) and self._drain_ok

    # -- request handling ------------------------------------------------------

    def update_derived_metrics(self) -> None:
        """Scrape-time derived gauges: the in-process p50/p99 estimate
        over the request-latency histogram (Registry.quantile — the SLO
        number an operator alerts on, computed where the buckets live
        instead of in PromQL)."""
        for q, name in ((0.5, "serving_request_p50_seconds"),
                        (0.99, "serving_request_p99_seconds")):
            est = self.registry.quantile(
                "serving_request_seconds", q, {"outcome": "ok"})
            if est is not None:
                self.registry.gauge_set(
                    name, round(est, 6),
                    help=f"estimated q={q} of serving_request_seconds "
                         f"(ok outcomes)")
        # Per-tenant p99: same estimator over the tenant-
        # labelled histogram, one gauge per admitted tenant label —
        # the isolation number the QoS bench gates on, visible to an
        # operator without PromQL.
        for key in self.registry.histogram_totals(
                "serving_tenant_request_seconds"):
            lbl = dict(key)
            if lbl.get("outcome") != "ok":
                continue
            est = self.registry.quantile(
                "serving_tenant_request_seconds", 0.99, lbl)
            if est is not None:
                self.registry.gauge_set(
                    "serving_tenant_request_p99_seconds",
                    round(est, 6), {"tenant": lbl["tenant"]},
                    help="estimated q=0.99 of per-tenant request wall "
                         "time (ok outcomes, bounded tenant label)")
        # The ring bound, proven: spans lost to either tracer bound
        # (per-thread overflow, ring eviction) surface as a counter —
        # published as the delta since the last scrape so the series
        # stays monotonic per server. Read-modify-write under a lock:
        # each connection gets its own handler thread, so two
        # concurrent /metrics scrapes would otherwise both see the
        # same delta and double-count the drops.
        with self._trace_pub_lock:
            dropped = self.tracer.dropped_total()
            delta = dropped - self._trace_dropped_pub
            self._trace_dropped_pub = dropped
        if delta > 0:
            self.registry.counter_inc(
                "serving_trace_dropped_total", by=float(delta),
                help="spans dropped by the tracer's bounded buffers "
                     "(per-thread overflow + ring eviction)")
        # Paged-KV plane: allocator occupancy, prefix-cache
        # effectiveness, and the prefill/decode token counters —
        # executor-authoritative values published at scrape time
        # (gauges as snapshots, counters as deltas so the series stay
        # monotonic per server).
        if self.kv:
            agg = {"used": 0, "free": 0, "shared": 0,
                   "hit": 0, "lookup": 0}
            deltas = {"prefill": 0, "decode": 0}
            tier_deltas = {"hbm": 0, "host": 0, "remote": 0}
            spec_agg = {"proposed": 0, "accepted": 0, "runs": 0,
                        "depth": 0, "peak": 0}
            spec_deltas = {"proposed": 0, "accepted": 0, "replans": 0}
            spec_path_deltas: dict = {}
            spec_seen = False
            rank_agg: dict = {}
            with self._trace_pub_lock:
                for idx, ex in enumerate(self.pool.executors):
                    st = ex.kv_stats()
                    agg["used"] += st["blocks_used"]
                    agg["free"] += st["blocks_free"]
                    agg["shared"] += st["blocks_shared"]
                    if hasattr(ex, "kv_rank_stats"):
                        # Context-parallel pools: the same
                        # gauge, decomposed per shard rank — one extra
                        # label on sharded-KV executors only, the
                        # aggregate series above stays as-is.
                        for r, rst in ex.kv_rank_stats().items():
                            for state in ("used", "free"):
                                key = (r, state)
                                rank_agg[key] = (
                                    rank_agg.get(key, 0)
                                    + rst[f"blocks_{state}"])
                    agg["hit"] += st["prefix_hit_tokens"]
                    agg["lookup"] += st["prefix_lookup_tokens"]
                    # Per-tier hit split: counters as
                    # deltas, like every executor-authoritative total.
                    # Executors predating the split report the sum as
                    # hbm — the only tier that existed.
                    tlast = self._tier_pub.get(idx, (0, 0, 0))
                    tcur = (st.get("prefix_hit_tokens_hbm",
                                   st["prefix_hit_tokens"]),
                            st.get("prefix_hit_tokens_host", 0),
                            st.get("prefix_hit_tokens_remote", 0))
                    for j, tname in enumerate(("hbm", "host",
                                               "remote")):
                        tier_deltas[tname] += tcur[j] - tlast[j]
                    self._tier_pub[idx] = tcur
                    last = self._kv_pub.get(idx, (0, 0))
                    deltas["prefill"] += st["prefill_tokens"] - last[0]
                    deltas["decode"] += st["decode_tokens"] - last[1]
                    self._kv_pub[idx] = (st["prefill_tokens"],
                                         st["decode_tokens"])
                    if "spec_proposed_tokens" in st:
                        # Speculative replica: acceptance
                        # counters as deltas, rates as scrape-time
                        # gauges over the cumulative totals.
                        spec_seen = True
                        spec_agg["proposed"] += st[
                            "spec_proposed_tokens"]
                        spec_agg["accepted"] += st[
                            "spec_accepted_tokens"]
                        spec_agg["runs"] += st["spec_verify_steps"]
                        # Pipelined speculation: in-flight
                        # plan-ahead depth is a live gauge; re-plans
                        # and the accepted path-length histogram are
                        # deltas like every executor total.
                        spec_agg["depth"] += st.get(
                            "spec_pipeline_depth", 0)
                        spec_agg["peak"] = max(
                            spec_agg["peak"],
                            st.get("spec_pipeline_peak", 0))
                        slast = self._spec_pub.get(
                            idx, (0, 0, 0, {}))
                        spec_deltas["proposed"] += (
                            st["spec_proposed_tokens"] - slast[0])
                        spec_deltas["accepted"] += (
                            st["spec_accepted_tokens"] - slast[1])
                        spec_deltas["replans"] += (
                            st.get("spec_replans", 0) - slast[2])
                        paths = dict(st.get("spec_path_len", {}))
                        for plen, n in paths.items():
                            d = n - slast[3].get(plen, 0)
                            if d > 0:
                                spec_path_deltas[plen] = (
                                    spec_path_deltas.get(plen, 0) + d)
                        self._spec_pub[idx] = (
                            st["spec_proposed_tokens"],
                            st["spec_accepted_tokens"],
                            st.get("spec_replans", 0), paths)
            for state in ("used", "free", "shared"):
                self.registry.gauge_set(
                    "serving_kv_blocks", float(agg[state]),
                    {"state": state},
                    help="paged KV blocks by allocator state "
                         "(shared = refcount > 1)")
            for (r, state), n in sorted(rank_agg.items()):
                self.registry.gauge_set(
                    "serving_kv_blocks", float(n),
                    {"state": state, "rank": str(r)},
                    help="paged KV blocks by allocator state "
                         "(shared = refcount > 1)")
            self.registry.gauge_set(
                "serving_kv_prefix_hit_frac",
                round(agg["hit"] / agg["lookup"], 6)
                if agg["lookup"] else 0.0,
                help="fraction of looked-up prompt tokens served from "
                     "the prefix cache")
            for tname in ("hbm", "host", "remote"):
                self.registry.counter_inc(
                    "serving_prefix_hit_tokens_total",
                    {"tier": tname},
                    by=float(max(0, tier_deltas[tname])),
                    help="prefix-cache hit tokens by the tier that "
                         "served them (hbm resident, host-tier "
                         "restore, cross-replica pull)")
            self.registry.gauge_set(
                "serving_prefix_hit_frac",
                round(agg["hit"] / agg["lookup"], 6)
                if agg["lookup"] else 0.0,
                help="fraction of looked-up prompt tokens served from "
                     "any prefix-cache tier (scrape-time, cumulative)")
            self.registry.counter_inc(
                "serving_prefill_tokens_total", by=float(
                    max(0, deltas["prefill"])),
                help="prompt tokens processed through chunked prefill")
            self.registry.counter_inc(
                "serving_decode_tokens_total", by=float(
                    max(0, deltas["decode"])),
                help="decode tokens emitted by paged-KV steps")
            if spec_seen:
                self.registry.counter_inc(
                    "serving_spec_proposed_tokens_total", by=float(
                        max(0, spec_deltas["proposed"])),
                    help="draft tokens fed to speculative verify "
                         "steps")
                self.registry.counter_inc(
                    "serving_spec_accepted_tokens_total", by=float(
                        max(0, spec_deltas["accepted"])),
                    help="draft tokens the target model accepted")
                self.registry.gauge_set(
                    "serving_spec_accept_rate",
                    round(spec_agg["accepted"] / spec_agg["proposed"],
                          6) if spec_agg["proposed"] else 0.0,
                    help="accepted fraction of proposed draft tokens "
                         "(cumulative)")
                self.registry.gauge_set(
                    "serving_spec_tokens_per_step",
                    round((spec_agg["accepted"] + spec_agg["runs"])
                          / spec_agg["runs"], 6)
                    if spec_agg["runs"] else 0.0,
                    help="emitted tokens per verify step (accepted "
                         "drafts + the bonus; 1.0 = the one-token "
                         "baseline)")
                self.registry.counter_inc(
                    "serving_spec_replans_total", by=float(
                        max(0, spec_deltas["replans"])),
                    help="pipelined plan-ahead windows invalidated by "
                         "a mis-speculated verify (watermark rollback "
                         "+ re-plan; always 0 in sync spec mode)")
                self.registry.gauge_set(
                    "serving_spec_pipeline_depth",
                    float(spec_agg["depth"]),
                    help="speculative verify windows currently in "
                         "flight across replicas (0 = drained; 2 = "
                         "draft overlapping verify)")
                self.registry.gauge_set(
                    "serving_spec_pipeline_peak",
                    float(spec_agg["peak"]),
                    help="max simultaneous in-flight speculative "
                         "windows any replica reached (lifetime)")
                for plen in sorted(spec_path_deltas):
                    for _ in range(spec_path_deltas[plen]):
                        self.registry.observe(
                            "serving_spec_tree_path_len", float(plen),
                            help="tokens emitted per verify window "
                                 "(accepted root-to-leaf path + "
                                 "bonus; 1 = full rejection)",
                            buckets=(1.0, 2.0, 3.0, 4.0, 6.0, 8.0,
                                     12.0, 16.0))
        # Per-replica host-gap share of the decode loop: the overlap
        # number an operator watches — near 0 means host scheduling
        # hides behind device steps; climbing toward 1 means the device
        # waits on python (the pipelining regression signal, visible in
        # /metrics, not just the bench artifact).
        device = self.registry.histogram_totals(
            "serving_step_device_seconds")
        for key, (gap_sum, _n) in self.registry.histogram_totals(
                "serving_host_gap_seconds").items():
            total = gap_sum + device.get(key, (0.0, 0))[0]
            if total > 0:
                self.registry.gauge_set(
                    "serving_host_gap_fraction",
                    round(gap_sum / total, 6), dict(key),
                    help="host-gap share of decode-loop wall time "
                         "(host_gap / (host_gap + device))")

    def _finish(self, handler, code: int, body: dict, outcome: str,
                headers: Optional[dict] = None,
                elapsed_s: Optional[float] = None,
                req: Optional[GenerateRequest] = None,
                tenant: Optional[str] = None) -> None:
        if tenant is None:
            tenant = req.tenant if req is not None else "default"
        with self._tenant_seen_lock:
            tlabel = bounded_tenant_label(tenant, self._tenant_seen)
        self.registry.counter_inc(
            "serving_requests_total", {"code": str(code),
                                       "outcome": outcome,
                                       "tenant": tlabel},
            help="generate requests by outcome")
        if elapsed_s is not None:
            self.registry.observe(
                "serving_request_seconds", elapsed_s,
                {"outcome": outcome},
                help="end-to-end request wall time")
            # Per-tenant latency rides a SEPARATE histogram: the p50/
            # p99 derived gauges key on serving_request_seconds'
            # exact label set {outcome}, and the registry matches
            # label keys exactly — adding tenant there would orphan
            # those series.
            self.registry.observe(
                "serving_tenant_request_seconds", elapsed_s,
                {"outcome": outcome, "tenant": tlabel},
                help="end-to-end request wall time by tenant "
                     "(bounded label)")
        if req is not None:
            # Every response for a request that got an id carries it —
            # the handle a client quotes to /debug/traces.
            headers = dict(headers or {})
            headers["X-Request-Id"] = req.request_id
            span = getattr(req, "_root_span", None)
            if span is not None:
                self.tracer.finish(span, attrs={"outcome": outcome,
                                                "code": code})
        handler._send(code, body, headers)

    def handle_generate(self, handler, raw: bytes) -> None:
        t0 = time.monotonic()
        retry = {"Retry-After": str(max(1, int(round(
            self.queue.retry_after_s))))}
        if self.draining:
            return self._finish(handler, 503, {"error": "draining"},
                                "draining", retry)
        try:
            body = json.loads(raw) if raw else {}
        except (ValueError, TypeError):
            return self._finish(handler, 400,
                                {"error": "malformed JSON body"}, "bad")
        if not isinstance(body, dict):
            return self._finish(handler, 400,
                                {"error": "body must be an object"}, "bad")
        # Multi-tenant QoS: tenant from the JSON body, then
        # the X-Tenant header, then "default"; priority must be a known
        # class — a typo'd priority is a 400, not a silent new class.
        tenant = body.get("tenant")
        if tenant is None:
            tenant = handler.headers.get("X-Tenant") or "default"
        if not isinstance(tenant, str) or not tenant \
                or len(tenant) > 256:
            return self._finish(
                handler, 400,
                {"error": "tenant must be a non-empty string "
                          "(<= 256 chars)"}, "bad")
        priority = body.get("priority", "interactive")
        if priority not in PRIORITIES:
            return self._finish(
                handler, 400,
                {"error": f"unknown priority class {priority!r} "
                          f"(expected one of {list(PRIORITIES)})"},
                "bad", tenant=tenant)
        try:
            vec = self._prompt_vec(body) if not self.kv else None
        except (ValueError, TypeError) as e:
            # TypeError too: np.asarray raises it for non-numeric JSON
            # (e.g. prompt_vec as an object) — that's a client error,
            # not a dropped connection.
            return self._finish(handler, 400, {"error": str(e)}, "bad",
                                tenant=tenant)
        try:
            max_tokens = int(body.get("max_tokens",
                                      self.default_max_tokens))
            deadline_ms = float(body.get("deadline_ms",
                                         self.default_deadline_s * 1000))
        except (TypeError, ValueError):
            return self._finish(
                handler, 400,
                {"error": "max_tokens/deadline_ms must be numbers"},
                "bad", tenant=tenant)
        if not 1 <= max_tokens <= self.max_tokens_cap:
            return self._finish(
                handler, 400,
                {"error": f"max_tokens must be in [1, "
                          f"{self.max_tokens_cap}]"}, "bad",
                tenant=tenant)
        # Finite and capped, not just positive: json.loads accepts
        # Infinity/NaN, and a NaN deadline poisons every expiry
        # comparison while an astronomic one overflows Event.wait.
        if not (math.isfinite(deadline_ms)
                and 0 < deadline_ms <= _DEADLINE_CAP_MS):
            return self._finish(
                handler, 400,
                {"error": f"deadline_ms must be a finite number in "
                          f"(0, {_DEADLINE_CAP_MS:.0f}]"}, "bad",
                tenant=tenant)

        toks = None
        if self.kv:
            try:
                toks = self._prompt_tokens(body, max_tokens)
            except (ValueError, TypeError) as e:
                return self._finish(handler, 400, {"error": str(e)},
                                    "bad", tenant=tenant)

        req = GenerateRequest(prompt_vec=vec, max_tokens=max_tokens,
                              deadline=t0 + deadline_ms / 1000.0,
                              prompt_tokens=toks,
                              tenant=tenant, priority=priority)
        # Root span of the request's trace: every downstream span
        # (queue, admit, retire, supervisor requeue) parents onto it
        # through req.trace_parent; _finish closes it with the outcome.
        span = self.tracer.start(
            "request", request_id=req.request_id,
            attrs={"max_tokens": max_tokens,
                   "deadline_ms": deadline_ms})
        if not obs_trace.is_noop(span):
            req.trace_parent = span.span_id
            req._root_span = span
        try:
            self.queue.submit(req)
        except TenantOverBudget as e:
            # 429, not 503: the SERVER has headroom, this tenant has
            # spent its share — the client-side fix is slow down, not
            # retry elsewhere.
            return self._finish(
                handler, 429,
                {"error": str(e), "tenant": e.tenant}, "over_budget",
                {"Retry-After": str(max(1, int(round(e.retry_after_s))))},
                req=req)
        except QueueFull as e:
            return self._finish(
                handler, 503,
                {"error": "overloaded: admission queue full",
                 "queue_depth": e.depth}, "queue_full",
                {"Retry-After": str(max(1, int(round(e.retry_after_s))))},
                req=req)
        except Draining:
            return self._finish(handler, 503, {"error": "draining"},
                                "draining", retry, req=req)
        except Exception as e:
            # Anything else out of the admission path (a poisoned
            # queue, an injected fault) must cost THIS request a JSON
            # 500, not the connection — the plane keeps serving.
            log.exception("generate: admission failed (request %s)",
                          req.request_id)
            return self._finish(
                handler, 500,
                {"error": f"internal: admission failed: {e}"}, "error",
                elapsed_s=time.monotonic() - t0, req=req)

        # The handler thread parks on the request event; the batcher
        # completes it. Grace past the deadline covers the final step +
        # hand-off — a miss here means the scheduler plane wedged.
        req.wait(deadline_ms / 1000.0 + 10.0)
        elapsed = time.monotonic() - t0
        if not req.done:
            req.fail("scheduler wedged")  # unparks nothing; marks it
            return self._finish(handler, 500,
                                {"error": "internal: request lost"},
                                "lost", elapsed_s=elapsed, req=req)
        if req.error is not None:
            shed = req.error in (DEADLINE_QUEUED_ERROR, KV_OOM_ERROR)
            code = 503 if shed else 500
            if req.error == DEADLINE_QUEUED_ERROR:
                outcome = "deadline_queue"
            elif req.error == KV_OOM_ERROR:
                # KV admission shed: pages free as in-flight requests
                # finish — back off and retry, like queue_full.
                outcome = "kv_oom"
            elif req.error == RETRIES_EXHAUSTED_ERROR:
                # The supervisor's give-up: the request rode its full
                # attempts budget through replica failures.
                outcome = "retries_exhausted"
            else:
                outcome = "error"
            return self._finish(handler, code, {"error": req.error},
                                outcome,
                                retry if code == 503 else None,
                                elapsed_s=elapsed, req=req)
        body_out = {
            "id": req.request_id,
            "tokens": req.tokens,
            "truncated": req.truncated,
            "timings": req.timings_ms(),
        }
        lease = req.kv_lease
        if lease is not None:
            # How much prefill the prefix cache skipped — the client-
            # visible proof that sharing worked (bench section 8 keys
            # on it) — and WHERE the skip was served from (host tiering:
            # cached_tokens alone can't distinguish an HBM hit from a
            # host-tier restore or a cross-replica pull).
            body_out["kv"] = {"cached_tokens": lease.cached_tokens,
                              "blocks": len(lease.blocks),
                              "cached_by_tier": dict(
                                  lease.cached_by_tier)}
        self._finish(handler, 200, body_out, "ok", elapsed_s=elapsed,
                     req=req)

    def _prompt_tokens(self, body: dict, max_tokens: int) -> list:
        """Token-plane prompt parsing (paged-KV pools): explicit
        ``prompt_tokens`` (ints in [0, vocab)) or a ``prompt`` string
        through the deterministic stand-in tokenizer. Validated once
        at the front door, like prompt_vec: width AND the worst-case
        context (prompt + max_tokens must fit the replicas' block
        tables)."""
        if "prompt_tokens" in body:
            toks = body["prompt_tokens"]
            if (not isinstance(toks, list) or not toks
                    or not all(isinstance(t, int)
                               and not isinstance(t, bool)
                               and 0 <= t < self.vocab for t in toks)):
                raise ValueError(
                    f"prompt_tokens must be a non-empty list of ints "
                    f"in [0, {self.vocab})")
        else:
            prompt = body.get("prompt")
            if not isinstance(prompt, str) or not prompt:
                raise ValueError(
                    "need 'prompt' (string) or 'prompt_tokens'")
            n = min(16, max(1, self.max_context - max_tokens))
            toks = encode_prompt_tokens(prompt, n, self.vocab)
        if len(toks) + max_tokens > self.max_context:
            raise ValueError(
                f"prompt ({len(toks)} tokens) + max_tokens "
                f"({max_tokens}) exceeds max context "
                f"{self.max_context}")
        return toks

    def _prompt_vec(self, body: dict) -> np.ndarray:
        if "prompt_vec" in body:
            vec = np.asarray(body["prompt_vec"], dtype=np.float32)
            if vec.shape != (self.d,):
                raise ValueError(
                    f"prompt_vec must be [{self.d}] floats, "
                    f"got shape {list(vec.shape)}")
            if not np.isfinite(vec).all():
                # Same json.loads quirk as deadline_ms: Infinity/NaN
                # literals parse fine and would decode garbage tokens.
                raise ValueError("prompt_vec must be finite")
            return vec
        prompt = body.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            raise ValueError("need 'prompt' (string) or 'prompt_vec'")
        return encode_prompt(prompt, self.d)
