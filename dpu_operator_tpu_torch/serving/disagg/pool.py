"""DisaggPool — role-typed disaggregated prefill/decode serving.

The production inference topology of disaggregated serving: dedicated
PREFILL replicas build paged KV and stream the pages over the fabric
to DECODE replicas that only ever run the cheap per-token step. The
two workloads stop sharing a latency regime — a prefill flood cannot
inflate a decode replica's step time, because no decode replica ever
plans a prefill chunk.

Composition, not reinvention — each leg is an existing subsystem:

  * both roles are plain ``ReplicaPool``s over plain
    ``ContinuousBatcher``s (supervisor, watchdog, breaker, crash-only
    batchers, tracing and the flight recorder all ride along
    unchanged); the prefill pool's batchers carry the one new seam, a
    ``handoff`` hook that fires when a request emits its first token;
  * the hand-off is the paged plane's lease machinery doing what it
    was built for: ``kv_detach_slot`` detaches the ``KVLease`` (pages
    stay owned — a failed transfer ``reattach()``es and resumes on the
    prefill side), the pages ship over ``KVPageStream`` (the sharded
    plane's framed transport + int8 codec + hello checks), the
    importer builds a LOCAL lease in the decode pool, and the request
    re-enters through the queue's existing ``requeue()``; the
    decode-side ``kv_attach`` then takes the SAME ``_reattach`` path a
    kill-mid-decode resume takes — a lease migrating prefill→decode is the same move as a
    lease surviving a replica kill, so the exactly-once settle choke
    point and the leak ledger carry over with zero new cases;
  * failure disposition mirrors the supervisor's ``_requeue``
    verbatim: settled → skip; deadline lapsed mid-transfer →
    truncated 200 WITH tokens (never a 503 that discards them);
    attempts budget exhausted → 500 ``retries_exhausted``; otherwise
    requeue to the PREFILL queue front — the retried request
    re-attaches its surviving pages there, re-decodes exactly one
    token and hands off again (streams stay byte-identical, the paged
    plane's invariance argument carried across replicas).

Topology note: the front/admission queue IS the prefill queue;
transfers requeue into a separate decode-pool queue (depth-exempt —
these requests were admitted once already). With several decode
replicas the transfer targets the emptiest pool, but the decode
queue is shared: a request popped by a different decode replica
falls back to kv_attach's foreign-lease path (release + re-prefill
locally — correct and byte-identical, just not free; the single-
decode-replica config has no such race).
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence

from ... import faults
from ...obs import trace as obs_trace
from ..api import (DEADLINE_QUEUED_ERROR, RETRIES_EXHAUSTED_ERROR,
                   GenerateRequest)
from ..executor import ReplicaPool
from ..queue import AdmissionQueue
from .spec import KVSpecMismatch
from .stream import KVPageStream, KVPageStreamServer

log = logging.getLogger(__name__)

__all__ = ["DisaggPool"]

#: KV-page transfers are small-ms on a fabric: resolve them, not
#: request latencies.
_TRANSFER_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 1.0, 2.5)


class DisaggPool:
    """Two role-typed ReplicaPools plus the transfer plane between
    them, presenting the ReplicaPool surface the ServingServer (and
    its health endpoints) already speak."""

    def __init__(self, prefill_executors: Sequence,
                 decode_executors: Sequence, queue: AdmissionQueue,
                 registry=None, *, codec: Optional[str] = None,
                 seg_bytes: int = 1 << 18,
                 transfer_timeout_s: float = 5.0,
                 max_attempts: int = 3,
                 decode_queue_depth: int = 256,
                 pool_opts: Optional[dict] = None,
                 decode_pool_opts: Optional[dict] = None,
                 tracer=None, flight_recorder=None,
                 host: str = "127.0.0.1"):
        if not prefill_executors or not decode_executors:
            raise ValueError("disagg needs >= 1 prefill and >= 1 "
                             "decode executor")
        for ex in list(prefill_executors) + list(decode_executors):
            if not getattr(ex, "kv", False):
                raise ValueError("disagg executors must be paged-KV "
                                 "(the row plane has no transferable "
                                 "state)")
        # One spec rules them all: the layout is declared once and
        # every replica must agree, or pages shipped between them are
        # bytes, not KV.
        self.spec = prefill_executors[0].kv_spec
        for ex in list(prefill_executors)[1:] + list(decode_executors):
            mine, theirs = self.spec.fingerprint(), \
                ex.kv_spec.fingerprint()
            if mine != theirs:
                raise KVSpecMismatch(
                    f"executors disagree on the KV layout: {mine} vs "
                    f"{theirs}")
        self.codec = self.spec.validate_codec(
            codec if codec is not None else self.spec.default_codec())
        self.queue = queue  # the front door doubles as prefill queue
        self.registry = registry
        self.tracer = (tracer if tracer is not None
                       else obs_trace.get_tracer())
        self.flight_recorder = flight_recorder
        self.max_attempts = int(max_attempts)
        self.seg_bytes = int(seg_bytes)
        self.transfer_timeout_s = float(transfer_timeout_s)
        self.decode_executors = list(decode_executors)

        popts = dict(pool_opts or {})
        pre_bk = dict(popts.pop("batcher_kwargs", {}))
        pre_bk["handoff"] = self._enqueue_handoff
        self.prefill_pool = ReplicaPool(
            prefill_executors, queue, registry=registry,
            role="prefill", name_prefix="prefill",
            batcher_kwargs=pre_bk, tracer=self.tracer,
            flight_recorder=flight_recorder, **popts)
        # Separate queue: transfers requeue() into it (depth/drain
        # exempt), so the depth bound only shapes pathological pileup.
        # No registry: serving_queue_depth is the FRONT door's gauge.
        self.decode_queue = AdmissionQueue(
            max_depth=int(decode_queue_depth), tracer=self.tracer)
        dopts = dict(decode_pool_opts if decode_pool_opts is not None
                     else popts)
        dopts.setdefault("batcher_kwargs", {})
        self.decode_pool = ReplicaPool(
            self.decode_executors, self.decode_queue,
            registry=registry, role="decode", name_prefix="decode",
            tracer=self.tracer, flight_recorder=flight_recorder,
            **dopts)

        # One page-stream import server per decode executor (its own
        # pool, its own port), one lazily-connected client stream per
        # target on the transfer worker.
        self._servers = [
            KVPageStreamServer(self.spec, self._import_fn(i),
                               host=host, codec=self.codec,
                               timeout_s=self.transfer_timeout_s)
            for i in range(len(self.decode_executors))]
        self._streams: Dict[int, KVPageStream] = {}
        self._tlock = threading.Lock()
        self._txq: _queue.Queue = _queue.Queue()
        self._transferring = 0      # handed off, not yet settled out
        self._pending: Dict[str, GenerateRequest] = {}  # xfer -> req
        self._imported: Dict[str, object] = {}  # xfer -> decode lease
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._transfer_loop, daemon=True,
            name="kv-transfer")

    # -- ReplicaPool-compatible surface ---------------------------------------

    @property
    def executors(self) -> List:
        return (list(self.prefill_pool.executors)
                + list(self.decode_pool.executors))

    @property
    def supervised(self) -> bool:
        return (self.prefill_pool.supervised
                and self.decode_pool.supervised)

    @property
    def quorum(self) -> int:
        return self.prefill_pool.quorum + self.decode_pool.quorum

    def live_count(self) -> int:
        return (self.prefill_pool.live_count()
                + self.decode_pool.live_count())

    def states(self) -> Dict[str, str]:
        out = self.prefill_pool.states()
        out.update(self.decode_pool.states())
        return out

    def all_parked(self) -> bool:
        return (self.prefill_pool.all_parked()
                and self.decode_pool.all_parked())

    def active(self) -> int:
        with self._tlock:
            transferring = self._transferring
        return (self.prefill_pool.active() + self.decode_pool.active()
                + transferring)

    def start(self) -> None:
        self.prefill_pool.start()
        self.decode_pool.start()
        self._worker.start()

    def stop(self) -> None:
        # Prefill first: no new hand-offs enter the transfer queue
        # after its batchers stop (their occupants fail through the
        # normal stop path). Then the worker, then everything it
        # could still have been feeding.
        self.prefill_pool.stop()
        self._stop.set()
        if self._worker.is_alive():
            self._worker.join(timeout=2 * self.transfer_timeout_s)
        while True:
            try:
                req, detach = self._txq.get_nowait()
            except _queue.Empty:
                break
            detach["lease"].reattach()
            if not req.done:
                req.fail("server stopped")
            with self._tlock:
                self._transferring -= 1
        self.decode_queue.fail_all("server stopped")
        self.decode_pool.stop()
        for s in self._servers:
            s.close()
        # Snapshot: a worker that outlived the bounded join above may
        # still insert a reconnect stream mid-iteration.
        for st in list(self._streams.values()):
            st.close()
        with self._tlock:
            leftovers = list(self._imported.values())
            self._imported.clear()
        for lease in leftovers:
            lease.release()

    def quiesce(self, timeout: float = 30.0,
                poll_s: float = 0.02) -> bool:
        """Drained when the front queue, BOTH pools (including their
        seize hand-off windows) and the transfer plane are all empty.
        ``ReplicaPool.quiesce(timeout=0)`` is its instantaneous idle
        check — each pool covers its own queue/slots/seizing, this
        adds the detach→requeue window the transfer plane owns."""

        def idle() -> bool:
            with self._tlock:
                transferring = self._transferring
            return (transferring == 0
                    and self.prefill_pool.quiesce(timeout=0)
                    and self.decode_pool.quiesce(timeout=0))

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if idle():
                return True
            time.sleep(poll_s)
        return idle()

    # -- role autoscaling -----------------------------------------------------

    def transfer_backlog(self) -> int:
        """Hand-offs enqueued or in flight on the transfer plane —
        the decode-side pressure signal the RoleAutoscaler reads
        alongside decode queue depth."""
        with self._tlock:
            return self._txq.qsize() + self._transferring

    def flip_role(self, from_role: str) -> Optional[str]:
        """Move one replica between the role pools, live. The executor
        object — allocator, prefix tree, tier, pages — survives the
        move; only the batcher is rebuilt, with the DESTINATION pool's
        batcher_kwargs (gaining or losing the handoff hook is what
        changes the role). In-flight occupants requeue exactly once
        through the policy path (no `attempts` burn), resume via the
        ordinary attach dispositions, and each pool always keeps at
        least one live replica (returns None instead of violating
        that).

        Transfer-target note: the page-stream import servers are
        index-coupled to the ORIGINAL decode executors, so a replica
        flipped INTO the decode pool serves the decode queue but is
        never a transfer target, and one flipped OUT stops being
        preferred by _pick_target — no server is rebound live."""
        if from_role == "prefill":
            src, dst = self.prefill_pool, self.decode_pool
        elif from_role == "decode":
            src, dst = self.decode_pool, self.prefill_pool
        else:
            raise ValueError(
                f"from_role must be prefill|decode, got {from_role!r}")
        ex = src.detach_replica(min_live=1)
        if ex is None:
            return None
        name = dst.attach_replica(ex)
        direction = f"{from_role}_to_{dst.role}"
        self._count("serving_autoscale_flips_total",
                    {"direction": direction},
                    help="role-autoscaler replica flips between the "
                         "prefill and decode pools")
        self.tracer.event("disagg.flip_role",
                          attrs={"direction": direction,
                                 "replica": name})
        self.tracer.decision("flip_role", direction=direction,
                             replica=name)
        log.info("role flip %s: replica now serving as %s",
                 direction, name)
        return name

    # -- the transfer plane ----------------------------------------------------

    def transfer_addrs(self) -> List:
        """Decode-side import endpoints (tests + ops introspection)."""
        return [s.addr for s in self._servers]

    def _count(self, name: str, labels: dict, help: str = "",
               by: float = 1.0) -> None:
        if self.registry is not None:
            self.registry.counter_inc(name, labels, by=by, help=help)

    def _enqueue_handoff(self, req: GenerateRequest,
                         detach: dict) -> None:
        """The batcher's handoff hook — called under its settle lock,
        so this only counts and enqueues; export/stream runs on the
        transfer worker. From this instant until requeue/settle the
        request is in no slot and no queue: _transferring keeps the
        quiesce accounting closed over the window (the supervisor's
        _seizing discipline, applied to the third hand-off window
        this plane adds)."""
        with self._tlock:
            self._transferring += 1
        self._txq.put((req, detach))

    def _import_fn(self, i: int):
        ex = self.decode_executors[i]

        def import_pages(meta: dict, planes: list) -> dict:
            t0 = time.monotonic()
            lease = ex.kv_import(meta, planes)
            with self._tlock:
                # Register ONLY while the sender still owns the
                # transfer: if its ack deadline fired while we were
                # importing, it already popped _pending and moved on
                # (retry under a fresh xfer id) — registering now
                # would strand these worst-case pages in _imported
                # until stop(), silently draining the decode pool.
                # Both sender paths pop _pending and _imported under
                # this same lock, so the membership check is exact.
                owned = meta["xfer"] in self._pending
                if owned:
                    self._imported[meta["xfer"]] = lease
                req = self._pending.get(meta["xfer"])
            if not owned:
                lease.release()
                raise RuntimeError(
                    f"sender abandoned transfer {meta['xfer']} "
                    f"(request {meta.get('req')}) before the import "
                    f"finished — pages released")
            self.tracer.record_span(
                "disagg.import", t0, time.monotonic(),
                request_id=str(meta.get("req")),
                parent_id=(req.trace_parent if req is not None
                           else None),
                attrs={"replica": f"decode{i}",
                       "blocks": int(meta["n_blocks"]),
                       "codec": self.codec})
            return {"blocks": len(lease.blocks)}

        return import_pages

    def _pick_target(self) -> int:
        """Emptiest decode pool wins (free blocks = admission
        headroom — the decode-side OOM nack is the pressure valve,
        this just steers away from it). Among targets, prefer
        executors still serving IN the decode pool: one flipped out
        by the autoscaler can still import pages, but the requeued
        request would then pop on another replica and re-prefill via
        the foreign-lease path — correct, just wasted transfer."""
        live = {id(e) for e in list(self.decode_pool.executors)}
        idxs = [i for i, e in enumerate(self.decode_executors)
                if id(e) in live]
        if not idxs:
            idxs = list(range(len(self.decode_executors)))
        return max(idxs,
                   key=lambda i:
                   self.decode_executors[i].allocator.free_count())

    def _stream_for(self, i: int) -> KVPageStream:
        st = self._streams.get(i)
        if st is None:
            st = KVPageStream(self.spec, self._servers[i].addr,
                              codec=self.codec,
                              timeout_s=self.transfer_timeout_s,
                              seg_bytes=self.seg_bytes)
            self._streams[i] = st
        return st

    def _transfer_loop(self) -> None:
        while True:
            try:
                req, detach = self._txq.get(timeout=0.05)
            except _queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                self._transfer_one(req, detach)
            except Exception as e:
                # _transfer_one owns its failure paths; reaching here
                # is a harness bug — settle the request exactly once
                # rather than park its handler forever.
                log.exception("kv transfer: unhandled failure "
                              "(request %s)", req.request_id)
                detach["lease"].reattach()
                if not req.done:
                    req.fail(f"kv transfer failed: {e}")
            finally:
                with self._tlock:
                    self._transferring -= 1

    def _transfer_one(self, req: GenerateRequest, detach: dict) -> None:
        lease = detach["lease"]
        src = detach["executor"]
        if req.done:
            # Settled while queued for transfer (handler abandon /
            # stop): the finish choke point already released the
            # prefill lease; just clear the transit mark.
            lease.reattach()
            self._count("serving_kv_transfers_total",
                        {"outcome": "already_done"},
                        help="KV page transfers by disposition")
            return
        t0 = time.monotonic()
        xfer = uuid.uuid4().hex[:12]
        new_lease = None
        target = self._pick_target()
        try:
            faults.fire("disagg.transfer",
                        attrs={"request_id": req.request_id})
            meta, planes = src.kv_export(req, detach)
            meta["xfer"] = xfer
            with self._tlock:
                self._pending[xfer] = req
            ack = self._stream_for(target).send_pages(meta, planes)
            with self._tlock:
                new_lease = self._imported.pop(xfer, None)
                self._pending.pop(xfer, None)
            if new_lease is None:
                raise RuntimeError(
                    f"ack {ack.get('xfer')} without a registered "
                    f"import (request {req.request_id})")
        except Exception as e:
            with self._tlock:
                self._pending.pop(xfer, None)
                orphan = self._imported.pop(xfer, None)
            if orphan is not None:
                # Import landed but the ack leg died: the decode-side
                # pages must not outlive the failed hand-off.
                orphan.release()
            self._transfer_failed(req, lease, target, e, t0)
            return
        t1 = time.monotonic()
        # Sharded pools ship world per-rank sub-streams; the honest
        # byte count (and the per-rank decomposition) derives from
        # each rank's rank_view geometry — head-sharded sub-streams
        # duplicate the tiny per-block scale vector, which this
        # accounting keeps visible instead of papering over.
        rank_counts = meta.get("rank_blocks")
        if rank_counts is not None:
            rank_bytes = [
                self.spec.rank_wire_block_nbytes(r, self.codec)
                * int(n) for r, n in enumerate(rank_counts)]
            wire_bytes = sum(rank_bytes)
        else:
            rank_bytes = None
            wire_bytes = (self.spec.wire_block_nbytes(self.codec)
                          * int(meta["n_blocks"]))
        # The ack IS the hand-off's success acknowledgment: attach the
        # decode-side lease, then release the prefill pages with the
        # prefix-cache insert riding inside (owner refs still held, so
        # the insert can never fork a freed block — kv_release_slot's
        # own discipline, reused).
        req.kv_lease = new_lease
        lease.release(
            cache_hook=src.prefix_cache_hook(detach["confirmed"]))
        if self.registry is not None:
            self.registry.counter_inc(
                "serving_kv_transfer_bytes_total",
                {"codec": self.codec}, by=float(wire_bytes),
                help="KV page payload bytes shipped prefill->decode, "
                     "by wire codec")
            if rank_bytes is not None:
                for r, nbytes in enumerate(rank_bytes):
                    self.registry.counter_inc(
                        "serving_shard_kv_transfer_bytes_total",
                        {"rank": str(r)}, by=float(nbytes),
                        help="per-rank KV page bytes shipped over the "
                             "sharded point-to-point sub-streams")
            self.registry.observe(
                "serving_kv_transfer_seconds", t1 - t0,
                help="one request's KV transfer wall "
                     "(export -> import ack)",
                buckets=_TRANSFER_BUCKETS)
        self._count("serving_kv_transfers_total", {"outcome": "ok"},
                    help="KV page transfers by disposition")
        self.tracer.record_span(
            "disagg.transfer", t0, t1, request_id=req.request_id,
            parent_id=req.trace_parent,
            attrs={"to": f"decode{target}", "codec": self.codec,
                   "blocks": int(meta["n_blocks"]),
                   "bytes": wire_bytes,
                   "tokens": int(meta["tokens"])})
        if req.done:
            # Settled between ack and requeue (deadline via the
            # handler): finish released the DECODE lease we just
            # attached — nothing further owns pages. (If finish beat
            # the attach, it released the prefill lease and this
            # release of new_lease is the cleanup.)
            new_lease.release()
            return
        self.decode_queue.requeue(req)
        self.tracer.decision("transfer", request_id=req.request_id,
                             to=f"decode{target}")

    def _transfer_failed(self, req: GenerateRequest, lease,
                         target: int, err: Exception,
                         t0: float) -> None:
        """Migration-failure disposition — the supervisor's _requeue
        contract verbatim, applied to the transfer leg: settle at most
        once, keep decoded tokens when the deadline lapsed, burn one
        attempt otherwise and resume on the PREFILL side (the lease
        reattaches: pages survive, the retry re-attaches and re-hands
        off — provably the same stream)."""
        lease.reattach()
        now = time.monotonic()
        self.tracer.record_span(
            "disagg.transfer", t0, now, request_id=req.request_id,
            parent_id=req.trace_parent,
            attrs={"to": f"decode{target}", "codec": self.codec,
                   "error": str(err)[:200]})
        log.warning("kv transfer to decode%d failed (request %s, "
                    "attempt %d): %s", target, req.request_id,
                    req.attempts, err)
        if req.done:
            outcome = "already_done"
        elif req.deadline <= now:
            if req.tokens:
                req.truncated = True
                req.finish()
                outcome = "deadline_truncated"
            else:
                req.fail(DEADLINE_QUEUED_ERROR)
                outcome = "deadline_lapsed"
        else:
            req.attempts += 1
            if req.attempts >= self.max_attempts:
                req.fail(RETRIES_EXHAUSTED_ERROR)
                outcome = "retries_exhausted"
            else:
                # Front of the PREFILL queue: the surviving lease
                # re-attaches there, one token re-decodes, the
                # hand-off retries — possibly to another target.
                self.queue.requeue(req)
                outcome = "requeued_prefill"
        self._count("serving_kv_transfers_total", {"outcome": outcome},
                    help="KV page transfers by disposition")
        self.tracer.decision("transfer_failed",
                             request_id=req.request_id,
                             outcome=outcome)
        rec = self.flight_recorder
        if rec is not None:
            try:
                rec.snapshot("kv_transfer_failed",
                             extra={"request_id": req.request_id,
                                    "target": f"decode{target}",
                                    "outcome": outcome,
                                    "states": self.states()})
            except Exception:
                log.exception("flight recorder snapshot "
                              "(kv_transfer_failed) failed")
