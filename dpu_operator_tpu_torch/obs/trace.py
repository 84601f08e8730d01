"""Request-scoped tracing for the serving plane and fabric.

The serving plane's aggregate histograms answer "how slow is p99"; they
cannot answer "where did THIS request's time go" — queue wait vs
pipelined hand-off vs device step vs seize/requeue/restart. This module
is the Dapper-shaped answer sized to this repo: a dependency-free
``Span``/``Tracer`` with monotonic-clock spans, explicit parent ids and
a bounded per-process ring buffer, threaded through the whole request
path (server → queue → batcher → executor seam → fabric transport →
supervisor) and scraped through ``GET /debug/traces?request_id=`` and
the flight recorder (obs/flight.py).

Always-on cheap is the design constraint, not a hope:

  * recording is LOCK-LIGHT — each thread appends completed spans to
    its own buffer (plain ``deque.append``, no lock on the hot path);
    the scraper drains every thread buffer into the central ring under
    the tracer lock. The only lock a recording thread ever takes is a
    one-time registration when it records its first span.
  * both the per-thread buffers and the central ring are BOUNDED, and
    every span that falls off either bound is COUNTED — the serving
    plane exports the total as ``serving_trace_dropped_total`` at
    scrape time, so the bound is proven, never hidden.
  * ``Tracer.enabled = False`` turns every record into a near-free
    no-op (one attribute read) — the knob bench_serving section 7 uses
    to price the traced-vs-untraced step rate (gated at <2%).

Span model: one ``Span`` per operation, ``parent_id`` for same-request
nesting (the HTTP handler's root span parents the queue/admit/retire
spans via ``GenerateRequest.trace_parent``), and a ``request_ids``
attr for spans that serve MANY requests at once (a decode step runs
every occupied slot) — the query surface attaches those to each
occupant's tree as linked children, Dapper's follows-from. Events are
zero-duration spans (``kind == "event"``).

Clock discipline: every timestamp is ``time.monotonic()`` — the same
clock the scheduler's deadlines and the fault plan's ``fired_at`` use,
so a flight-recorder timeline orders fault firing, watchdog detection
and recovery on one axis.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

# itertools.count.__next__ is atomic under the GIL: unique int ids with
# no lock on the record path (and no string formatting — ids stay ints
# all the way into the JSON).
_ids = itertools.count(1)


class Span:
    """One traced operation. ``t0``/``t1`` are time.monotonic seconds;
    ``kind`` is "span" (has duration) or "event" (t1 == t0). Span ids
    are process-unique ints.

    The HOT recording paths (record_span/event) never build these —
    they append a plain tuple to the thread buffer and drain()
    materializes Spans at scrape time, so the per-step cost in the
    decode loop is one tuple + one deque append."""

    __slots__ = ("name", "span_id", "parent_id", "request_id",
                 "kind", "t0", "t1", "attrs")

    def __init__(self, name: str, span_id: int,
                 parent_id: Optional[int], request_id: Optional[str],
                 t0: float, kind: str = "span",
                 attrs: Optional[dict] = None):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.request_id = request_id
        self.kind = kind
        self.t0 = t0
        self.t1 = t0
        self.attrs = attrs if attrs is not None else {}

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "request_id": self.request_id,
            "kind": self.kind,
            "t0": round(self.t0, 6),
            "t1": round(self.t1, 6),
            "dur_ms": round((self.t1 - self.t0) * 1000.0, 3),
            "attrs": self.attrs,
        }

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, rid={self.request_id}, "
                f"{(self.t1 - self.t0) * 1000.0:.3f}ms)")


# Returned by start() when tracing is disabled: callers may set attrs /
# finish it without a branch of their own; nothing is ever recorded.
_NOOP = Span("noop", 0, None, None, 0.0)


def is_noop(span: Optional[Span]) -> bool:
    """True for the disabled-tracer placeholder — callers that stash a
    span id for cross-thread parenting must not stash this one."""
    return span is None or span is _NOOP


class _ThreadBuf:
    """One thread's outbound span buffer. The owner appends (right);
    the drainer pops (left) — both deque ends are thread-safe, so the
    hot path never takes a lock."""

    __slots__ = ("spans", "dropped", "thread")

    def __init__(self):
        self.spans: deque = deque()
        self.dropped = 0
        self.thread = threading.current_thread()


class Tracer:
    def __init__(self, capacity: int = 16384,
                 per_thread_cap: int = 4096,
                 decision_cap: int = 512):
        self.enabled = True
        self.capacity = int(capacity)
        self.per_thread_cap = int(per_thread_cap)
        self._local = threading.local()
        self._lock = threading.Lock()      # registry + ring, never hot
        self._bufs: List[_ThreadBuf] = []
        self._ring: deque = deque()
        self._ring_dropped = 0
        self._buf_dropped_collected = 0
        # Recent scheduler decisions (admit/shed/requeue/seize/restart/
        # breaker) — the flight recorder snapshots these next to the
        # span ring. deque(maxlen) appends are thread-safe.
        self._decisions: deque = deque(maxlen=int(decision_cap))

    # -- recording (hot path) -------------------------------------------------
    #
    # The thread buffer holds EITHER Span objects (the start/finish
    # context path — cold: request roots) or plain 8-tuples in Span
    # field order (record_span/event — the decode loop's per-step
    # path). drain() materializes tuples into Spans at scrape time, so
    # the hot path pays one id bump, one tuple and one deque append.

    def _buf(self) -> _ThreadBuf:
        try:
            return self._local.buf
        except AttributeError:
            buf = _ThreadBuf()
            self._local.buf = buf
            with self._lock:
                self._bufs.append(buf)
            return buf

    def _record(self, item) -> None:
        buf = self._buf()
        if len(buf.spans) >= self.per_thread_cap:
            buf.dropped += 1
            return
        buf.spans.append(item)

    def start(self, name: str, request_id: Optional[str] = None,
              parent_id: Optional[int] = None,
              attrs: Optional[dict] = None) -> Span:
        """Open a span (recorded only at finish()). With no explicit
        parent_id the innermost open ``span()`` context on THIS thread
        becomes the parent; cross-thread parenting is always explicit
        (that's what GenerateRequest.trace_parent carries)."""
        if not self.enabled:
            return _NOOP
        if parent_id is None:
            stack = getattr(self._local, "stack", None)
            if stack:
                parent_id = stack[-1]
        return Span(name, next(_ids), parent_id, request_id,
                    time.monotonic(), attrs=attrs)

    def finish(self, span: Span,
               attrs: Optional[dict] = None) -> None:
        if span is _NOOP:
            return
        span.t1 = time.monotonic()
        if attrs:
            span.attrs.update(attrs)
        self._record(span)

    @contextmanager
    def span(self, name: str, request_id: Optional[str] = None,
             parent_id: Optional[int] = None,
             attrs: Optional[dict] = None) -> Iterator[Span]:
        sp = self.start(name, request_id=request_id,
                        parent_id=parent_id, attrs=attrs)
        if sp is not _NOOP:
            stack = getattr(self._local, "stack", None)
            if stack is None:
                stack = self._local.stack = []
            stack.append(sp.span_id)
        try:
            yield sp
        finally:
            if sp is not _NOOP:
                self._local.stack.pop()
            self.finish(sp)

    def event(self, name: str, request_id: Optional[str] = None,
              parent_id: Optional[int] = None,
              attrs: Optional[dict] = None) -> Optional[int]:
        """Record a zero-duration span immediately; returns its id."""
        if not self.enabled:
            return None
        sid = next(_ids)
        t = time.monotonic()
        self._record((name, sid, parent_id, request_id, "event",
                      t, t, attrs))
        return sid

    def record_span(self, name: str, t0: float, t1: float,
                    request_id: Optional[str] = None,
                    parent_id: Optional[int] = None,
                    attrs: Optional[dict] = None,
                    span_id: Optional[int] = None) -> Optional[int]:
        """Record a completed span from timestamps the caller already
        measured (time.monotonic) — the scheduler's step segments come
        in this way, so tracing adds no clock calls of its own there.
        Returns the span id (for explicit child parenting).

        ``span_id`` takes a previously ``reserve_id()``-ed id: the
        cross-process pattern where an id must be SHIPPED to workers at
        submit time (they parent on it) while the span itself is only
        recordable at collect, when its duration exists."""
        if not self.enabled:
            return None
        sid = span_id if span_id is not None else next(_ids)
        self._record((name, sid, parent_id, request_id, "span",
                      t0, t1, attrs))
        return sid

    def reserve_id(self) -> int:
        """Allocate a span id with nothing recorded yet — the
        cross-process parent hand-off (see record_span's span_id)."""
        return next(_ids)

    def ingest(self, wire_spans, offset: float = 0.0,
               attrs: Optional[dict] = None) -> int:
        """Record another process's finished spans (obs.xproc wire
        lists: [name, sid, parent, rid, kind, t0, t1, attrs]).

        Foreign span ids live in the WORKER's counter and collide with
        local ids, so every shipped id is remapped to a fresh local
        one; parent links INSIDE the shipment follow the map, a parent
        id a shipment doesn't carry is dropped (its span was lost to
        the worker's bounded buffer — a dangling link must not alias a
        local span), and a parent in the COORDINATOR's id space rides
        ``attrs["xparent"]`` and passes through verbatim. Timestamps
        shift by ``-offset`` (offset = remote_clock - local_clock, the
        ClockSync estimate) onto the local monotonic axis; ``attrs``
        merge into every span (the offset/uncertainty stamp). Stays on
        the lock-light tuple path — ingest is a collect-leg cost.
        Returns the number of spans recorded."""
        if not self.enabled or not wire_spans:
            return 0
        idmap = {w[1]: next(_ids) for w in wire_spans}
        n = 0
        for name, sid, parent, rid, kind, t0, t1, sattrs in wire_spans:
            # The shipment's attr dicts are OWNED here (parsed off the
            # wire, shared with nobody) — mutated in place rather than
            # copied: ingest runs per rank per step on the collect leg.
            a = sattrs if sattrs is not None else {}
            xparent = a.pop("xparent", None)
            if parent is not None:
                parent = idmap.get(parent)
            if parent is None and xparent is not None:
                parent = xparent
            if attrs:
                a.update(attrs)
            self._record((name, idmap[sid], parent, rid, kind,
                          t0 - offset, t1 - offset, a))
            n += 1
        return n

    def decision(self, kind: str, **attrs) -> None:
        """Append one scheduler decision to the bounded decision log
        (flight-recorder context, not part of the span ring)."""
        if not self.enabled:
            return
        attrs["t"] = round(time.monotonic(), 6)
        attrs["kind"] = kind
        self._decisions.append(attrs)

    # -- scraping -------------------------------------------------------------

    def drain(self) -> None:
        """Move every thread buffer's spans into the central ring
        (oldest spans fall off the ring bound, counted), materializing
        the hot path's tuples into Span objects here — at scrape time,
        off every decode loop. Buffers of dead threads are pruned once
        empty."""
        with self._lock:
            live: List[_ThreadBuf] = []
            for buf in self._bufs:
                while True:
                    try:
                        item = buf.spans.popleft()
                    except IndexError:
                        break
                    if type(item) is tuple:
                        name, sid, parent, rid, kind, t0, t1, attrs = \
                            item
                        span = Span(name, sid, parent, rid, t0,
                                    kind=kind, attrs=attrs)
                        span.t1 = t1
                        item = span
                    self._ring.append(item)
                if buf.spans or buf.thread.is_alive():
                    live.append(buf)
                else:
                    # Dead and drained: fold its drop count into the
                    # collected total before letting it go.
                    self._buf_dropped_collected += buf.dropped
            self._bufs = live
            while len(self._ring) > self.capacity:
                self._ring.popleft()
                self._ring_dropped += 1

    def spans_snapshot(self) -> List[Span]:
        """Drained ring contents in start-time order (buffers from
        different threads interleave at drain; the flight recorder's
        tail must be the chronologically recent end)."""
        self.drain()
        with self._lock:
            return sorted(self._ring,
                          key=lambda s: (s.t0, s.span_id))

    def drain_take(self) -> List[Span]:
        """Drain AND consume as Span objects — the materializing
        convenience over drain_take_wire() (one consume
        implementation; this wrapper only shapes the result). Taken
        spans are not 'dropped' (they were delivered); the loss
        counters keep their meaning."""
        out = []
        for name, sid, parent, rid, kind, t0, t1, attrs in                 self.drain_take_wire():
            sp = Span(name, sid, parent, rid, t0, kind=kind,
                      attrs=attrs)
            sp.t1 = t1
            out.append(sp)
        return out

    def drain_take_wire(self) -> List[tuple]:
        """drain_take for the PER-STEP ship path: consume everything
        as wire-order tuples — (name, span_id, parent_id, request_id,
        kind, t0, t1, attrs), exactly the hot-path record format and
        exactly obs.xproc's wire layout — WITHOUT materializing Span
        objects that the next json.dumps would only take apart again.
        This runs once per worker step, so its cost is decode-loop
        overhead (priced by bench_serving section 10)."""
        with self._lock:
            out: List[tuple] = []
            live: List[_ThreadBuf] = []
            for buf in self._bufs:
                while True:
                    try:
                        item = buf.spans.popleft()
                    except IndexError:
                        break
                    if type(item) is tuple:
                        out.append(item)
                    else:
                        out.append((item.name, item.span_id,
                                    item.parent_id, item.request_id,
                                    item.kind, item.t0, item.t1,
                                    item.attrs))
                if buf.spans or buf.thread.is_alive():
                    live.append(buf)
                else:
                    self._buf_dropped_collected += buf.dropped
            self._bufs = live
            while True:
                try:
                    sp = self._ring.popleft()
                except IndexError:
                    break
                out.append((sp.name, sp.span_id, sp.parent_id,
                            sp.request_id, sp.kind, sp.t0, sp.t1,
                            sp.attrs))
        out.sort(key=lambda w: (w[5], w[1]))
        return out

    def dropped_total(self) -> int:
        """Monotonic count of spans lost to either bound (thread buffer
        overflow before a drain, or ring-capacity eviction). Drains
        first: every scrape-time reader then also moves spans off
        thread buffers and prunes dead threads' — without this, a
        server scraped only via /metrics (never /debug/*) would keep
        one _ThreadBuf per finished connection thread forever."""
        self.drain()
        with self._lock:
            return (self._ring_dropped + self._buf_dropped_collected
                    + sum(b.dropped for b in self._bufs))

    def decisions_snapshot(self) -> List[dict]:
        return list(self._decisions)

    def clear(self) -> None:
        """Drop all buffered spans and decisions (drop counters keep
        their totals — they are monotonic by contract)."""
        self.drain()
        with self._lock:
            self._ring.clear()
        self._decisions.clear()

    # -- query surface --------------------------------------------------------

    def request_spans(self, request_id: str) -> List[Span]:
        """Every span owned by the request (span.request_id) or linked
        to it (request_ids attr — shared spans like decode steps),
        PLUS the descendant closure of the linked set: a shard
        worker's ``shard.compute``/``shard.reduce_blocked`` spans
        carry no request id of their own — they parent on the
        coordinator's ``shard.step`` span, which carries the occupant
        list — so the tree walks down through parent links to pull
        them in (one snapshot; closure is bounded by tree depth)."""
        snapshot = self.spans_snapshot()
        out: List[Span] = []
        have: set = set()
        rest: List[Span] = []
        for sp in snapshot:
            linked = sp.attrs.get("request_ids") if sp.attrs else None
            if sp.request_id == request_id or (
                    linked and request_id in linked):
                out.append(sp)
                have.add(sp.span_id)
            else:
                rest.append(sp)
        changed = bool(have)
        while changed and rest:
            changed = False
            keep = []
            for sp in rest:
                if sp.parent_id in have:
                    out.append(sp)
                    have.add(sp.span_id)
                    changed = True
                else:
                    keep.append(sp)
            rest = keep
        return out

    def recent_requests(self, limit: int = 20) -> List[dict]:
        """The /debug/traces discoverability listing: the most
        recently active request ids still in the ring, newest first,
        each with its span count and activity window — the handles an
        operator who doesn't have an X-Request-Id in hand can start
        from."""
        info: Dict[str, dict] = {}
        for sp in self.spans_snapshot():
            rid = sp.request_id
            if rid is None:
                continue
            d = info.get(rid)
            if d is None:
                d = info[rid] = {"request_id": rid, "spans": 0,
                                 "t0": sp.t0, "t_last": sp.t1}
            d["spans"] += 1
            d["t0"] = min(d["t0"], sp.t0)
            d["t_last"] = max(d["t_last"], sp.t1)
        out = sorted(info.values(), key=lambda d: d["t_last"],
                     reverse=True)[:max(1, int(limit))]
        for d in out:
            d["t0"] = round(d["t0"], 6)
            d["t_last"] = round(d["t_last"], 6)
        return out

    def span_tree(self, request_id: str) -> dict:
        """JSON-ready span tree for one request: parent_id nesting
        where it exists; spans with no in-set parent (shared step
        spans, supervisor spans) attach under the request root as
        linked children, ordered by start time."""
        spans = sorted(self.request_spans(request_id),
                       key=lambda s: (s.t0, s.span_id))
        nodes: Dict[str, dict] = {}
        for sp in spans:
            node = sp.to_dict()
            node["children"] = []
            nodes[sp.span_id] = node
        roots: List[dict] = []
        for sp in spans:
            node = nodes[sp.span_id]
            parent = nodes.get(sp.parent_id) if sp.parent_id else None
            if parent is not None and parent is not node:
                parent["children"].append(node)
            else:
                roots.append(node)
        # The handler's root request span adopts every parentless
        # linked span (decode steps, supervisor recovery) so the tree
        # reads as one timeline.
        req_root = next((n for n in roots
                         if n["name"] == "request"
                         and n["request_id"] == request_id), None)
        if req_root is not None:
            for n in roots:
                if n is not req_root:
                    n["linked"] = True
                    req_root["children"].append(n)
            req_root["children"].sort(key=lambda n: n["t0"])
            roots = [req_root]
        return {
            "request_id": request_id,
            "span_count": len(spans),
            "tree": roots,
        }


# -- process-global tracer -----------------------------------------------------
#
# Always installed (tracing is always-on by contract); faults.py and the
# fabric transport record here, and ServingServer defaults to it so a
# fault fired on a device-worker thread lands in the same timeline the
# flight recorder snapshots. Tests wanting isolation use scoped().

_tracer = Tracer()
_tracer_lock = threading.Lock()


def get_tracer() -> Tracer:
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    global _tracer
    with _tracer_lock:
        _tracer = tracer
        return _tracer


@contextmanager
def scoped(tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
    """``with obs.trace.scoped() as tr:`` — install a fresh global
    tracer for a scope, always restore (a leaked tracer would bleed
    spans across tests)."""
    prev = get_tracer()
    t = set_tracer(tracer if tracer is not None else Tracer())
    try:
        yield t
    finally:
        set_tracer(prev)


def event(name: str, request_id: Optional[str] = None,
          parent_id: Optional[str] = None,
          attrs: Optional[dict] = None) -> Optional[Any]:
    """Module-level convenience over the global tracer (the faults
    seam's one-liner)."""
    return _tracer.event(name, request_id=request_id,
                         parent_id=parent_id, attrs=attrs)
