"""Cross-process tracing: span shipping + clock alignment.

The tracing plane (``trace.py``) is process-local, and the fabric-sharded
decode path runs in shard subprocesses. This module is what lets a span
tree cross that boundary, Dapper-style, with ZERO extra protocol round
trips:

  * **context propagation** — the coordinator ships a ``trace_parent``
    span id inside the control frames it already sends (the framed-JSON
    step message, the fabric ``_HELLO``); workers parent their local
    spans on it. Old workers ignore the extra field.
  * **span shipping** — a worker buffers its finished spans in a
    bounded :class:`SpanShip` (losses counted, same tuple discipline as
    trace.py) and piggybacks the buffer onto the reply frames it
    already sends. The coordinator ingests them into its own tracer
    (``Tracer.ingest``) with remapped span ids.
  * **clock alignment** — every process stamps ``time.monotonic()``,
    and monotonic clocks do not share a zero across processes (they do
    on Linux, but the design must hold for pods on different hosts).
    :class:`ClockSync` estimates the per-worker offset from the
    request/reply timestamps the protocol already carries — the
    NTP/Cristian four-timestamp midpoint method — and every foreign
    span is shifted onto the coordinator's axis and STAMPED with the
    offset and its uncertainty, so "A happened before B" claims across
    processes are made only to the precision the estimate supports.

Like the rest of obs/, stdlib-only by contract (the shard worker and
the coordinator both import this; neither should pay a numpy import
for tracing).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Tuple

from .trace import Span

# What a worker ships by default: the shard-plane taxonomy, the ring
# rendezvous, and fault firings. Per-chunk fabric.send/recv spans stay
# worker-local by design — at wire speed they arrive thousands per
# second and would evict everything else out of the bounded ship
# buffer (an operator who wants them reads the worker's own log).
SHIP_PREFIXES = ("shard.",)
SHIP_NAMES = ("fabric.connect", "fault.fired")


def ship_default(name: str) -> bool:
    return name.startswith(SHIP_PREFIXES) or name in SHIP_NAMES


def wire_span(span: Span) -> list:
    """One finished span as a JSON-able list, field order matching the
    tracer's hot-path tuple: [name, span_id, parent_id, request_id,
    kind, t0, t1, attrs]. ``parent_id`` here is a LOCAL id (this
    process's counter); a parent living in the COORDINATOR's id space
    rides ``attrs["xparent"]`` instead — the two spaces collide
    numerically, so the wire format keeps them apart structurally."""
    return [span.name, span.span_id, span.parent_id, span.request_id,
            span.kind, round(span.t0, 6), round(span.t1, 6),
            span.attrs]


class SpanShip:
    """A worker's bounded outbound span buffer. ``harvest()`` empties
    the process tracer into it (filtered); ``flush()`` hands the
    accumulated wire spans to the caller assembling a reply frame.
    Spans that arrive while the buffer is at capacity are dropped and
    COUNTED — the coordinator re-exports the total, so piggyback loss
    under pressure is a visible number, never silence."""

    def __init__(self, cap: int = 512, ship=ship_default):
        self.cap = int(cap)
        self.ship = ship
        self._lock = threading.Lock()
        self._buf: deque = deque()
        self.dropped_total = 0

    def harvest(self, tracer) -> int:
        """Drain every finished span out of ``tracer`` (consuming its
        ring) and buffer the shippable ones. Returns how many were
        buffered. Rides the tracer's wire-tuple fast path — the
        hot-path record format IS the wire layout, so nothing is
        materialized per span on the way to the reply frame."""
        n = 0
        wires = tracer.drain_take_wire()
        with self._lock:
            for w in wires:
                if not self.ship(w[0]):
                    continue
                if len(self._buf) >= self.cap:
                    self.dropped_total += 1
                    continue
                self._buf.append(w)
                n += 1
        return n

    def flush(self) -> List[list]:
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
        return out

    def __len__(self) -> int:
        return len(self._buf)


class ClockSync:
    """Per-peer monotonic clock offset from protocol round trips.

    Four timestamps per exchange, all ``time.monotonic()``: the
    coordinator sends at ``t_tx_local``, the worker receives the frame
    at ``t_rx_remote`` and replies at ``t_tx_remote``, the coordinator
    receives the reply at ``t_rx_local``. The midpoint estimate
    (NTP's) of ``offset = remote_clock - local_clock``:

        offset      = ((t_rx_remote - t_tx_local)
                       + (t_tx_remote - t_rx_local)) / 2
        uncertainty = ((t_rx_local - t_tx_local)
                       - (t_tx_remote - t_rx_remote)) / 2

    The uncertainty is HALF the un-accounted wire time: the true
    offset provably lies within ±uncertainty of the estimate under any
    split of that time between the two directions (asymmetric delay
    biases the midpoint but never past the bound). The step exchange's
    processing time sits between the remote stamps, so it never
    inflates the bound — only genuine queuing/wire time does.

    Samples are windowed (``window`` most recent, the "re-estimated
    per N steps" contract): the published estimate is the
    minimum-uncertainty sample still in the window, so a transient
    scheduling stall poisons at most ``window`` steps and a drifting
    clock cannot pin an ancient tight sample forever."""

    def __init__(self, window: int = 64):
        self.window = int(window)
        self._samples: deque = deque(maxlen=self.window)
        # Cached window minimum, maintained incrementally: estimate()
        # runs once per rank per step on the collect leg, and a
        # min-scan over the window there would be pure per-step
        # overhead (section 10 prices this path).
        self._best = None

    def observe(self, t_tx_local: float, t_rx_remote: float,
                t_tx_remote: float, t_rx_local: float) -> None:
        rtt_net = ((t_rx_local - t_tx_local)
                   - (t_tx_remote - t_rx_remote))
        if rtt_net < 0:
            # A reply cannot arrive before its request net of remote
            # processing: one of the stamps is garbage — skip.
            return
        offset = ((t_rx_remote - t_tx_local)
                  + (t_tx_remote - t_rx_local)) / 2.0
        sample = (rtt_net / 2.0, offset)
        evicted = (self._samples[0]
                   if len(self._samples) == self._samples.maxlen
                   else None)
        # deque(maxlen) append is the windowing AND the thread
        # discipline: an atomic container op, no RMW state.
        self._samples.append(sample)
        best = self._best
        if best is None or sample < best:
            self._best = sample
        elif evicted is not None and evicted == best:
            # The cached minimum just aged out: one rescan, amortized
            # over the window length.
            self._best = min(self._samples)

    @property
    def ready(self) -> bool:
        return bool(self._samples)

    @property
    def estimate(self) -> Tuple[float, float]:
        """(offset, uncertainty); (0.0, inf) before any sample — a
        caller aligning spans with no estimate must say so loudly."""
        if self._best is None:
            return 0.0, float("inf")
        unc, off = self._best
        return off, unc

    def to_local(self, t_remote: float) -> float:
        off, _unc = self.estimate
        return t_remote - off


def federate_labels(rank, codec: str, replica: str) -> Dict[str, str]:
    """The label set every re-exported worker series carries: a
    quantized replica's series must never aggregate with an fp32
    one's, and per-rank resolution is the whole point."""
    return {"rank": str(rank), "codec": codec, "replica": replica}
