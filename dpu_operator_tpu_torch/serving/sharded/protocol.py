"""Coordinator↔shard control protocol: framed JSON + raw payload.

One frame = ``!II`` header (json length, payload length) + UTF-8 JSON
object + optional raw array bytes. The control plane is deliberately
tiny (reset/step/tokens/close); the BULK bytes of a sharded step are
the collective's, and those ride parallel/fabric_collectives between
the shards directly — the coordinator only ever moves scatter updates
in and token ids out.

Cross-process tracing rides these SAME frames — the JSON
object is free-form, so every field below is ignored by a worker (or
coordinator) that predates it, and none adds a round trip:

  * step msg → worker: ``trace_parent`` — the coordinator's reserved
    ``shard.step`` span id; the worker's ``shard.compute`` parents on
    it (as ``attrs["xparent"]`` — coordinator ids must never ride a
    worker span's local ``parent_id``, the id spaces collide).
  * every reply ← worker: ``t_rx``/``t_tx`` — the worker's monotonic
    receive/reply stamps, completing the NTP four-timestamp exchange
    the coordinator's ClockSync estimates clock offsets from.
  * tokens reply ← worker: ``spans`` (obs.xproc wire lists from the
    bounded SpanShip buffer), ``spans_dropped`` (its cumulative
    overflow counter), and — every ``--metrics-interval`` steps —
    ``metrics`` (a Registry.federated_snapshot() the coordinator
    re-exports rank/codec-labelled).

Every receive here takes a mandatory ``timeout`` and arms it on the
socket before reading (the GL010 discipline: a dead or wedged peer
surfaces as ``socket.timeout``/``ProtocolError`` in bounded time,
never an unbounded block the watchdog cannot attribute)."""

from __future__ import annotations

import json
import socket
import struct
import time
from typing import Optional, Tuple

_HDR = struct.Struct("!II")
_MAX_JSON = 1 << 20
_MAX_PAYLOAD = 1 << 28


class ProtocolError(RuntimeError):
    """Framing violation or peer gone mid-frame."""


def send_msg(sock: socket.socket, obj: dict, *parts) -> None:
    """One frame. ``parts`` are bytes-like payload pieces — bytes, a
    memoryview, or any buffer-protocol object (a contiguous numpy
    array passes as-is). Each part is written straight from its own
    memory, never concatenated into a fresh buffer: the bulk payload
    of a step/tokens frame must not pay a ``tobytes()`` copy in the
    per-step hot loop (the GL011 contract). Callers that interleave
    small frames on a long-lived control socket arm TCP_NODELAY at
    connect so the header write and a small payload part never sit
    out a Nagle/delayed-ACK exchange."""
    views = []
    total = 0
    for p in parts:
        v = p if isinstance(p, memoryview) else memoryview(p)
        if v.nbytes == 0:
            continue  # empty parts frame as zero bytes (cast chokes)
        if v.format != "B":
            v = v.cast("B")
        views.append(v)
        total += len(v)
    body = json.dumps(obj).encode()
    sock.sendall(_HDR.pack(len(body), total) + body)
    for v in views:
        if len(v):
            sock.sendall(v)


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float]) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    while len(view):
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("frame deadline expired mid-read")
            sock.settimeout(remaining)
        got = sock.recv_into(view)
        if got == 0:
            raise ProtocolError("peer closed mid-frame")
        view = view[got:]
    return bytes(buf)


def recv_msg(sock: socket.socket,
             timeout: Optional[float]) -> Tuple[dict, bytes]:
    """One frame, or raise inside `timeout` seconds (socket.timeout on
    silence, ProtocolError on a torn frame). The timeout is a deadline
    over the WHOLE frame, re-armed before every recv — a sick peer
    dripping one byte per near-timeout interval cannot stretch one
    receive to timeout x bytes. `timeout=None` is an explicit caller
    decision, not a default."""
    deadline = (None if timeout is None
                else time.monotonic() + timeout)
    if timeout is None:
        sock.settimeout(None)
    hdr = _recv_exact(sock, _HDR.size, deadline)
    jlen, plen = _HDR.unpack(hdr)
    if jlen > _MAX_JSON or plen > _MAX_PAYLOAD:
        raise ProtocolError(f"oversized frame (json={jlen} "
                            f"payload={plen})")
    obj = json.loads(_recv_exact(sock, jlen, deadline).decode())
    payload = _recv_exact(sock, plen, deadline) if plen else b""
    return obj, payload
