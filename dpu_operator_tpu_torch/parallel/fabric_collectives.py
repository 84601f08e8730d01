"""Chunked, pipelined ring allreduce over the operator-built pod fabric.

A copy of the JAX package's ``parallel/fabric_collectives.py``, statement
for statement; the module never touches a card or jax. The fabric-sharded
serving plane's shard workers reduce over it (``serving/sharded``), and
the context-parallel KV plane takes its even partition
(``_segment_bounds``) and its typed ``CodecMismatch``.

  * ``RingTransport`` owns raw TCP sockets between ring neighbours —
    ``streams`` connections per direction, ``SO_SNDBUF``/``SO_RCVBUF``
    raised so the kernel keeps the pipe full while userspace reduces,
    ``TCP_NODELAY`` so segment boundaries never stall on Nagle.
  * ``allreduce`` is the textbook segmented ring (reduce-scatter +
    all-gather, 2(n-1) steps, each rank moving 2(n-1)/n · D wire bytes)
    with send ∥ recv, recv ∥ reduce (chunk granularity) and slice ∥
    slice (one worker thread pair per stream) overlapped.
  * ``exchange`` moves the same wire bytes through the same
    socket/step/chunk structure with the reduce deleted — the raw
    transport ceiling for the ring pattern.
  * ``codec=`` quantizes the WIRE only: int8 (4x fewer bytes) / bf16
    (2x) per-chunk codecs from ``parallel/quantize.py``, every reduce in
    fp32 after decode, the hello handshake refusing mixed-codec rings
    typed, and per-chunk frames carrying scale + dtype. Reported Gb/s
    keeps the fp32-equivalent denominator.

The CLI entry point (``main``) runs one rank and prints a single JSON
result line. Tuning knobs are env-overridable (``DPU_RING_STREAMS``,
``DPU_RING_CHUNK_KB``, ``DPU_RING_SOCKBUF_KB``).
"""

from __future__ import annotations

import json
import os
import random
import socket
import struct
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import faults
from ..obs import trace as obs_trace
from . import quantize
from .quantize import FRAME_HEADER

# Measured on the veth fabric (16 MiB fp32, 2 ranks, 2-cpu node — the
# CI/bench class): the collective is CPU-bound there, not wire-bound
# (one-directional python TCP does 21 Gb/s; the bidirectional ring
# pattern's ceiling is ~7 Gb/s/direction), so FEWER threads win —
# 1 stream allreduces at ~3.7 Gb/s vs ~2.6 with 2 streams (repeated
# quiet-box runs), and raw exchange shows the same ordering (5.4 vs
# 4.3). The streams knob stays for CPU-rich hosts where the extra
# sockets can overlap instead of contend. 1 MiB chunks are small
# enough that the kernel buffer (4 MiB) hides a whole reduce, large
# enough that syscall count doesn't dominate (512 KiB measured worse).
DEFAULT_STREAMS = int(os.environ.get("DPU_RING_STREAMS", "1"))
DEFAULT_CHUNK_BYTES = int(os.environ.get("DPU_RING_CHUNK_KB", "1024")) << 10
DEFAULT_SOCKBUF = int(os.environ.get("DPU_RING_SOCKBUF_KB", "4096")) << 10
# (rank, stream index, codec id, trace parent span id; 0 = none).
# The trace parent is the coordinator-space span id the
# ring session parents its fabric.connect spans on — it rides the
# hello so every ring member agrees on the session root even when
# only some were spawned with it.
_HELLO = struct.Struct("!IIIQ")


class RingError(RuntimeError):
    """Transport setup/exchange failure — callers fall back to gloo."""


class CodecMismatch(RingError):
    """The two ends of a ring link disagree on the wire codec. Caught
    at hello time (before any payload moves) so a misconfigured rank
    fails typed instead of decoding int8 bytes as floats."""


class FabricConnectError(RingError):
    """Ring dial never reached the peer inside the deadline. Carries
    the peer address (the thing the operator needs to go look at) and
    the attempt count (which proves the retry loop backed off instead
    of busy-spinning through the deadline)."""

    def __init__(self, rank: int, peer: Tuple[str, int], attempts: int,
                 elapsed_s: float):
        super().__init__(
            f"rank {rank}: peer {peer[0]}:{peer[1]} never came up "
            f"({attempts} dial attempts over {elapsed_s:.2f}s)")
        self.peer = peer
        self.attempts = attempts


# Dial-retry backoff: exponential from base to cap, with jitter so a
# pod-wide restart doesn't re-dial in lockstep (the retry-storm shape
# SRE backoff exists to kill). The cap keeps worst-case added latency
# past the peer's come-up to one beat.
_DIAL_BACKOFF_BASE_S = 0.05
_DIAL_BACKOFF_CAP_S = 1.0


def _segment_bounds(n_elems: int, world: int) -> List[Tuple[int, int]]:
    """Even contiguous partition of [0, n_elems) into `world` segments
    (first n_elems % world segments get the extra element)."""
    base, rem = divmod(n_elems, world)
    bounds, off = [], 0
    for r in range(world):
        size = base + (1 if r < rem else 0)
        bounds.append((off, off + size))
        off += size
    return bounds


def _tune(sock: socket.socket, sockbuf: int) -> None:
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, sockbuf)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, sockbuf)


def _recv_exact(sock: socket.socket, view: memoryview) -> None:
    while len(view):
        n = sock.recv_into(view)
        if n == 0:
            raise RingError("peer closed mid-transfer")
        view = view[n:]


class RingTransport:
    """Raw-socket ring between `world` processes, one fabric address
    each. Rank r SENDS to rank (r+1) % world on `streams` dialled
    connections and RECEIVES from rank (r-1) % world on `streams`
    accepted connections — send and recv never share a socket, so the
    two directions overlap for free on the full-duplex veth."""

    def __init__(self, rank: int, world: int, bind_ip: str,
                 peer_ips: Sequence[str], port: int = 9411,
                 streams: int = DEFAULT_STREAMS,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 sockbuf: int = DEFAULT_SOCKBUF,
                 io_timeout: float = 120.0,
                 codec: Optional[str] = None,
                 error_feedback: bool = False,
                 trace_parent: Optional[int] = None):
        if world < 1 or not (0 <= rank < world):
            raise RingError(f"bad ring shape rank={rank} world={world}")
        if len(peer_ips) != world:
            raise RingError(
                f"need {world} peer ips (indexed by rank), got {len(peer_ips)}")
        self.rank, self.world = rank, world
        self.bind_ip, self.port = bind_ip, port
        # A peer entry is "ip" (ring-wide port) or "ip:port" (per-rank
        # override — lets tests stack several ranks on loopback where
        # all ranks share one address).
        self.peer_addrs: List[Tuple[str, int]] = []
        for spec in peer_ips:
            ip, _, p = str(spec).partition(":")
            self.peer_addrs.append((ip, int(p) if p else port))
        self.streams = max(1, streams)
        self.chunk_bytes = max(64 << 10, chunk_bytes)
        self.sockbuf = sockbuf
        # Data-socket timeout: a peer that stalls (or dies without
        # closing) must surface as RingError — the documented
        # fall-back-to-gloo signal — not hang the worker until some
        # outer process timeout kills it.
        self.io_timeout = io_timeout
        # Wire codec (quantized collectives): opt-in per
        # transport — None/"fp32" keeps the raw zero-copy path
        # byte-for-byte, int8/bf16 quarter/halve the wire bytes. The
        # hello handshake carries the codec id so mixed-codec rings
        # fail typed at connect, before any payload moves.
        self.codec = quantize.get_codec(codec)
        self.codec_name = self.codec.name if self.codec else "fp32"
        self._ef = (quantize.ErrorFeedback(self.codec)
                    if error_feedback and self.codec else None)
        self._codec_id = self.codec.codec_id if self.codec else 0
        # Coordinator-space parent for this session's connect span
        # (cross-process tracing). It lives in ANOTHER process's id
        # space, so the
        # span carries it as attrs["xparent"] (the obs.xproc wire
        # convention), never as parent_id.
        self.trace_parent = (int(trace_parent)
                             if trace_parent else None)
        self._rx_tls = threading.local()
        self._send: List[socket.socket] = []
        self._recv: List[socket.socket] = []
        self._listener: Optional[socket.socket] = None
        self._dial_attempts = 0

    # -- wiring ----------------------------------------------------------

    def connect(self, timeout: float = 30.0) -> None:
        """Listen, dial next, accept from prev. Safe to call on every
        rank concurrently: listeners come up before any dial is retried,
        and dials back off until the peer's listener exists. On failure
        every socket opened so far is closed before the raise — the
        caller falls back to gloo in the same process, so a leaked
        listener would squat the ring port for the process lifetime."""
        if self.world == 1:
            return
        tr = obs_trace.get_tracer()
        t0 = time.monotonic()
        try:
            self._connect(timeout)
        except BaseException as e:
            attrs = {"rank": self.rank, "world": self.world,
                     "ok": False, "error": str(e)[:200]}
            if self.trace_parent:
                attrs["xparent"] = self.trace_parent
            tr.record_span("fabric.connect", t0, time.monotonic(),
                           attrs=attrs)
            self.close()
            raise
        attrs = {"rank": self.rank, "world": self.world, "ok": True,
                 "dial_attempts": self._dial_attempts}
        if self.trace_parent:
            attrs["xparent"] = self.trace_parent
        tr.record_span("fabric.connect", t0, time.monotonic(),
                       attrs=attrs)

    def _connect(self, timeout: float) -> None:
        nxt = self.peer_addrs[(self.rank + 1) % self.world]
        prev_rank = (self.rank - 1) % self.world
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.bind_ip, self.peer_addrs[self.rank][1]))
        self._listener.listen(self.streams + 2)
        self._listener.settimeout(timeout)

        t_start = time.monotonic()
        deadline = t_start + timeout
        dial_rng = random.Random(self.rank * 7919 + self.port)
        attempts = 0
        for idx in range(self.streams):
            backoff = _DIAL_BACKOFF_BASE_S
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise FabricConnectError(
                        self.rank, nxt, attempts,
                        time.monotonic() - t_start)
                s = socket.socket()
                _tune(s, self.sockbuf)
                # Bound the dial by the REMAINING deadline: a blackholed
                # SYN (peer veth down, no RST) otherwise blocks for the
                # kernel's full syn-retry cycle (~2 min), blowing way
                # past the connect contract while refused-instantly is
                # the only failure the deadline check would ever see.
                s.settimeout(max(0.05, remaining))
                try:
                    attempts += 1
                    faults.fire("fabric.connect")
                    s.connect(nxt)
                    break
                except OSError:
                    # Refused-instantly must not burn the deadline in a
                    # hot loop: exponential backoff (doubling to the
                    # cap) with jitter, clamped to the remaining budget
                    # so the expiry check above stays authoritative.
                    s.close()
                    delay = min(backoff * dial_rng.uniform(0.5, 1.0),
                                max(0.0, deadline - time.monotonic()))
                    if delay > 0:
                        time.sleep(delay)
                    backoff = min(backoff * 2, _DIAL_BACKOFF_CAP_S)
            s.settimeout(self.io_timeout)
            # Track BEFORE the hello write: a peer that accepts the
            # dial then dies mid-hello raises out of sendall, and an
            # untracked socket would leak through the close() the
            # connect() wrapper runs on failure.
            self._send.append(s)
            s.sendall(_HELLO.pack(self.rank, idx, self._codec_id,
                                  self.trace_parent or 0))
        self._dial_attempts = attempts

        accepted: dict = {}
        try:
            while len(accepted) < self.streams:
                c, _ = self._listener.accept()
                try:
                    _tune(c, self.sockbuf)
                    c.settimeout(self.io_timeout)
                    hello = bytearray(_HELLO.size)
                    _recv_exact(c, memoryview(hello))
                    peer, idx, peer_codec, peer_tp = \
                        _HELLO.unpack(bytes(hello))
                except BaseException:
                    c.close()
                    raise
                if peer == prev_rank and peer_codec != self._codec_id:
                    # Typed refusal BEFORE any payload: decoding a
                    # peer's int8 bytes as fp32 is silent corruption.
                    c.close()
                    raise CodecMismatch(
                        f"rank {self.rank} ({self.codec_name}): peer "
                        f"rank {peer} dialled in with codec id "
                        f"{peer_codec} — every ring member must run "
                        f"the same wire codec")
                if peer != prev_rank or idx in accepted:
                    c.close()
                    continue
                if self.trace_parent is None and peer_tp:
                    # Adopt the session root from a peer that has one:
                    # the ring's connect spans all hang off the same
                    # coordinator span regardless of which rank the
                    # coordinator handed the id to.
                    self.trace_parent = peer_tp
                accepted[idx] = c
        except BaseException as e:
            # Any accept-phase failure (timeout, half-sent hello, …)
            # must release every socket taken so far — the caller keeps
            # living in this process on the gloo fallback.
            for s in accepted.values():
                s.close()
            if isinstance(e, socket.timeout):
                raise RingError(
                    f"rank {self.rank}: prev rank {prev_rank} "
                    f"never dialled in")
            raise
        self._recv = [accepted[i] for i in range(self.streams)]

    def close(self) -> None:
        """Release every socket, including on a PARTIALLY-connected
        transport (dial done, accept pending/failed). Detach-then-close
        so a second close (or one racing connect's own failure path)
        finds empty lists instead of double-closing, and the listener
        closes even if a data socket's close raises — a leaked
        listener squats the ring port for the process lifetime."""
        send, recv = self._send, self._recv
        listener, self._listener = self._listener, None
        self._send, self._recv = [], []
        for s in send + recv + ([listener] if listener else []):
            try:
                s.close()
            except OSError:
                pass

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *exc):
        self.close()

    # -- data movement ---------------------------------------------------
    #
    # The whole 2(n-1)-step schedule runs as ONE continuous flow: a
    # persistent sender thread and receiver thread (per stream) walk the
    # schedule with per-chunk dependency events instead of per-step
    # barriers. This matters measurably: step barriers leave the sockets
    # idle between 2·payload/n bursts, so every step re-enters TCP
    # slow-start (net.ipv4.tcp_slow_start_after_idle=1 is the kernel
    # default) and re-pays thread spawn latency — the flow rewrite
    # moved the raw exchange 4.0 → 5.4 Gb/s on the 2-cpu veth fabric
    # (quiet-box repeats; per-step-barrier numbers for the same
    # schedule, payload, and sockets). The data
    # dependency that remains is real and chunk-granular: schedule item
    # k forwards exactly the segment item k-1 received (rs and ag
    # included, across the phase boundary too), so send(k, chunk c)
    # waits only on recv(k-1, chunk c)'s event.

    def _schedule(self) -> List[Tuple[int, int, bool]]:
        """(send_seg, recv_seg, reduce_in) per ring step: n-1
        reduce-scatter steps then n-1 all-gather steps."""
        n, r = self.world, self.rank
        items = [((r - s) % n, (r - s - 1) % n, True) for s in range(n - 1)]
        items += [((r - s + 1) % n, (r - s) % n, False)
                  for s in range(n - 1)]
        return items

    def _run(self, flat: np.ndarray, scratch: np.ndarray,
             do_reduce: bool) -> None:
        if self.world == 1:
            return
        itemsize = flat.itemsize
        chunk_elems = max(1, self.chunk_bytes // itemsize)
        seg = _segment_bounds(flat.size, self.world)
        items = self._schedule()

        def chunks(bounds: Tuple[int, int]) -> List[Tuple[int, int]]:
            lo, hi = bounds
            return [(a, min(a + chunk_elems, hi))
                    for a in range(lo, hi, chunk_elems)] or [(lo, hi)]

        # events[k][c] fires when recv item k's chunk c is in `flat`
        # (reduced or written through) — the send-side dependency.
        events = [[threading.Event() for _ in chunks(seg[rcv])]
                  for (_snd, rcv, _red) in items]
        flat_raw = flat.view(np.uint8)
        scratch_raw = scratch.view(np.uint8)
        errors: List[BaseException] = []
        tr = obs_trace.get_tracer()

        def sender(stream: int) -> None:
            try:
                sock = self._send[stream]
                traced = tr.enabled
                for k, (snd, _rcv, _red) in enumerate(items):
                    cl = chunks(seg[snd])
                    for c in range(stream, len(cl), self.streams):
                        if k > 0 and not events[k - 1][c].wait(60.0):
                            raise RingError(
                                f"rank {self.rank}: stalled waiting for "
                                f"step {k - 1} chunk {c}")
                        lo, hi = cl[c]
                        faults.fire("fabric.send")
                        ts = time.monotonic() if traced else 0.0
                        sock.sendall(
                            memoryview(flat_raw)[lo * itemsize:hi * itemsize])
                        if traced:
                            tr.record_span(
                                "fabric.send", ts, time.monotonic(),
                                attrs={"rank": self.rank,
                                       "stream": stream, "step": k,
                                       "chunk": c,
                                       "bytes": (hi - lo) * itemsize})
            except BaseException as e:
                errors.append(e)

        def receiver(stream: int) -> None:
            try:
                sock = self._recv[stream]
                traced = tr.enabled
                for k, (_snd, rcv, red) in enumerate(items):
                    cl = chunks(seg[rcv])
                    for c in range(stream, len(cl), self.streams):
                        lo, hi = cl[c]
                        span = memoryview(
                            scratch_raw if (do_reduce and red) else flat_raw
                        )[lo * itemsize:hi * itemsize]
                        ts = time.monotonic() if traced else 0.0
                        _recv_exact(sock, span)
                        if traced:
                            tr.record_span(
                                "fabric.recv", ts, time.monotonic(),
                                attrs={"rank": self.rank,
                                       "stream": stream, "step": k,
                                       "chunk": c,
                                       "bytes": (hi - lo) * itemsize})
                        if do_reduce and red:
                            np.add(flat[lo:hi], scratch[lo:hi],
                                   out=flat[lo:hi])
                        events[k][c].set()
            except BaseException as e:
                errors.append(e)
                # Unblock the sender: it will fail on its own socket (or
                # finish) instead of waiting the full stall timeout.
                for ev_row in events:
                    for ev in ev_row:
                        ev.set()

        self._spawn_join([(fn, i) for i in range(self.streams)
                          for fn in (sender, receiver)], errors)

    def _pair_run(self, flat: np.ndarray, scratch: np.ndarray,
                  do_reduce: bool) -> None:
        """world == 2 fast path, picked by measurement: the ring's wire
        cost 2(n-1)/n · D degenerates to exactly D at n=2, so a direct
        full-payload exchange moves the SAME bytes as reduce-scatter +
        all-gather — but in one dependency-free phase instead of two
        chained ones. On the 2-cpu fabric that is worth ~1.8× (the
        2-step schedule allreduces at ~2.0 Gb/s, this path at ~3.7: the
        chunk dependency chain costs an event wakeup per chunk on the
        critical path; here both directions stream flat out). Each side
        sends its whole buffer while reducing the peer's incoming
        chunks into its own."""
        itemsize = flat.itemsize
        chunk_elems = max(1, self.chunk_bytes // itemsize)
        cl = [(a, min(a + chunk_elems, flat.size))
              for a in range(0, flat.size, chunk_elems)] or [(0, flat.size)]
        flat_raw = flat.view(np.uint8)
        scratch_raw = scratch.view(np.uint8)
        # The reduce writes flat[c] in place, and flat[c] is also the
        # send source — a chunk must be ON THE WIRE before it may be
        # overwritten. The sender is never itself blocked on these
        # events and the peer's copy must cross the wire first, so the
        # receiver's wait is almost always already satisfied.
        sent = [threading.Event() for _ in cl]
        errors: List[BaseException] = []
        tr = obs_trace.get_tracer()

        def sender(stream: int) -> None:
            try:
                sock = self._send[stream]
                traced = tr.enabled
                for c in range(stream, len(cl), self.streams):
                    lo, hi = cl[c]
                    faults.fire("fabric.send")
                    ts = time.monotonic() if traced else 0.0
                    sock.sendall(
                        memoryview(flat_raw)[lo * itemsize:hi * itemsize])
                    if traced:
                        tr.record_span(
                            "fabric.send", ts, time.monotonic(),
                            attrs={"rank": self.rank, "stream": stream,
                                   "chunk": c,
                                   "bytes": (hi - lo) * itemsize})
                    sent[c].set()
            except BaseException as e:
                errors.append(e)
                for ev in sent:
                    ev.set()

        def receiver(stream: int) -> None:
            try:
                sock = self._recv[stream]
                traced = tr.enabled
                for c in range(stream, len(cl), self.streams):
                    lo, hi = cl[c]
                    ts = time.monotonic() if traced else 0.0
                    _recv_exact(sock, memoryview(scratch_raw)
                                [lo * itemsize:hi * itemsize])
                    if traced:
                        tr.record_span(
                            "fabric.recv", ts, time.monotonic(),
                            attrs={"rank": self.rank, "stream": stream,
                                   "chunk": c,
                                   "bytes": (hi - lo) * itemsize})
                    if do_reduce:
                        if not sent[c].wait(60.0):
                            raise RingError(
                                f"rank {self.rank}: send of chunk {c} "
                                f"stalled")
                        np.add(flat[lo:hi], scratch[lo:hi], out=flat[lo:hi])
            except BaseException as e:
                errors.append(e)

        self._spawn_join([(fn, i) for i in range(self.streams)
                          for fn in (sender, receiver)], errors)

    # -- quantized data movement -----------------------------------------
    #
    # Same schedule, same per-chunk dependency events, same per-stream
    # sender/receiver pair — with a codec squeezed between the reduce
    # and the wire. The pipelining premise carries over unchanged:
    # encode runs in the sender thread while the previous chunk is in
    # the kernel buffer, decode+add runs in the receiver thread while
    # the next chunk is in flight (numpy releases the GIL for both).
    # Chunking is sized in WIRE bytes (chunk_bytes // wire_itemsize
    # elements per chunk), so an int8 ring moves the same ~1 MiB bursts
    # the fp32 ring was tuned for while covering 4x the elements per
    # chunk — the striping answer to half-size (and quarter-size)
    # chunks. Every reduce is fp32-after-decode; the quantized domain
    # is wire-only.
    #
    # Bit-identity across ranks (the sharded-serving replicated-state
    # contract): in the reduce-scatter phase each segment's partial sum
    # is re-encoded per hop, but exactly ONE rank (the segment owner)
    # ever holds the final fp32 sum — it encodes once for the
    # all-gather, writes the decode of its OWN encoding back into its
    # buffer, and every later hop forwards those same wire bytes
    # verbatim. All ranks therefore decode identical bytes and land on
    # identical floats.

    def _codec_chunks(self, bounds: Tuple[int, int]
                      ) -> List[Tuple[int, int]]:
        lo, hi = bounds
        step = max(1, self.chunk_bytes // self.codec.wire_itemsize)
        return [(a, min(a + step, hi))
                for a in range(lo, hi, step)] or [(lo, hi)]

    def _send_frame(self, sock: socket.socket, scale: float,
                    payload) -> None:
        sock.sendall(self.codec.frame_header(scale))
        view = payload if isinstance(payload, memoryview) \
            else memoryview(payload)
        if view.format != "B":
            view = view.cast("B")
        if len(view):
            sock.sendall(view)

    def _recv_frame(self, sock: socket.socket, n_elems: int,
                    fresh: bool = True):
        """Receive one codec frame. The returned buffer IS the decode
        source (np.frombuffer — no bytes() copy on the per-chunk
        path). ``fresh=False`` receives into this thread's reusable
        scratch — for chunks that are consumed immediately
        (decode_add) rather than stored for verbatim forwarding,
        which would otherwise pay a wire-sized allocation per chunk
        per step on the receiver's critical path."""
        hdr = bytearray(FRAME_HEADER.size)
        _recv_exact(sock, memoryview(hdr))
        scale = self.codec.parse_header(hdr)
        nbytes = n_elems * self.codec.wire_itemsize
        if fresh:
            payload = bytearray(nbytes)
        else:
            buf = getattr(self._rx_tls, "buf", None)
            if buf is None or len(buf) < nbytes:
                buf = self._rx_tls.buf = bytearray(
                    max(nbytes, self.chunk_bytes))
            payload = memoryview(buf)[:nbytes]
        if nbytes:
            _recv_exact(sock, memoryview(payload))
        return payload, scale

    def _run_quantized(self, flat: np.ndarray) -> None:
        codec = self.codec
        seg = _segment_bounds(flat.size, self.world)
        items = self._schedule()
        n_rs = self.world - 1
        chunk_lists = [self._codec_chunks(seg[rcv])
                       for (_snd, rcv, _red) in items]
        events = [[threading.Event() for _ in cl] for cl in chunk_lists]
        # Verbatim-forward store for the all-gather phase: item k
        # forwards exactly the (payload, scale) item k-1 received.
        fwd: List[List[Optional[Tuple[bytes, float]]]] = [
            [None] * len(cl) for cl in chunk_lists]
        errors: List[BaseException] = []

        tr = obs_trace.get_tracer()

        def sender(stream: int) -> None:
            try:
                sock = self._send[stream]
                traced = tr.enabled
                for k, (snd, _rcv, _red) in enumerate(items):
                    cl = self._codec_chunks(seg[snd])
                    for c in range(stream, len(cl), self.streams):
                        if k > 0 and not events[k - 1][c].wait(60.0):
                            raise RingError(
                                f"rank {self.rank}: stalled waiting "
                                f"for step {k - 1} chunk {c}")
                        lo, hi = cl[c]
                        faults.fire("fabric.send")
                        if k < n_rs:
                            # rs hop: encode the current fp32 partial.
                            # Error feedback applies to the k=0 encode
                            # only — the rank's OWN contribution, the
                            # reduction traffic whose residual repeats
                            # shape-stably across calls.
                            ts = time.monotonic() if traced else 0.0
                            if k == 0 and self._ef is not None:
                                wire, scale = self._ef.encode(
                                    flat[lo:hi], slot=c)
                            else:
                                wire, scale = codec.encode(flat[lo:hi])
                            if traced:
                                # Per-block codec cost on the wire
                                # path (the shard span taxonomy: the
                                # shard plane is this path's primary
                                # consumer).
                                tr.record_span(
                                    "shard.encode", ts,
                                    time.monotonic(),
                                    attrs={"rank": self.rank,
                                           "step": k, "block": c,
                                           "codec": self.codec_name})
                            self._send_frame(sock, scale, wire)
                        elif k == n_rs:
                            # First ag hop: I own this segment's final
                            # sum. Encode once, keep the decode of my
                            # own encoding (every peer will decode the
                            # same bytes — bit-identity by sharing).
                            ts = time.monotonic() if traced else 0.0
                            wire, scale = codec.encode(flat[lo:hi])
                            if traced:
                                tr.record_span(
                                    "shard.encode", ts,
                                    time.monotonic(),
                                    attrs={"rank": self.rank,
                                           "step": k, "block": c,
                                           "codec": self.codec_name})
                            self._send_frame(sock, scale, wire)
                            codec.decode(wire, hi - lo, scale,
                                         out=flat[lo:hi])
                        else:
                            payload, scale = fwd[k - 1][c]
                            self._send_frame(sock, scale, payload)
            except BaseException as e:
                errors.append(e)

        def receiver(stream: int) -> None:
            try:
                sock = self._recv[stream]
                for k, (_snd, rcv, red) in enumerate(items):
                    cl = chunk_lists[k]
                    for c in range(stream, len(cl), self.streams):
                        lo, hi = cl[c]
                        # rs chunks are consumed on the spot (scratch
                        # receive); ag chunks are STORED for verbatim
                        # forwarding and need their own buffer.
                        payload, scale = self._recv_frame(
                            sock, hi - lo, fresh=not red)
                        if red:
                            codec.decode_add(payload, hi - lo, scale,
                                             into=flat[lo:hi])
                        else:
                            codec.decode(payload, hi - lo, scale,
                                         out=flat[lo:hi])
                            fwd[k][c] = (payload, scale)
                        events[k][c].set()
            except BaseException as e:
                errors.append(e)
                for ev_row in events:
                    for ev in ev_row:
                        ev.set()

        self._spawn_join([(fn, i) for i in range(self.streams)
                          for fn in (sender, receiver)], errors)

    def _pair_run_quantized(self, flat: np.ndarray) -> None:
        """world == 2 quantized fast path: each side encodes its own
        buffer ONCE and streams it out while decoding the peer's; the
        result is dec(enc(mine)) + dec(enc(peer)) — each contribution
        rounds exactly once, and two-term fp32 addition is commutative,
        so both ranks land on bit-identical floats. The sender writes
        the decode of its OWN encoding back into `flat` right after
        the send (the encode scratch is reused next chunk), and the
        `sent` event gates the receiver's accumulate onto it."""
        codec = self.codec
        cl = self._codec_chunks((0, flat.size))
        sent = [threading.Event() for _ in cl]
        errors: List[BaseException] = []

        tr = obs_trace.get_tracer()

        def sender(stream: int) -> None:
            try:
                sock = self._send[stream]
                traced = tr.enabled
                for c in range(stream, len(cl), self.streams):
                    lo, hi = cl[c]
                    faults.fire("fabric.send")
                    ts = time.monotonic() if traced else 0.0
                    if self._ef is not None:
                        wire, scale = self._ef.encode(flat[lo:hi],
                                                      slot=c)
                    else:
                        wire, scale = codec.encode(flat[lo:hi])
                    if traced:
                        tr.record_span(
                            "shard.encode", ts, time.monotonic(),
                            attrs={"rank": self.rank, "block": c,
                                   "codec": self.codec_name})
                    self._send_frame(sock, scale, wire)
                    codec.decode(wire, hi - lo, scale,
                                 out=flat[lo:hi])
                    sent[c].set()
            except BaseException as e:
                errors.append(e)
                for ev in sent:
                    ev.set()

        def receiver(stream: int) -> None:
            try:
                sock = self._recv[stream]
                for c in range(stream, len(cl), self.streams):
                    lo, hi = cl[c]
                    payload, scale = self._recv_frame(sock, hi - lo,
                                                      fresh=False)
                    if not sent[c].wait(60.0):
                        raise RingError(
                            f"rank {self.rank}: send of chunk {c} "
                            f"stalled")
                    codec.decode_add(payload, hi - lo, scale,
                                     into=flat[lo:hi])
            except BaseException as e:
                errors.append(e)

        self._spawn_join([(fn, i) for i in range(self.streams)
                          for fn in (sender, receiver)], errors)

    @staticmethod
    def _spawn_join(work, errors: List[BaseException]) -> None:
        workers = [threading.Thread(target=fn, args=(i,), daemon=True)
                   for fn, i in work]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        if errors:
            raise RingError(f"ring transfer failed: {errors[0]!r}")

    def allreduce(self, arr: np.ndarray, out: Optional[np.ndarray] = None,
                  scratch: Optional[np.ndarray] = None) -> np.ndarray:
        """Sum-allreduce of a same-shaped contiguous array across the
        ring; returns the reduced array (input untouched). Segmented
        ring: n-1 reduce-scatter steps then n-1 all-gather steps, fully
        pipelined at chunk granularity. Callers in a loop should pass
        `out`/`scratch` (same shape/dtype) — a fresh 2×payload
        allocation per call costs real page-fault time at 16 MiB+."""
        src = np.ascontiguousarray(arr)
        if out is None:
            out = np.empty_like(src)
        np.copyto(out, src)
        if self.world == 1:
            return out
        flat = out.reshape(-1)
        if self.codec is not None:
            # Quantized path: the codec owns its own (wire-sized)
            # buffers; `scratch` is the raw path's contract only.
            if self.world == 2:
                self._pair_run_quantized(flat)
            else:
                self._run_quantized(flat)
            return out
        if scratch is None:
            scratch = np.empty_like(flat)
        run = self._pair_run if self.world == 2 else self._run
        run(flat, scratch.reshape(-1), do_reduce=True)
        return out

    def exchange(self, arr: np.ndarray,
                 scratch: Optional[np.ndarray] = None) -> None:
        """The allreduce's exact wire pattern — same schedule, same
        chunking, same dependency structure, same sockets — with the
        arithmetic deleted (every recv writes through). This is the raw
        transport ceiling the allreduce number must be read against;
        the input is clobbered by design."""
        flat = np.ascontiguousarray(arr).reshape(-1)
        if self.world == 1:
            return
        if self.world == 2:
            self._pair_run(
                flat,
                flat if scratch is None else scratch.reshape(-1),
                do_reduce=False)
        else:
            self._run(flat, flat, do_reduce=False)  # scratch unused

    # -- accounting ------------------------------------------------------

    def wire_bytes(self, payload_bytes: int) -> int:
        """Per-rank wire cost of one allreduce/exchange of a
        payload_bytes buffer: 2(n-1)/n · D (what each rank sends AND
        receives) — the standard algorithm-bandwidth denominator, same
        formula the gloo path reports, so the numbers compare 1:1."""
        return 2 * (self.world - 1) * payload_bytes // self.world


def quantized_error_bound(world: int, max_abs: float,
                          codec_name: str) -> float:
    """The documented per-element max-abs error bound for a quantized
    ring allreduce of inputs bounded by ``max_abs``. int8: every
    reduce-scatter hop encodes a partial sum (magnitude <= world *
    max_abs, so per-hop scale <= world * max_abs / 127 and per-hop
    error <= scale / 2), plus one final encode of the total — at most
    ``world`` roundings on any element's path. bf16 rounds each hop to
    its 7-bit mantissa: relative 2^-8 of the partial per hop. Loose by
    construction (hops rarely all reach the max), tight enough to
    catch a broken codec by orders of magnitude."""
    if codec_name == "int8":
        return world * (world * max_abs / 127.0) / 2.0
    if codec_name == "bf16":
        return world * (world * max_abs) * 2.0 ** -8
    return 0.0


def bench_ring(transport: RingTransport, payload_bytes: int, iters: int,
               mode: str = "allreduce") -> dict:
    """Timed loop + correctness. fp32: rank r contributes full(r+1),
    every reduced element must equal n(n+1)/2 exactly (exchange mode
    checks transfer liveness only). Quantized transports get a VARIED
    payload (a constant is exactly representable at any scale, which
    would measure zero codec error) and verify the measured max-abs
    error against `quantized_error_bound` — reported Gb/s stays on the
    fp32-equivalent wire denominator, so the figure is EFFECTIVE
    fp32 bandwidth and compares 1:1 with the raw ring's."""
    elems = payload_bytes // 4
    codec_name = transport.codec_name
    if codec_name != "fp32" and mode == "allreduce":
        # Golden-ratio stride: fractional parts that are NOT exact
        # multiples of any codec scale, so the measured error is the
        # codec's real rounding, not a representable-by-luck zero.
        base = (np.arange(elems, dtype=np.float64) * 0.6180339887
                % 2.0 - 1.0).astype(np.float32)
        local = base * float(transport.rank + 1)
        want = base * sum(range(1, transport.world + 1))
        max_abs = float(transport.world)  # the largest contribution
    else:
        local = np.full((elems,), float(transport.rank + 1), np.float32)
        want = np.full((elems,),
                       transport.world * (transport.world + 1) / 2.0,
                       np.float32)
        max_abs = float(transport.world)
    out = np.empty_like(local)
    scratch = np.empty_like(local)
    bound = quantized_error_bound(transport.world, max_abs, codec_name)

    def verify(arr) -> Tuple[bool, float]:
        err = float(np.max(np.abs(arr - want))) if elems else 0.0
        return (err <= bound if bound else err == 0.0), err

    ok, max_err = True, 0.0
    if mode == "allreduce":
        out = transport.allreduce(local, out, scratch)  # warmup + check
        ok, max_err = verify(out)
    else:
        np.copyto(scratch, local)
        transport.exchange(scratch)  # warmup

    t0 = time.perf_counter()
    if mode == "allreduce":
        for _ in range(iters):
            out = transport.allreduce(local, out, scratch)
        ok2, err2 = verify(out)
        ok, max_err = ok and ok2, max(max_err, err2)
    else:
        for _ in range(iters):
            transport.exchange(scratch)
    elapsed = time.perf_counter() - t0
    wire = transport.wire_bytes(elems * 4) * iters
    res = {
        "ok": ok,
        "mode": mode,
        "codec": codec_name,
        "elapsed_s": round(elapsed, 4),
        "gbps": round(wire * 8 / elapsed / 1e9, 3) if elapsed else 0.0,
        "streams": transport.streams,
        "chunk_bytes": transport.chunk_bytes,
        "sockbuf": transport.sockbuf,
    }
    if mode == "allreduce" and codec_name != "fp32":
        res["max_abs_err"] = round(max_err, 6)
        res["err_bound"] = round(bound, 6)
    return res


def main(argv=None) -> int:
    """One ring rank, run inside its pod netns (bench.py launches one
    per namespace). Prints exactly one JSON object on stdout; rc 0 iff
    the transfer verified."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--bind-ip", required=True)
    ap.add_argument("--peer-ips", required=True,
                    help="comma-separated fabric IPs of ALL ranks, "
                         "indexed by rank")
    ap.add_argument("--port", type=int, default=9411)
    ap.add_argument("--payload-mb", type=float, default=16.0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--mode", choices=["raw", "allreduce"], default="raw")
    ap.add_argument("--codec", choices=["fp32", "bf16", "int8"],
                    default="fp32",
                    help="wire codec for --mode allreduce (int8/bf16 "
                         "quarter/halve the bytes; Gb/s stays on the "
                         "fp32-equivalent denominator)")
    ap.add_argument("--streams", type=int, default=DEFAULT_STREAMS)
    ap.add_argument("--chunk-kb", type=int,
                    default=DEFAULT_CHUNK_BYTES >> 10)
    args = ap.parse_args(argv)

    peer_ips = [p for p in args.peer_ips.split(",") if p]
    mode = "allreduce" if args.mode == "allreduce" else "exchange"
    try:
        with RingTransport(args.rank, args.world, args.bind_ip, peer_ips,
                           port=args.port, streams=args.streams,
                           chunk_bytes=args.chunk_kb << 10,
                           codec=args.codec) as t:
            res = bench_ring(t, int(args.payload_mb * (1 << 20)),
                             args.iters, mode=mode)
    except RingError as e:
        print(json.dumps({"ok": False, "error": str(e)[:300]}), flush=True)
        return 1
    res["rank"] = args.rank
    print(json.dumps(res), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
