"""One shard worker of a fabric-sharded serving replica, and one rank
process of a context-parallel paged-KV replica.

    python -m dpu_operator_tpu_torch.serving.sharded.shard_worker \
        --rank R --world W --slots S --coordinator HOST:PORT \
        --peers IP:PORT,... [--params-npz F | --d D --seed N] [--jit] \
        [--codec fp32|bf16|int8] [--overlap] [--device cuda|cpu]

The row worker (``ShardProcessSet`` spawns one a rank) holds rank r's
tensor-parallel slice of the decode params (``shard_math.TpShardSlice``,
or the seeded double) on ``--device`` (default: the card) plus a host
replica of the [slots, d] decode state, and runs the per-step tp
collective through ``parallel/fabric_collectives.RingTransport`` over
the addresses the coordinator wired into a ring (ring order chosen by
``parallel/topology.ring_order``). It dials the coordinator, says hello,
then serves framed step/reset messages (``protocol.py``). Per step it
applies the scatter updates, computes its stage partials, allreduces
each stage over the ring, and replies with its OWNED token segment plus
compute/collective timings. ``--jit`` warms the slice up (every stage
once) before the hello. ``--codec int8|bf16`` runs the ring collective
quantized (every ring member must agree); ``--overlap`` restructures
each stage through ``forward_overlapped``, block reduces on a dedicated
collective thread. Finished spans and federated metrics piggyback on
the replies.

    python -m dpu_operator_tpu_torch.serving.sharded.shard_worker --kv \
        --rank R --connect HOST:PORT --slots S --num-blocks N --chunk C \
        --kv-spec K=V,... [--device cuda|cpu]

The ``--kv`` entry (``KVShardProcessSet``, ``serving/kvcache/sharded.py``,
spawns one a rank) dials the coordinator's per-rank listener, rebuilds
the shared ``KVSpec`` from ``--kv-spec``, derives its own head or block
slice from it, and serves framed step/reset messages until the
coordinator closes the stream.

Both print exactly ONE JSON object on stdout at exit
(``parallel/fabric_worker.protocol_stdout`` guards the stream — all
logging goes to stderr); rc 0 iff the session ended cleanly.
"""

from __future__ import annotations

import argparse
import json
import logging
import select
import socket
import sys
import time

import numpy as np
import torch

from ...obs import logging as obs_logging
from ...obs import trace as obs_trace
from ...obs.xproc import SpanShip
from ...parallel.fabric_collectives import RingError, RingTransport
from ...parallel.fabric_worker import protocol_stdout
from ...utils.metrics import Registry
from .protocol import ProtocolError, recv_msg, send_msg
from .shard_math import (DoubleShardSlice, TpShardSlice,
                         segment_bounds)
from .synthetic import GuardedReducer

log = logging.getLogger("shard_worker")

# Worker-local step-scale histogram bounds (the coordinator re-exports
# these series verbatim, so they must match the serving plane's
# decode-step resolution).
_WORKER_BUCKETS = (0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                   0.05, 0.1, 0.25, 1.0)


def _ring_reducer(ring) -> GuardedReducer:
    """The worker's collective thread (overlap mode): block reduces
    queue in (stage, block) order — identical on every rank, so the
    sequential ring allreduces pair up — while the compute thread
    runs the NEXT block's partial. One GuardedReducer (shared with
    the synthetic shard plane: every failure lands in the owning
    ticket) over a ring-allreduce fn with per-size scratch reuse; the
    OUT buffer stays fresh each call — it escapes through the ticket
    and the compute thread may not have consumed block b when block
    b+1 reduces."""
    scratch = {}

    def reduce_fn(part):
        if ring is None:
            return part
        s = scratch.get(part.size)
        if s is None:
            s = scratch[part.size] = np.empty(part.size, np.float32)
        return ring.allreduce(part, scratch=s)

    return GuardedReducer(reduce_fn, name="ring-reducer")


def _load_slice(args):
    if args.params_npz:
        with np.load(args.params_npz) as z:
            params = {k: z[k] for k in z.files}
        return TpShardSlice(params, args.rank, args.world,
                            device=args.device)
    return DoubleShardSlice(args.d, args.seed, args.rank, args.world,
                            device=args.device)


def _maybe_jit(sl, want_jit: bool, slots: int) -> bool:
    """Warmed? — with ``--jit`` the slice runs EVERY stage once on its
    device before the worker says hello (the stage products' first-call
    costs, the CUDA context and the library handles), so step latency
    never includes them, as the reference compiles every stage up front.
    The step runs the slice's own torch math either way; without
    ``--jit`` there is no warm-up."""
    if not want_jit:
        return False
    x0 = torch.zeros((slots, sl.d), dtype=torch.float32, device=sl.device)
    for s in range(sl.stages):
        sl.finish(x0, sl.partial(x0, s), s)
    if sl.device.type == "cuda":
        torch.cuda.synchronize(sl.device)
    return True


def _kv_main(argv) -> int:
    """``--kv`` mode: this process serves ONE rank's slice of a
    context-parallel paged KV pool — it dials the coordinator's
    per-rank listener, rebuilds the shared ``KVSpec`` from
    ``--kv-spec`` and derives its OWN head/block slice bounds from it
    (the GL018 discipline holds across the process boundary), then
    serves framed step/reset messages until the coordinator closes the
    stream. One JSON line on stdout at exit."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--kv", action="store_true")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--connect", required=True,
                    help="ip:port of the KVShardProcessSet's per-rank "
                         "listener")
    ap.add_argument("--slots", type=int, required=True)
    ap.add_argument("--num-blocks", type=int, required=True)
    ap.add_argument("--chunk", type=int, required=True)
    ap.add_argument("--kv-spec", required=True,
                    help="k=v CSV of KVSpec.fingerprint() — the ONE "
                         "layout declaration both ends derive from")
    ap.add_argument("--device", default=None,
                    help="where the rank's pools and step live "
                         "(default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    proto_out = protocol_stdout()
    obs_logging.setup("shard_worker", stream=sys.stderr)
    with obs_logging.context(rank=args.rank):
        from ..kvcache.sharded import serve_kv_rank, spec_from_argv

        spec = spec_from_argv(args.kv_spec)
        host, port = args.connect.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)),
                                        timeout=30.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        rc, err = 0, None
        try:
            serve_kv_rank(sock, args.rank, spec, slots=args.slots,
                          num_blocks=args.num_blocks,
                          chunk=args.chunk, device=args.device)
        except (OSError, ProtocolError) as e:
            # A dead coordinator closes the socket: bounded, loud.
            rc, err = 1, str(e)
            log.warning("kv rank %d: coordinator stream died: %s",
                        args.rank, e)
        finally:
            sock.close()
        print(json.dumps({"ok": rc == 0, "mode": "kv",
                          "rank": args.rank, "error": err}),
              file=proto_out, flush=True)
    return rc


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--kv" in argv:
        return _kv_main(argv)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rank", type=int, required=True,
                    help="ring rank (the coordinator applies "
                         "topology.ring_order before spawning)")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--slots", type=int, required=True)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--coordinator", required=True,
                    help="ip:port of the FabricExecutor's control "
                         "listener")
    ap.add_argument("--bind-ip", default="127.0.0.1",
                    help="this shard's fabric address (ring listener)")
    ap.add_argument("--peers", required=True,
                    help="comma-separated ip:port ring addresses of "
                         "ALL shards, indexed by ring rank")
    ap.add_argument("--params-npz", default="",
                    help="train_step params (E=1) for the real model "
                         "slice; empty = the seeded double")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jit", action="store_true",
                    help="warm the slice up before the hello: run "
                         "every stage once on --device")
    ap.add_argument("--device", default=None,
                    help="where the slice's weights and stage math "
                         "live (default: the CUDA card; 'cpu' for the "
                         "CPU)")
    ap.add_argument("--codec", choices=["fp32", "bf16", "int8"],
                    default="fp32",
                    help="wire codec for the ring collective "
                         "(quantized collectives — every rank of a "
                         "ring must agree; a mismatch fails typed at "
                         "connect)")
    ap.add_argument("--overlap", action="store_true",
                    help="overlap the stage-k collective with "
                         "stage-k+1 compute: block reduces run on a "
                         "dedicated collective thread while this "
                         "thread computes the next block's partial "
                         "(shard_math.forward_overlapped)")
    ap.add_argument("--overlap-blocks", type=int, default=2,
                    help="row blocks per stage in overlap mode (2 = "
                         "double buffering)")
    ap.add_argument("--trace-parent", type=int, default=0,
                    help="coordinator span id this worker session "
                         "parents its rendezvous spans on (0 = "
                         "unparented). Rides the fabric _HELLO "
                         "too, so ring peers agree on the session "
                         "root.")
    ap.add_argument("--span-buffer", type=int, default=512,
                    help="bounded outbound span buffer (obs.xproc."
                         "SpanShip): finished spans piggyback onto "
                         "reply frames; overflow is dropped AND "
                         "counted (shipped as spans_dropped). 0 "
                         "disables shipping entirely.")
    ap.add_argument("--metrics-interval", type=int, default=16,
                    help="ship a federated metrics snapshot every N "
                         "steps (piggybacked on the reply — never an "
                         "extra round trip)")
    ap.add_argument("--connect-timeout", type=float, default=30.0)
    ap.add_argument("--idle-timeout", type=float, default=300.0,
                    help="control-socket wait interval: idle is NOT "
                         "death (a quiet serving replica submits "
                         "nothing between requests), so silence just "
                         "re-arms the wait — a DEAD coordinator "
                         "closes the socket (the kernel does, even "
                         "on a crash) and TCP keepalive surfaces a "
                         "half-open partition, either ending the "
                         "worker in bounded time")
    args = ap.parse_args(argv)

    proto_out = protocol_stdout()  # stdout carries ONLY the summary
    # JSON-lines logging on stderr: the
    # protocol_stdout guard above already repointed every stream
    # handler, so setup() landing on stderr cannot touch the one-line
    # stdout protocol. Rank binds once via context() — every record
    # this process emits carries it.
    obs_logging.setup("shard_worker", stream=sys.stderr)
    with obs_logging.context(rank=args.rank):
        return _serve(args, proto_out)


def _serve(args, proto_out) -> int:
    trace = log.info
    sl = _load_slice(args)
    jitted = _maybe_jit(sl, args.jit, args.slots)
    lo, hi = segment_bounds(args.slots, args.world)[args.rank]
    result = {"rank": args.rank, "world": args.world,
              "jitted": jitted, "steps": 0, "resets": 0, "ok": False}

    # Cross-process tracing: this process's spans (the
    # per-step shard.compute/reduce segments, the ring's
    # fabric.connect, quantized shard.encode chunks) accumulate in the
    # worker-global tracer and PIGGYBACK onto the reply frames the
    # step loop already sends — zero extra round trips. The ship
    # buffer is bounded and its losses counted (shipped too, so the
    # coordinator re-exports them).
    tracer = obs_trace.get_tracer()
    ship = (SpanShip(cap=args.span_buffer)
            if args.span_buffer > 0 else None)
    # Worker-local metrics, federated to the coordinator every
    # --metrics-interval steps as a snapshot on the same piggyback.
    reg = Registry()
    # Per-step span context the reduce closures read: the compute
    # span's id is reserved at step start (reduce segments parent on
    # it) and the span itself is recorded when the step closes.
    cur = {"sid": None, "step": 0, "traced": False}

    peers = [p for p in args.peers.split(",") if p]
    ring = None
    reducer = None
    csock = socket.socket()
    try:
        if args.world > 1:
            bind_port = int(peers[args.rank].rpartition(":")[2])
            ring = RingTransport(args.rank, args.world, args.bind_ip,
                                 peers, port=bind_port,
                                 codec=args.codec,
                                 trace_parent=args.trace_parent
                                 or None)
            trace(f"connecting ring ({args.world} ranks, "
                  f"codec={args.codec})")
            ring.connect(timeout=args.connect_timeout)
        trace(f"dialing coordinator {args.coordinator}")
        chost, _, cport = args.coordinator.rpartition(":")
        csock.settimeout(args.connect_timeout)
        csock.connect((chost, int(cport)))
        # Half-open partition coverage for the idle loop below: with
        # keepalive armed, a coordinator host that vanished without a
        # FIN surfaces as an OSError instead of eternal silence.
        csock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        # The reply frame is a small header write followed by the
        # zero-copy token/state parts: NODELAY so the parts never sit
        # out a Nagle/delayed-ACK round trip between sendalls.
        csock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_msg(csock, {"op": "hello", "rank": args.rank})

        x = np.zeros((args.slots, sl.d), np.float32)
        out = np.empty((args.slots, sl.d), np.float32)
        scratch = np.empty(args.slots * sl.d, np.float32)

        def reduce_fn(part, stage):
            t0 = time.monotonic()
            try:
                if ring is None:
                    total = part
                else:
                    total = ring.allreduce(part, out, scratch)
            except BaseException as e:
                # Peer-side evidence of a sick ring: how long this
                # rank blocked before the failure surfaced — shipped
                # like every other span, so the coordinator's flight
                # snapshot shows the stall on the victim's peers.
                if cur["traced"]:
                    tracer.record_span(
                        "shard.reduce_stall", t0, time.monotonic(),
                        parent_id=cur["sid"],
                        attrs={"rank": args.rank, "step": cur["step"],
                               "stage": stage,
                               "error": type(e).__name__})
                raise
            if cur["traced"]:
                tracer.record_span(
                    "shard.reduce_blocked", t0, time.monotonic(),
                    parent_id=cur["sid"],
                    attrs={"rank": args.rank, "step": cur["step"],
                           "stage": stage})
            reduce_fn.collective_s += time.monotonic() - t0
            return total

        reduce_fn.collective_s = 0.0

        # Overlap mode: the collective rides its own thread; the
        # per-step collective_s is the time the COMPUTE thread
        # actually blocked waiting for a reduce — the non-hidden
        # remainder, which is the number overlap exists to shrink.
        coll_box = [0.0]
        if args.overlap:
            reducer = _ring_reducer(ring)

            def reduce_submit(part, stage, block):
                return reducer.submit(part)

            def reduce_wait(tkt):
                # No AGGREGATE ceiling: a chunked allreduce's total
                # time is only bounded per socket op (io_timeout) and
                # per chunk dependency (the 60 s event waits), so a
                # fixed wall here could spuriously fail a healthy-but-
                # slow ring the serialized path would have finished.
                # The wait re-arms in slices; a genuine hang still
                # surfaces in bounded time because every ring op is
                # deadline-armed and the guarded reducer ALWAYS sets
                # the event — the liveness check below covers only a
                # dead reducer thread (can't set anything again).
                t0 = time.monotonic()
                while not tkt.event.wait(60.0):
                    if not reducer.thread.is_alive():
                        coll_box[0] += time.monotonic() - t0
                        if cur["traced"]:
                            tracer.record_span(
                                "shard.reduce_stall", t0,
                                time.monotonic(),
                                parent_id=cur["sid"],
                                attrs={"rank": args.rank,
                                       "step": cur["step"],
                                       "error": "RingError"})
                        raise RingError(
                            "ring reducer thread died with the "
                            "reduce outstanding")
                coll_box[0] += time.monotonic() - t0
                if tkt.error is not None:
                    if cur["traced"]:
                        tracer.record_span(
                            "shard.reduce_stall", t0,
                            time.monotonic(), parent_id=cur["sid"],
                            attrs={"rank": args.rank,
                                   "step": cur["step"],
                                   "error": type(tkt.error).__name__})
                    raise tkt.error
                if cur["traced"]:
                    tracer.record_span(
                        "shard.reduce_blocked", t0, time.monotonic(),
                        parent_id=cur["sid"],
                        attrs={"rank": args.rank,
                               "step": cur["step"]})
                return tkt.value

        while True:
            # Idle is not death: a drained serving replica submits
            # nothing between requests, and a worker that exited on
            # silence would make every lull cost a spurious replica
            # failure + re-rendezvous. So the IDLE wait (select, no
            # bytes consumed) re-arms freely — but once the frame's
            # first byte is on the wire, the whole frame must land
            # under a FRESH deadline and a mid-frame timeout is
            # FATAL: catching it would desync the positional stream
            # (the next "header" would be this frame's json body).
            # Coordinator death still ends the worker via the closed
            # socket (ProtocolError/OSError).
            readable, _, _ = select.select([csock], [], [],
                                           args.idle_timeout)
            if not readable:
                continue
            msg, payload = recv_msg(csock, timeout=args.idle_timeout)
            # Clock-sync receive stamp: the coordinator
            # pairs this with its own send/receive stamps to estimate
            # this worker's monotonic offset (NTP midpoint) — the
            # stamps ride frames that exist anyway.
            t_rx = time.monotonic()
            op = msg["op"]
            if op == "close":
                break
            if op == "reset":
                x = np.zeros((args.slots, sl.d), np.float32)
                result["resets"] += 1
                send_msg(csock, {"op": "ack", "reset": True,
                                 "t_rx": round(t_rx, 6),
                                 "t_tx": round(time.monotonic(), 6)})
                continue
            if op != "step":
                raise ProtocolError(f"unknown op {op!r}")
            traced = tracer.enabled
            sid = tracer.reserve_id() if traced else None
            cur["sid"], cur["step"] = sid, msg["step"]
            cur["traced"] = traced
            t0 = time.monotonic()
            idx = msg["slots"]
            rows = np.frombuffer(payload, np.float32).reshape(
                len(idx), sl.d) if idx else None
            for j, i in enumerate(idx):
                x[i] = rows[j]
            if args.overlap:
                coll_box[0] = 0.0
                x, tokens = sl.forward_overlapped(
                    x, reduce_submit, reduce_wait,
                    blocks=args.overlap_blocks)
                coll = coll_box[0]
            else:
                reduce_fn.collective_s = 0.0
                x, tokens = sl.forward(x, reduce_fn)
                coll = reduce_fn.collective_s
            total = time.monotonic() - t0
            if traced:
                attrs = {"rank": args.rank, "step": msg["step"],
                         "compute_s": round(max(0.0, total - coll),
                                            6),
                         "collective_s": round(coll, 6)}
                tp = msg.get("trace_parent")
                if tp:
                    # A COORDINATOR-space parent id: it must not ride
                    # parent_id (that space collides with this
                    # process's ids) — the wire format carries it as
                    # attrs["xparent"] and ingest resolves it.
                    attrs["xparent"] = tp
                tracer.record_span("shard.compute", t0,
                                   time.monotonic(), span_id=sid,
                                   attrs=attrs)
            reg.observe("shard_step_compute_seconds",
                        max(0.0, total - coll),
                        buckets=_WORKER_BUCKETS,
                        help="worker-local per-step compute time "
                             "(federated to the coordinator)")
            reg.observe("shard_step_collective_seconds", coll,
                        buckets=_WORKER_BUCKETS,
                        help="worker-local time blocked in the ring "
                             "collective per step (federated)")
            reg.counter_inc("shard_steps_total",
                            help="steps served by this shard worker")
            reply = {"op": "tokens", "step": msg["step"],
                     "compute_s": round(max(0.0, total - coll), 6),
                     "collective_s": round(coll, 6),
                     "t_rx": round(t_rx, 6)}
            # Span shipping: everything the worker traced since the
            # last reply piggybacks here — on a frame that exists
            # anyway, never an extra round trip. Losses to the
            # bounded buffer ship as a counter next to the spans.
            if ship is not None:
                ship.harvest(tracer)
                wire = ship.flush()
                if wire:
                    reply["spans"] = wire
                reply["spans_dropped"] = ship.dropped_total
            if result["steps"] % args.metrics_interval == 0:
                reply["metrics"] = reg.federated_snapshot()
            # Zero-copy reply: the token segment and the state ship as
            # buffer-protocol parts straight out of their arrays — no
            # tobytes() copies in the per-step loop (GL011).
            parts = [np.ascontiguousarray(tokens[lo:hi], np.int32)]
            if msg.get("want_state") and args.rank == 0:
                reply["state"] = True
                parts.append(np.ascontiguousarray(x, np.float32))
            reply["t_tx"] = round(time.monotonic(), 6)
            send_msg(csock, reply, *parts)
            result["steps"] += 1
        result["ok"] = True
    except Exception as e:
        result["error"] = repr(e)[:300]
        log.error("failed: %r", e)
    finally:
        if reducer is not None:
            reducer.stop()
        if ring is not None:
            ring.close()
        csock.close()
    print(json.dumps(result), file=proto_out, flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
