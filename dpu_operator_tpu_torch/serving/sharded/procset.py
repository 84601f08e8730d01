"""ShardProcessSet — real shard workers behind the ShardSet contract.

A copy of the JAX package's ``serving/sharded/procset.py``, statement
for statement, but for ``ShardProcessSet.__init__``, which takes
``device`` (where every worker's slice lives, handed to each as
``--device``; None means the CUDA card), and ``ShardProcessSet._spawn``,
which writes tensor weights to the workers' npz through the host and
spawns ``dpu_operator_tpu_torch.serving.sharded.shard_worker``.

Spawns ``world`` shard_worker processes, wires their collective ring
(ring order from ``parallel/topology.ring_order`` over the allocated
rendezvous addresses), accepts their control dials, and speaks the
framed protocol (``protocol.py``): the same contract the
``SyntheticShardSet`` serves in-process, so a ``FabricExecutor`` cannot
tell thread shards from fabric workers. On one card each worker opens
its own CUDA context there; the workers reduce over
``fabric_collectives.RingTransport`` on loopback.

Failure surfaces in bounded time everywhere: worker spawn/hello under
``spawn_timeout_s``, every control receive under the caller's collect
deadline, and recovery is always the full kill + respawn. Every handle
carries the generation it was submitted under; a collect against a
torn-down generation fails fast with ``ShardAborted`` and never tears
down the respawned set.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...device import resolve_device
from ...obs import trace as obs_trace
from ...obs.xproc import ClockSync
from ...parallel.topology import ring_order
from .protocol import ProtocolError, recv_msg, send_msg
from .shard_math import segment_bounds
from .synthetic import (ShardAborted, ShardError, ShardStepError,
                        ShardTimeout, StepOutput)


def _distinct_ports(n: int) -> List[int]:
    """n distinct loopback ports, all bound SIMULTANEOUSLY before any
    is released — sequential bind-then-close can hand the same port
    out twice. The close→worker-bind window remains (inherent to
    pre-agreed ring addresses on one host); a stolen port surfaces as
    a bounded spawn timeout, never a hang."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _reap(procs: Sequence[subprocess.Popen],
          socks: Dict[int, socket.socket],
          listener: Optional[socket.socket], kill: bool) -> None:
    """Close an incarnation's control sockets and reap its worker
    processes (polite close op unless `kill`)."""
    for s in socks.values():
        try:
            if not kill:
                send_msg(s, {"op": "close"})
        except OSError:
            pass
        s.close()
    if listener is not None:
        listener.close()
    for p in procs:
        if kill:
            p.kill()
        try:
            p.wait(timeout=5)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=5)


class _ProcHandle:
    """One submitted step's ledger token: just the generation it
    belongs to and its step identity — the replies live on the
    sockets, not here (unlike the synthetic set's per-rank reply
    board, which this deliberately is NOT)."""

    __slots__ = ("gen", "step_no", "want_state", "tx")

    def __init__(self, gen: int, step_no: int, want_state: bool):
        self.gen = gen
        self.step_no = step_no
        self.want_state = want_state
        # Per-rank monotonic send stamps (clock sync): the
        # coordinator half of the NTP four-timestamp exchange the
        # worker's reply completes.
        self.tx: Dict[int, float] = {}


class ShardProcessSet:
    """``world`` shard_worker subprocesses on loopback (the same
    program runs unchanged inside operator-attached pod netns — only
    the addresses differ; see docs/serving.md)."""

    def __init__(self, world: int, slots: int, d: int = 16, *,
                 params: Optional[dict] = None, seed: int = 0,
                 jit: bool = True, spawn_timeout_s: float = 60.0,
                 python: str = sys.executable,
                 codec: str = "fp32", overlap: bool = False,
                 overlap_blocks: int = 2, span_buffer: int = 512,
                 metrics_interval: int = 16, device=None):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world = world
        self.slots = slots
        self.params = params
        self.d = (int(params["w1"].shape[1])
                  if params is not None else d)
        # Where every worker's slice lives, handed to each as --device:
        # resolved here so a set asked for the card fails at once on a
        # machine without one (None means the CUDA card).
        self.device = resolve_device(device, "ShardProcessSet")
        self.seed = seed
        self.jit = jit
        self.spawn_timeout_s = spawn_timeout_s
        self.python = python
        # Quantized-collective + overlap knobs, handed verbatim to
        # every shard_worker (a ring must agree on its codec — the
        # hello handshake refuses a mixed ring typed).
        self.codec_name = str(codec or "fp32")
        self.overlap = bool(overlap)
        self.overlap_blocks = int(overlap_blocks)
        # Span-shipping knobs, handed to every worker: bounded
        # span piggyback buffer (0 disables shipping) and the
        # federated-metrics snapshot cadence.
        self.span_buffer = int(span_buffer)
        self.metrics_interval = max(1, int(metrics_interval))
        self.segments = segment_bounds(slots, world)
        self._procs: List[subprocess.Popen] = []
        self._socks: Dict[int, socket.socket] = {}
        self._listener: Optional[socket.socket] = None
        self._params_path: Optional[str] = None
        self._up = False
        # Generation discipline: bumped on every teardown; handles
        # are stamped at submit and checked at collect, so a stale
        # (pre-restart) caller can neither read a fresh socket nor
        # tear the fresh generation down. TWO locks, two jobs:
        # `_lock` guards the gen/socks/outstanding bookkeeping and is
        # NEVER held across a blocking call, so collect's fast
        # gen-check exit and the leak-ledger read stay fail-fast even
        # while a 60 s respawn is in flight; `_life` serializes the
        # lifecycle operations themselves (spawn/teardown/reset/
        # close/submit) whose socket work legitimately blocks.
        self._gen = 0
        self._lock = threading.Lock()
        self._life = threading.RLock()
        self._outstanding: set = set()
        self.respawns = 0
        # Per-rank monotonic clock offset estimators, fed
        # by the send/receive stamps the step frames already carry.
        # Reset on teardown: a respawned worker is a NEW process with
        # a new clock.
        self._clocks: Dict[int, ClockSync] = {}

    # -- rendezvous -----------------------------------------------------------

    def _spawn(self) -> None:
        """Caller holds ``_life``. All blocking socket work happens on
        locals; the new incarnation commits under ``_lock`` at the
        end, so bookkeeping readers never wait on a rendezvous."""
        if self.params is not None and self._params_path is None:
            fd, self._params_path = tempfile.mkstemp(
                prefix="shard-params-", suffix=".npz")
            os.close(fd)
            np.savez(self._params_path,
                     **{k: (v.detach().cpu().numpy()
                            if isinstance(v, torch.Tensor)
                            else np.asarray(v, np.float32))
                        for k, v in self.params.items()})
        listener = socket.socket()
        listener.setsockopt(socket.SOL_SOCKET,
                            socket.SO_REUSEADDR, 1)
        listener.bind(("127.0.0.1", 0))
        listener.listen(self.world + 2)
        listener.settimeout(self.spawn_timeout_s)
        cport = listener.getsockname()[1]
        # Session root span: reserved now so the workers
        # can parent their rendezvous spans (fabric.connect via the
        # --trace-parent arg and the ring _HELLO) on it; recorded
        # once the rendezvous completes.
        tr = obs_trace.get_tracer()
        spawn_sid = tr.reserve_id() if tr.enabled else None
        t_spawn = time.monotonic()
        # The ring the shards reduce over: allocate one fabric address
        # per shard, then let topology.ring_order pick the canonical
        # order — rank r of the spawned set IS ring position r.
        addrs = [f"127.0.0.1:{p}"
                 for p in _distinct_ports(self.world)]
        ring = ring_order(addrs)
        procs: List[subprocess.Popen] = []
        socks: Dict[int, socket.socket] = {}
        for rank in range(self.world):
            cmd = [self.python, "-m",
                   "dpu_operator_tpu_torch.serving.sharded.shard_worker",
                   "--rank", str(rank), "--world", str(self.world),
                   "--slots", str(self.slots), "--d", str(self.d),
                   "--coordinator", f"127.0.0.1:{cport}",
                   "--bind-ip", "127.0.0.1",
                   "--peers", ",".join(ring),
                   "--seed", str(self.seed),
                   "--connect-timeout", str(self.spawn_timeout_s),
                   "--device", str(self.device)]
            if spawn_sid is not None:
                cmd += ["--trace-parent", str(spawn_sid)]
            cmd += ["--span-buffer", str(self.span_buffer),
                    "--metrics-interval", str(self.metrics_interval)]
            if self._params_path:
                cmd += ["--params-npz", self._params_path]
            if self.jit:
                cmd.append("--jit")
            if self.codec_name != "fp32":
                cmd += ["--codec", self.codec_name]
            if self.overlap:
                cmd += ["--overlap", "--overlap-blocks",
                        str(self.overlap_blocks)]
            procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        deadline = time.monotonic() + self.spawn_timeout_s
        try:
            while len(socks) < self.world:
                if time.monotonic() > deadline:
                    raise ShardTimeout(
                        f"only {len(socks)}/{self.world} shards "
                        f"dialed in within {self.spawn_timeout_s}s")
                c, _ = listener.accept()
                # Control frames are a small header write + zero-copy
                # payload parts: NODELAY so the parts never wait out a
                # delayed-ACK exchange between the two sendalls.
                c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                msg, _ = recv_msg(c, timeout=self.spawn_timeout_s)
                if msg.get("op") != "hello":
                    c.close()
                    continue
                socks[int(msg["rank"])] = c
        except (OSError, ProtocolError, ShardError):
            _reap(procs, socks, listener, kill=True)
            raise
        if spawn_sid is not None:
            tr.record_span(
                "shard.spawn", t_spawn, time.monotonic(),
                span_id=spawn_sid,
                attrs={"world": self.world, "respawn": self.respawns,
                       "codec": self.codec_name})
        with self._lock:
            self._listener = listener
            self._procs = procs
            self._socks = socks
            self._up = True

    def _teardown(self, kill: bool) -> None:
        """Caller holds ``_life``. Bumps the generation and detaches
        the incarnation's resources under ``_lock`` FIRST — handles
        submitted against the old incarnation fail fast at collect()
        and a stale blocked reader (its per-recv deadline bounds the
        wake-up) finds its snapshot sockets dead, never the
        successor's — then does the blocking close/kill/reap work on
        the detached locals."""
        with self._lock:
            self._gen += 1
            socks = self._socks
            self._socks = {}
            listener = self._listener
            self._listener = None
            procs = self._procs
            self._procs = []
            # A respawned worker is a new process with a new
            # monotonic clock: stale offsets must not align the fresh
            # incarnation's spans.
            self._clocks = {}
            self._up = False
        _reap(procs, socks, listener, kill=kill)

    # -- the ShardSet contract ------------------------------------------------

    def reset(self) -> None:
        """Zero every shard's decode state. Any outstanding step (or
        any miss on the reset ack) forces kill + respawn — the real
        re-rendezvous: a submitted-never-collected step left unread
        frames on the positional control stream, so the polite path
        would desync even if every worker were healthy."""
        with self._life:
            with self._lock:
                stale = list(self._outstanding)
                # Generation-orphaned handles are settled (collect
                # raises ShardAborted on the gen mismatch), so
                # exactly these leave the ledger.
                self._outstanding.difference_update(stale)
                up = self._up
                socks = dict(self._socks)
            if not up:
                self._spawn()
                return
            if stale:
                self._teardown(kill=True)
                self.respawns += 1
                self._spawn()
                return
            try:
                tx = {}
                for rank, s in socks.items():
                    tx[rank] = time.monotonic()
                    send_msg(s, {"op": "reset"})
                for rank, s in socks.items():
                    msg, _ = recv_msg(s, timeout=self.spawn_timeout_s)
                    t_now = time.monotonic()
                    if msg.get("op") != "ack":
                        raise ProtocolError(
                            f"shard {rank}: expected reset ack, got "
                            f"{msg.get('op')!r}")
                    # The reset ack carries worker clock stamps too:
                    # a first offset estimate exists before the first
                    # step's spans need aligning.
                    if "t_rx" in msg and "t_tx" in msg:
                        self._clocks.setdefault(
                            rank, ClockSync()).observe(
                            tx[rank], float(msg["t_rx"]),
                            float(msg["t_tx"]), t_now)
            except (OSError, ProtocolError, ShardError):
                self._teardown(kill=True)
                self.respawns += 1
                self._spawn()

    def submit(self, step_no: int, updates: Sequence,
               want_state: bool = False,
               trace_parent=None) -> _ProcHandle:
        idx = [int(i) for i, _row in updates]
        rows = (np.stack([np.asarray(r, np.float32)
                          for _i, r in updates])
                if updates else np.empty((0, self.d), np.float32))
        msg = {"op": "step", "step": step_no, "slots": idx,
               "want_state": bool(want_state)}
        if trace_parent is not None:
            # Context propagation: the coordinator's
            # shard.step span id rides the frame; a worker that
            # predates the field simply never reads it.
            msg["trace_parent"] = int(trace_parent)
        payload = rows  # buffer-protocol part: sent without a copy
        with self._life:
            with self._lock:
                up = self._up
            if not up:
                self._spawn()
            with self._lock:
                handle = _ProcHandle(self._gen, step_no, want_state)
                # On the ledger BEFORE the broadcast: a partial
                # broadcast leaves a poisoned positional stream, and
                # the ledger entry is what routes the next reset() to
                # kill+respawn.
                self._outstanding.add(handle)
                socks = dict(self._socks)
            try:
                for rank, s in socks.items():
                    # The clock-sync send stamp, per rank: taken
                    # immediately before the write so queuing inside
                    # this loop lands in the estimator's uncertainty,
                    # not its bias.
                    handle.tx[rank] = time.monotonic()
                    send_msg(s, msg, payload)
            except OSError as e:
                raise ShardStepError(f"broadcast failed: {e!r}")
            return handle

    def collect(self, handle: _ProcHandle,
                timeout: float) -> StepOutput:
        with self._lock:
            if handle.gen != self._gen:
                self._outstanding.discard(handle)
                raise ShardAborted(
                    "shard set re-rendezvoused mid-step; this handle "
                    "belongs to a torn-down generation")
            # Snapshot THIS generation's sockets: if the set restarts
            # while we block below, the fresh sockets are invisible
            # to us — we fail on our own closed snapshot.
            socks = dict(self._socks)
        deadline = time.monotonic() + timeout
        tokens = np.empty((self.slots,), np.int32)
        state = None
        compute, coll = [0.0] * self.world, [0.0] * self.world
        spans_by_rank: Dict[int, list] = {}
        clock_by_rank: Dict[int, tuple] = {}
        metrics_by_rank: Dict[int, dict] = {}
        span_dropped_by_rank: Dict[int, int] = {}
        try:
            for rank in range(self.world):
                lo, hi = self.segments[rank]
                s = socks.get(rank)
                if s is None:
                    raise ShardAborted(
                        f"shard {rank} gone (set torn down mid-step)",
                        rank=rank)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ShardTimeout(
                        f"shard {rank} never replied to step "
                        f"{handle.step_no} within {timeout}s",
                        rank=rank)
                try:
                    msg, payload = recv_msg(s, timeout=remaining)
                except socket.timeout:
                    raise ShardTimeout(
                        f"shard {rank} silent past the step deadline "
                        f"({timeout}s)", rank=rank)
                except (OSError, ProtocolError) as e:
                    raise ShardStepError(
                        f"shard {rank} control channel failed: "
                        f"{e!r}", rank=rank)
                if msg.get("op") != "tokens" or \
                        msg.get("step") != handle.step_no:
                    raise ShardStepError(
                        f"shard {rank}: unexpected reply "
                        f"{msg.get('op')!r} (step "
                        f"{msg.get('step')} != {handle.step_no})",
                        rank=rank)
                t_reply = time.monotonic()
                seg = np.frombuffer(payload[:4 * (hi - lo)], np.int32)
                tokens[lo:hi] = seg
                compute[rank] = float(msg.get("compute_s", 0.0))
                coll[rank] = float(msg.get("collective_s", 0.0))
                # Clock sync: the reply completes the NTP
                # four-timestamp exchange the submit stamps started.
                # The worker's processing time sits BETWEEN its two
                # stamps, so only genuine wire/queue time widens the
                # uncertainty.
                t_tx = handle.tx.get(rank)
                if (t_tx is not None and "t_rx" in msg
                        and "t_tx" in msg):
                    sync = self._clocks.setdefault(rank, ClockSync())
                    sync.observe(t_tx, float(msg["t_rx"]),
                                 float(msg["t_tx"]), t_reply)
                    clock_by_rank[rank] = sync.estimate
                # Piggybacked spans + federated metrics: already paid
                # for by the reply frame — never an extra round trip.
                if msg.get("spans"):
                    spans_by_rank[rank] = msg["spans"]
                if "spans_dropped" in msg:
                    span_dropped_by_rank[rank] = int(
                        msg["spans_dropped"])
                if msg.get("metrics"):
                    metrics_by_rank[rank] = msg["metrics"]
                if msg.get("state"):
                    state = np.frombuffer(
                        payload[4 * (hi - lo):],
                        np.float32).reshape(self.slots, self.d).copy()
            return StepOutput(tokens, state, compute, coll,
                              spans_by_rank=spans_by_rank or None,
                              clock_by_rank=clock_by_rank or None,
                              metrics_by_rank=metrics_by_rank or None,
                              span_dropped_by_rank=(
                                  span_dropped_by_rank or None))
        except ShardError:
            # A failed step leaves unread frames on the positional
            # control stream, so the only safe recovery is the
            # respawn path — but ONLY for our own generation: an
            # abandoned pre-restart collect waking here must not kill
            # the supervisor's freshly restarted incarnation (the
            # gen check runs under _lock AFTER _life is held, so a
            # concurrent lifecycle op cannot slip a new incarnation
            # in between the check and the teardown).
            with self._life:
                with self._lock:
                    current = handle.gen == self._gen
                if current:
                    self._teardown(kill=True)
            raise
        finally:
            with self._lock:
                self._outstanding.discard(handle)

    def outstanding(self) -> int:
        with self._lock:
            return len(self._outstanding)

    def close(self) -> None:
        with self._life:
            with self._lock:
                stale = list(self._outstanding)
                self._outstanding.difference_update(stale)
                up = self._up or self._procs
            if up:
                # An uncollected step means a possibly-blocked reader
                # and unread frames: kill, don't wait on a polite
                # close of a desynced stream.
                self._teardown(kill=bool(stale))
            if self._params_path:
                try:
                    os.unlink(self._params_path)
                except OSError:
                    pass
                self._params_path = None
