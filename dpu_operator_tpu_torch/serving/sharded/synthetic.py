"""SyntheticShardSet — the FabricExecutor's in-process shard backend.

A copy of the JAX package's ``serving/sharded/synthetic.py``, statement
for statement, but for ``SyntheticShardSet.__init__`` and
``SyntheticShardSet._make_slice``, which take and pass on ``device``
(where the shards' slices live: None means the CUDA card).

N shard threads (the ``_GuardedWorker`` discipline, extended to a SET:
every failure path lands in the owning step handle and a thread never
dies silently) stand in for N fabric worker processes. The collective
plane is an in-process reduce board on the host — a rank-ordered f32
sum with a CONTROLLED cost and a deadline:

  * ``step_time_s`` — per-rank (scalar or per-shard sequence) modelled
    compute cost: the skew knob.
  * ``collective_time_s`` — added wire cost per reduce.
  * ``collective_timeout_s`` — every shard's wait at the board carries
    this deadline: a hung peer surfaces as ``ShardCollectiveStall`` in
    bounded time.
  * ``fault_site`` — rank r fires ``{fault_site}{r}.step`` inside its
    shard thread before computing, so a chaos plan can kill or hang ONE
    shard of the replica.
  * ``overlap`` / ``codec`` — the overlapped block schedule with a
    reducer thread a shard, and the transport's quantized rounding
    modelled at the board.

A shard that raises poisons its GENERATION on the board, so peers
blocked in the reduce raise ``ShardStepError`` at once. ``reset()`` bumps
the generation, aborts every outstanding handle and spawns fresh shard
threads with zeroed state. The typed failures (``ShardError`` and its
subclasses) are what every shard backend raises, the context-parallel
KV sets (``serving/kvcache/sharded.py``) included.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ...device import resolve_device

from ... import faults
from ...obs import trace as obs_trace
from ...parallel import quantize
from .shard_math import (DoubleShardSlice, ShardSlice, TpShardSlice,
                         params_on, segment_bounds)


class ShardError(RuntimeError):
    """Base of the shard plane's failures; carries the origin rank."""

    def __init__(self, msg: str, rank: Optional[int] = None):
        super().__init__(msg)
        self.rank = rank


class ShardStepError(ShardError):
    """One shard's step raised; the whole replica step is poisoned
    (every peer needs the missing partial)."""


class ShardCollectiveStall(ShardError):
    """A peer never deposited its partial inside the collective
    deadline — the bounded-time spelling of 'one shard is hung'."""


class ShardAborted(ShardError):
    """The step's generation was torn down (reset/close) before the
    result landed — the owner must not retry against this handle."""


class ShardTimeout(ShardError):
    """collect() deadline expired before every shard replied."""


class StepOutput:
    """What one replica step produced, assembled across shards.

    The cross-process extras are None on the in-process
    backend — synthetic shard threads record straight into the
    process tracer, so there is nothing to ship or clock-align:

      * ``spans_by_rank`` — piggybacked wire spans per rank
        (obs.xproc format), for ``Tracer.ingest``;
      * ``clock_by_rank`` — per-rank (offset, uncertainty) monotonic
        clock estimate at collect time;
      * ``metrics_by_rank`` — federated Registry snapshots;
      * ``span_dropped_by_rank`` — each worker's cumulative
        bounded-ship-buffer loss counter."""

    __slots__ = ("tokens", "state", "compute_s", "collective_s",
                 "spans_by_rank", "clock_by_rank", "metrics_by_rank",
                 "span_dropped_by_rank")

    def __init__(self, tokens: np.ndarray,
                 state: Optional[np.ndarray],
                 compute_s: List[float], collective_s: List[float],
                 spans_by_rank=None, clock_by_rank=None,
                 metrics_by_rank=None, span_dropped_by_rank=None):
        self.tokens = tokens
        self.state = state
        self.compute_s = compute_s
        self.collective_s = collective_s
        self.spans_by_rank = spans_by_rank
        self.clock_by_rank = clock_by_rank
        self.metrics_by_rank = metrics_by_rank
        self.span_dropped_by_rank = span_dropped_by_rank


class _StepHandle:
    """Per-step reply board: one slot per rank, an event per rank.
    Every shard failure path deposits SOMETHING here — the owner's
    collect() must never block past its own deadline on silence."""

    __slots__ = ("gen", "step_no", "want_state", "events", "tokens",
                 "errors", "compute_s", "collective_s", "state",
                 "trace_parent", "_updates")

    def __init__(self, gen: int, step_no: int, world: int,
                 want_state: bool, trace_parent=None):
        self.gen = gen
        self.step_no = step_no
        self.want_state = want_state
        # The coordinator's shard.step span id: shard threads parent
        # their per-step spans on it (the same hand-off the
        # real protocol ships in the step frame's trace_parent field).
        self.trace_parent = trace_parent
        self.events = [threading.Event() for _ in range(world)]
        self.tokens: List[Optional[np.ndarray]] = [None] * world
        self.errors: List[Optional[BaseException]] = [None] * world
        self.compute_s = [0.0] * world
        self.collective_s = [0.0] * world
        self.state: Optional[np.ndarray] = None

    def deliver(self, rank: int, tokens: np.ndarray, compute_s: float,
                collective_s: float,
                state: Optional[np.ndarray]) -> None:
        self.tokens[rank] = tokens
        self.compute_s[rank] = compute_s
        self.collective_s[rank] = collective_s
        if state is not None:
            self.state = state
        self.events[rank].set()

    def deliver_error(self, rank: int, exc: BaseException) -> None:
        self.errors[rank] = exc
        self.events[rank].set()


class _ReduceBoard:
    """The in-process allreduce: rank-ordered deterministic sum with a
    modelled wire cost and a hard deadline. One board per set; cells
    are keyed by (generation, step, stage) so stale deposits from an
    abandoned shard thread can never reach a restarted session."""

    def __init__(self, world: int, cost_s: float, timeout_s: float,
                 codec=None):
        self.world = world
        self.cost_s = cost_s
        self.timeout_s = timeout_s
        # Codec model: the transport's quantized allreduce quantizes
        # each rank's CONTRIBUTION once and reduces decoded fp32 —
        # the board mirrors that as a roundtrip on deposit, so token
        # equivalence under int8/bf16 is testable without sockets and
        # the rounding the serving plane sees is the codec's real one.
        self.codec = codec
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self._cells: Dict[tuple, dict] = {}
        self._poisoned: Dict[int, BaseException] = {}
        # Per-thread wire busy-clock for the modelled cost: see
        # _charge_wire.
        self._wire_clock = threading.local()

    def poison(self, gen: int, exc: BaseException) -> None:
        """Fail every current and future wait of this generation —
        eager error propagation (a peer must not wait out the stall
        deadline for a partial that provably never comes) AND the
        reset/close abort path. Poison is PERMANENT for its
        generation: a hung shard thread waking long after a reset
        must fail fast against its stale generation, never squat a
        fresh cell for the full stall deadline."""
        with self._lock:
            self._poisoned.setdefault(gen, exc)
            for key in [k for k in self._cells if k[0] == gen]:
                del self._cells[key]
            self._ready.notify_all()

    def reduce(self, gen: int, step_no: int, stage: int, rank: int,
               part: np.ndarray, block: int = 0,
               cost_frac: float = 1.0) -> np.ndarray:
        # The same fault site the REAL transport fires per chunk
        # (fabric_collectives sender loops): a chaos plan targeting
        # fabric.send breaks the synthetic collective identically, so
        # the collective failure domain is testable without sockets.
        faults.fire("fabric.send")
        if self.codec is not None:
            # The codec roundtrip models the wire encode+decode; the
            # per-block shard.encode span is the same segment the real
            # transport records around its quantized chunk encodes.
            tr = obs_trace.get_tracer()
            te = time.monotonic() if tr.enabled else 0.0
            part = self.codec.roundtrip(np.asarray(part, np.float32))
            if tr.enabled:
                tr.record_span(
                    "shard.encode", te, time.monotonic(),
                    attrs={"rank": rank, "step": step_no,
                           "stage": stage, "block": block,
                           "codec": self.codec.name})
        # Cells key on the BLOCK too: the overlapped schedule runs one
        # collective per (stage, block) and every rank issues them in
        # the same order, so block-keyed cells are what keeps a rank's
        # block-1 deposit from polluting a peer's block-0 reduce.
        key = (gen, step_no, stage, block)
        deadline = time.monotonic() + self.timeout_s
        with self._lock:
            if gen in self._poisoned:
                raise self._poisoned[gen]
            cell = self._cells.setdefault(key,
                                          {"parts": {}, "left": 0})
            cell["parts"][rank] = part
            cell["left"] += 1
            self._ready.notify_all()
            while len(cell["parts"]) < self.world:
                if gen in self._poisoned:
                    raise self._poisoned[gen]
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    missing = [r for r in range(self.world)
                               if r not in cell["parts"]]
                    raise ShardCollectiveStall(
                        f"rank {rank}: peers {missing} never "
                        f"deposited for step {step_no} stage {stage} "
                        f"within {self.timeout_s}s", rank=rank)
                self._ready.wait(remaining)
            # Rank-ordered sum: every shard computes the IDENTICAL
            # float result, so the replicated states stay equal.
            parts = cell["parts"]
            total = parts[0].astype(np.float32, copy=True)
            for r in range(1, self.world):
                total = total + parts[r]
            cell["left"] -= 1
            if cell["left"] == 0 and len(parts) == self.world:
                # Last leaver only: an early leaver deleting the cell
                # would strand slower ranks re-creating it half-full.
                self._cells.pop(key, None)
        if self.cost_s:
            self._charge_wire(self.cost_s * cost_frac)
        return total

    def _charge_wire(self, cost: float) -> None:
        """Modelled wire time as BUSY-TIME accounting, not independent
        sleeps: each charge extends a per-thread deadline from the
        previous charge's scheduled end (or now, after an idle gap)
        and sleeps to it. Back-to-back block reduces therefore cost
        their SUM plus one sleep quantum — with independent sleeps,
        the ~0.5 ms kernel overshoot per sleep() multiplies by the
        block count and the overlapped schedule would be billed fake
        wire time the real transport never pays."""
        clock = self._wire_clock
        now = time.monotonic()
        deadline = max(getattr(clock, "deadline", 0.0), now) + cost
        clock.deadline = deadline
        if deadline > now:
            time.sleep(deadline - now)


class ReduceTicket:
    """One in-flight overlapped block reduce: the compute thread's
    wait handle against its shard's reducer thread."""

    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class GuardedReducer:
    """The overlap schedule's collective thread, ONE copy for every
    backend (the synthetic shard plane here, the real shard worker's
    ring): a FIFO of (ticket, payload) drained by ``fn(payload)``,
    with the _GuardedWorker discipline — every failure lands in the
    owning ticket's ``error`` and the thread never dies silently;
    ``stop()`` is the None sentinel; ``thread`` is exposed so a
    waiter can bound on liveness (a dead reducer can never set
    another event)."""

    def __init__(self, fn, name: str = "reducer"):
        self.fn = fn
        self.q: _queue.Queue = _queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=name)
        self.thread.start()

    def _run(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                return
            ticket, payload = item
            try:
                ticket.value = self.fn(payload)
            except BaseException as e:
                ticket.error = e
            ticket.event.set()

    def submit(self, payload) -> ReduceTicket:
        ticket = ReduceTicket()
        self.q.put((ticket, payload))
        return ticket

    def stop(self) -> None:
        self.q.put(None)


class _Shard:
    """One shard worker thread: FIFO over its own queue, guarded like
    _GuardedWorker — an exception lands in the step handle (and
    poisons the board generation), never kills the thread. In overlap
    mode a SECOND thread per shard (the reducer) drains block reduces
    off a FIFO so the compute thread's next-block partial runs while
    the previous block sits at the board — the in-process model of
    the shard worker's collective thread."""

    def __init__(self, owner: "SyntheticShardSet", rank: int,
                 gen: int):
        self.owner = owner
        self.rank = rank
        self.gen = gen
        self.slice: ShardSlice = owner._make_slice(rank)
        self.x = np.zeros((owner.slots, owner.d), np.float32)
        self.q: _queue.Queue = _queue.Queue()
        self._reducer: Optional[GuardedReducer] = None
        if owner.overlap:
            self._reducer = GuardedReducer(
                self._board_reduce, name=f"shard{rank}-red-g{gen}")
        self.thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"shard{rank}-g{gen}")
        self.thread.start()

    def _board_reduce(self, payload):
        step_no, stage, block, part, frac = payload
        return self.owner.board.reduce(
            self.gen, step_no, stage, self.rank, part,
            block=block, cost_frac=frac)

    def _run(self) -> None:
        owner, rank = self.owner, self.rank
        lo, hi = owner.segments[rank]
        while True:
            item = self.q.get()
            if item is None:
                return
            handle: _StepHandle = item
            if handle.gen != self.gen:
                # A stale item from before a reset raced onto this
                # queue: the handle was already aborted — ignore.
                continue
            # Per-step shard spans: the compute span's id
            # is RESERVED up front so the reduce segments can parent
            # on it before it is recorded (it closes at step end) —
            # the same reserve-then-record pattern the coordinator
            # uses for shard.step. Same taxonomy as the real shard
            # worker, so synthetic-vs-subprocess traces compare.
            tr = obs_trace.get_tracer()
            traced = tr.enabled
            sid = tr.reserve_id() if traced else None
            # t0 binds BEFORE the try: the except handler records the
            # failed step's span from it (the GL003 discipline).
            t0 = time.monotonic()
            try:
                if owner.fault_site is not None:
                    faults.fire(f"{owner.fault_site}{rank}.step",
                                attrs={"rank": rank,
                                       "step": handle.step_no})
                for i, row in handle._updates:  # type: ignore[attr-defined]
                    self.x[i] = row
                coll = [0.0]
                if owner.overlap:
                    self.x, tokens = self._step_overlapped(
                        handle, coll, tr, sid)
                else:
                    if owner.step_time_s[rank]:
                        time.sleep(owner.step_time_s[rank])

                    def reduce_fn(part, stage,
                                  _h=handle, _c=coll):
                        t = time.monotonic()
                        try:
                            out = owner.board.reduce(
                                self.gen, _h.step_no, stage, rank,
                                part)
                        except BaseException as e:
                            # The peer-side evidence of a sick ring
                            # member: how long THIS rank sat in the
                            # reduce before the poison/stall surfaced.
                            if traced:
                                tr.record_span(
                                    "shard.reduce_stall", t,
                                    time.monotonic(), parent_id=sid,
                                    attrs={"rank": rank,
                                           "step": _h.step_no,
                                           "stage": stage,
                                           "error": type(e).__name__})
                            raise
                        if traced:
                            tr.record_span(
                                "shard.reduce_blocked", t,
                                time.monotonic(), parent_id=sid,
                                attrs={"rank": rank,
                                       "step": _h.step_no,
                                       "stage": stage})
                        _c[0] += time.monotonic() - t
                        return out

                    self.x, tokens = self.slice.forward(self.x,
                                                        reduce_fn)
                total = time.monotonic() - t0
                if traced:
                    tr.record_span(
                        "shard.compute", t0, time.monotonic(),
                        span_id=sid, parent_id=handle.trace_parent,
                        attrs={"rank": rank, "step": handle.step_no,
                               "compute_s": round(
                                   max(0.0, total - coll[0]), 6),
                               "collective_s": round(coll[0], 6)})
                handle.deliver(
                    rank, tokens[lo:hi],
                    compute_s=max(0.0, total - coll[0]),
                    collective_s=coll[0],
                    state=(self.x.copy()
                           if handle.want_state and rank == 0
                           else None))
            except BaseException as e:
                if traced:
                    tr.record_span(
                        "shard.compute", t0, time.monotonic(),
                        span_id=sid, parent_id=handle.trace_parent,
                        attrs={"rank": rank, "step": handle.step_no,
                               "error": type(e).__name__})
                if isinstance(e, ShardError):
                    typed = e
                else:
                    # Wrap: the owner's collect() must raise the
                    # shard plane's typed error naming the origin
                    # rank, with the real failure chained.
                    typed = ShardStepError(
                        f"shard {rank} step failed: {e!r}", rank=rank)
                    typed.__cause__ = e
                # Poison FIRST: peers blocked in the reduce must fail
                # fast with the origin error, not a generic stall.
                owner.board.poison(self.gen, typed)
                handle.deliver_error(rank, typed)

    def _step_overlapped(self, handle: "_StepHandle", coll, tr, sid):
        """One step through forward_overlapped: block reduces queue to
        the reducer thread (submit returns immediately), the modelled
        compute cost rides INSIDE each block partial, and collective_s
        counts only the time the compute thread actually BLOCKED in
        wait — the non-hidden remainder, which is the number overlap
        exists to shrink."""
        owner, rank = self.owner, self.rank
        n_blocks = max(1, min(owner.overlap_blocks, owner.slots))
        stages = max(1, self.slice.stages)
        per_partial = owner.step_time_s[rank] / (stages * n_blocks)
        full = float(owner.slots * owner.d)
        wait_ceiling = owner.board.timeout_s + 5.0

        def submit(part, stage, block, _h=handle):
            return self._reducer.submit(
                (_h.step_no, stage, block, part,
                 part.size / full if full else 1.0))

        traced = tr.enabled

        def wait(t, _c=coll):
            t0 = time.monotonic()
            if not t.event.wait(wait_ceiling):
                if traced:
                    tr.record_span(
                        "shard.reduce_stall", t0, time.monotonic(),
                        parent_id=sid,
                        attrs={"rank": rank, "step": handle.step_no,
                               "error": "ShardCollectiveStall"})
                raise ShardCollectiveStall(
                    f"rank {rank}: overlapped reduce never settled "
                    f"within {wait_ceiling}s", rank=rank)
            _c[0] += time.monotonic() - t0
            if t.error is not None:
                if traced:
                    tr.record_span(
                        "shard.reduce_stall", t0, time.monotonic(),
                        parent_id=sid,
                        attrs={"rank": rank, "step": handle.step_no,
                               "error": type(t.error).__name__})
                raise t.error
            if traced:
                tr.record_span(
                    "shard.reduce_blocked", t0, time.monotonic(),
                    parent_id=sid,
                    attrs={"rank": rank, "step": handle.step_no})
            return t.value

        # Compute cost as busy-time accounting too (same reasoning as
        # _charge_wire: per-block sleeps must cost their sum, not
        # sum + a kernel overshoot per block).
        comp_clock = [0.0]

        def pf(xb, stage):
            if per_partial:
                now = time.monotonic()
                deadline = max(comp_clock[0], now) + per_partial
                comp_clock[0] = deadline
                if deadline > now:
                    time.sleep(deadline - now)
            return self.slice.partial(xb, stage)

        return self.slice.forward_overlapped(
            self.x, submit, wait, blocks=n_blocks, partial_fn=pf)

    def stop(self) -> None:
        self.q.put(None)
        if self._reducer is not None:
            self._reducer.stop()


def _per_rank(value: Union[float, Sequence[float]],
              world: int) -> List[float]:
    if isinstance(value, (int, float)):
        return [float(value)] * world
    vals = [float(v) for v in value]
    if len(vals) != world:
        raise ValueError(f"need {world} per-rank values, got "
                         f"{len(vals)}")
    return vals


class SyntheticShardSet:
    """N in-process shard threads behind the ShardSet contract the
    FabricExecutor drives (``reset`` / ``submit(step, updates,
    want_state)→handle`` / ``collect(handle, timeout)→StepOutput`` /
    ``close``). With ``params`` (train_step.init_params layout, E=1:
    numpy arrays or tensors) the shards run the REAL model math
    tensor-parallel on ``device``, every rank's slice a view of one
    copy of the weights there; without, the SyntheticExecutor double
    with dialable costs. ``device`` None means the CUDA card (and
    raises without one); ``"cpu"`` runs the shards on the CPU."""

    def __init__(self, world: int, slots: int, d: int = 16, *,
                 params: Optional[dict] = None, seed: int = 0,
                 step_time_s: Union[float, Sequence[float]] = 0.0,
                 collective_time_s: float = 0.0,
                 collective_timeout_s: float = 5.0,
                 fault_site: Optional[str] = None,
                 overlap: bool = False, overlap_blocks: int = 2,
                 codec: Optional[str] = None, device=None):
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.world = world
        self.slots = slots
        # One copy of the weights on the device; every rank's slice
        # (and every respawned generation's) takes views of it.
        self.device = resolve_device(device, "SyntheticShardSet")
        self.params = (params_on(params, self.device)
                       if params is not None else None)
        self.seed = seed
        self.d = (int(self.params["w1"].shape[1])
                  if params is not None else d)
        self.step_time_s = _per_rank(step_time_s, world)
        self.collective_time_s = collective_time_s
        self.fault_site = fault_site
        # Overlap: forward_overlapped's double-buffered
        # block schedule with a reducer thread per shard. Codec: the
        # transport's quantized-collective rounding, modelled at the
        # board (opt-in, exactly like the RingTransport knob).
        self.overlap = bool(overlap)
        self.overlap_blocks = max(1, int(overlap_blocks))
        self.codec = quantize.get_codec(codec)
        self.codec_name = self.codec.name if self.codec else "fp32"
        self.segments = segment_bounds(slots, world)
        self.board = _ReduceBoard(world, collective_time_s,
                                  collective_timeout_s,
                                  codec=self.codec)
        self._gen = 0
        self._lock = threading.Lock()
        self._shards: List[_Shard] = []
        self._outstanding: set = set()
        self.resets = 0

    # -- slice construction ---------------------------------------------------

    def _make_slice(self, rank: int) -> ShardSlice:
        if self.params is not None:
            return TpShardSlice(self.params, rank, self.world,
                                device=self.device)
        return DoubleShardSlice(self.d, self.seed, rank, self.world,
                                device=self.device)

    # -- lifecycle ------------------------------------------------------------

    def _ensure(self) -> None:
        if not self._shards:
            self._shards = [_Shard(self, r, self._gen)
                            for r in range(self.world)]

    def reset(self) -> None:
        """Tear down this decode session and re-rendezvous: bump the
        generation (stale deposits and late-waking hung threads can
        never touch the new session), abort every outstanding handle,
        abandon the old shard threads (a HUNG shard cannot be joined
        — it is left to die on its poison pill) and spawn fresh ones
        with zeroed state."""
        with self._lock:
            old_gen = self._gen
            self._gen += 1
            old = self._shards
            self._shards = []
            outstanding = list(self._outstanding)
        abort = ShardAborted(
            f"shard set reset (generation {old_gen} torn down)")
        self.board.poison(old_gen, abort)
        for h in outstanding:
            for r, ev in enumerate(h.events):
                if not ev.is_set():
                    h.deliver_error(r, abort)
        for sh in old:
            sh.stop()
        with self._lock:
            # Aborted handles are SETTLED, not leaked: discard exactly
            # the snapshot (never clear() — a handle submitted
            # concurrently with this reset must stay on the ledger
            # until collected or aborted, or outstanding() could hide
            # a real leak).
            self._outstanding.difference_update(outstanding)
            self._ensure()
            self.resets += 1

    def close(self) -> None:
        with self._lock:
            old = self._shards
            self._shards = []
            gen = self._gen
            outstanding = list(self._outstanding)
        abort = ShardAborted("shard set closed")
        self.board.poison(gen, abort)
        for h in outstanding:
            for r, ev in enumerate(h.events):
                if not ev.is_set():
                    h.deliver_error(r, abort)
        for sh in old:
            sh.stop()
        with self._lock:
            # Same discipline as reset(): only the handles this close
            # actually aborted leave the ledger, so the chaos
            # teardowns' outstanding() == 0 assertion stays a REAL
            # invariant (an un-aborted in-flight step survives it).
            self._outstanding.difference_update(outstanding)

    def live_shards(self) -> int:
        with self._lock:
            return sum(1 for sh in self._shards
                       if sh.thread.is_alive())

    def outstanding(self) -> int:
        """Submitted steps not yet collected — the shard plane's leak
        ledger (chaos teardowns assert 0 after close)."""
        with self._lock:
            return len(self._outstanding)

    # -- the step plane -------------------------------------------------------

    def submit(self, step_no: int, updates: Sequence,
               want_state: bool = False,
               trace_parent=None) -> _StepHandle:
        with self._lock:
            self._ensure()
            handle = _StepHandle(self._gen, step_no, self.world,
                                 want_state,
                                 trace_parent=trace_parent)
            # Rows are copied at apply time; the handle only carries
            # the references across the queue hop.
            handle._updates = [(int(i), np.asarray(row, np.float32))
                               for i, row in updates]
            self._outstanding.add(handle)
            shards = list(self._shards)
        for sh in shards:
            sh.q.put(handle)
        return handle

    def collect(self, handle: _StepHandle,
                timeout: float) -> StepOutput:
        deadline = time.monotonic() + timeout
        try:
            for r, ev in enumerate(handle.events):
                if not ev.wait(max(0.0, deadline - time.monotonic())):
                    raise ShardTimeout(
                        f"shard {r} never replied to step "
                        f"{handle.step_no} within {timeout}s", rank=r)
            for r, err in enumerate(handle.errors):
                if err is not None:
                    raise err
            tokens = np.empty((self.slots,), np.int32)
            for r, (lo, hi) in enumerate(self.segments):
                tokens[lo:hi] = handle.tokens[r]
            return StepOutput(tokens, handle.state,
                              list(handle.compute_s),
                              list(handle.collective_s))
        finally:
            with self._lock:
                self._outstanding.discard(handle)
