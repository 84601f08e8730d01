"""The executor seam: what a batch slot's worth of model step IS.

The continuous-batching scheduler drives replicas through two
contracts, neither of which imports jax:

  * the synchronous seam — `step(x[slots, d]) -> y[slots, d]`, the
    original shape: the full batch round-trips host numpy every step.
  * the two-phase decode seam — `reset()` / `submit(updates) -> handle`
    / `collect(handle) -> token_ids[slots]`: slot state lives INSIDE
    the executor (on device for LocalExecutor), `submit` applies the
    step's slot updates ([(slot, row[d])] — admitted prompts and zeroed
    freed slots) and dispatches the step, `collect` blocks until the
    step's per-slot argmax token ids are available. When `pipelined`
    is True, submit returns while the step is still executing, so the
    scheduler can do retire/admit bookkeeping for neighbouring steps
    while the device runs — the overlap pipelining exists for. The base
    class adapts any step()-only executor to the two-phase contract
    (correct, eager, no overlap).

That seam is what lets replicas be swapped:

  * LocalExecutor — the in-process replica: a device-resident
    infer.DecodeStep (pipelined, the default) or infer.make_infer_step
    (mode="sync", the original loop kept as the measured baseline) on a
    serving mesh whose ep ranks share one device (the CUDA card, or the
    CPU when asked), params from train_step.init_params or carried
    across. The bench and smoke tests run this one.
  * SyntheticExecutor — a jax-free replica with a CONTROLLED per-step
    cost: the scheduler/backpressure plane's test double (the
    RecordingDataplane idiom from bench.py), and the knob that makes
    overload AND overlap tests deterministic on shared CI boxes
    (pipelined=True runs steps on a worker thread — a "device" whose
    step cost is exactly step_time_s).
  * A fabric-worker-backed replica — the planned third implementation:
    `submit` ships the step's updates to a pool of
    parallel/fabric_worker.py-style processes inside operator-attached
    pod netns (same rendezvous, a forward-only program instead of the
    train slice) and `collect` reads token ids off the fabric — the
    two-phase contract is exactly the async boundary a remote replica
    needs. See docs/serving.md.

ReplicaPool owns one ContinuousBatcher per executor, all fed from one
AdmissionQueue — requests land on whichever replica frees a slot first.
"""

from __future__ import annotations

import logging
import queue as _queue
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import faults
from ..obs import trace as obs_trace
from .api import (DEADLINE_QUEUED_ERROR, RETRIES_EXHAUSTED_ERROR,
                  GenerateRequest)

log = logging.getLogger(__name__)

Update = Tuple[int, np.ndarray]  # (slot index, row[d]) applied at submit


class _Pending:
    """Handle for a step in flight on a synthetic executor's worker."""

    __slots__ = ("event", "tokens", "error")

    def __init__(self):
        self.event = threading.Event()
        self.tokens: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class _GuardedWorker:
    """Single-thread FIFO "device" shared by the synthetic executors
    (row plane here, token plane in kvcache/executor.py). EVERY
    failure path must land in the owning handle and the thread must
    survive — an exception escaping the loop used to kill it silently,
    so collect() on any outstanding (or future) handle blocked forever
    and the replica wedged with no error anywhere. That discipline
    (the self-healing lesson) lives HERE, once, parameterized by the per-item
    step and reset callables."""

    def __init__(self, name: str, step_fn, reset_fn):
        self._name = name
        self._step_fn = step_fn        # payload -> tokens
        self._reset_fn = reset_fn      # () -> None
        self._work: Optional[_queue.Queue] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def started(self) -> bool:
        return self._thread is not None

    def _ensure(self) -> None:
        if self._thread is None:
            self._work = _queue.Queue()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name=self._name)
            self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            pending = None
            try:
                if item[0] == "reset":
                    pending = item[1]
                    self._reset_fn()
                else:
                    _, payload, pending = item
                    pending.tokens = self._step_fn(payload)
            except BaseException as e:  # surfaced by collect()/reset()
                if pending is not None:
                    pending.error = e
                else:
                    log.exception(
                        "%s: malformed work item %r (dropped; worker "
                        "survives)", self._name, item)
            finally:
                if pending is not None:
                    pending.event.set()

    def submit(self, payload) -> _Pending:
        self._ensure()
        pending = _Pending()
        self._work.put(("step", payload, pending))
        return pending

    def reset(self) -> None:
        """Serialize behind queued steps and RE-RAISE a worker-side
        failure instead of reporting a clean session over poisoned
        state."""
        self._ensure()
        pending = _Pending()
        self._work.put(("reset", pending))
        pending.event.wait()
        if pending.error is not None:
            raise pending.error

    def close(self, timeout: float = 5.0) -> None:
        if self._thread is not None:
            self._work.put(None)
            self._thread.join(timeout=timeout)
            self._thread = None


class Executor:
    """One model replica: a fixed number of batch slots over a fixed
    feature dim. All methods are called from the replica's single
    batcher thread; they need not be reentrant."""

    slots: int
    d: int
    #: True when submit() natively dispatches asynchronously (returns
    #: while the step executes). The scheduler picks its pipelined loop
    #: off this flag; the base adapter below is eager (no overlap) but
    #: contract-correct for any step()-only executor.
    pipelined: bool = False
    #: True for paged-KV executors (serving/kvcache): the scheduler
    #: runs its token-level KV loop (attach leases, chunked prefill,
    #: NO_TOKEN-aware retire) instead of the [slots, d] row plane.
    kv: bool = False
    #: True when the executor runs the draft/verify speculative mode
    #: (KV plane only): collect() returns [slots, chunk]
    #: accepted-token RUNS instead of [slots] single tokens, and the
    #: executor presents pipelined=False — the next plan drafts from
    #: the previous step's accepted tokens, so the collect-before-
    #: plan (sync) loop shape is structural. The batcher needs no
    #: branch on this: retire normalizes both collect shapes.
    speculative: bool = False
    #: True when this replica's step spans multiple fabric shard
    #: workers (serving/sharded FabricExecutor): the pool publishes it
    #: as the `sharded` dimension on serving_pool_replicas so a
    #: dashboard separates single-host from fabric-sharded capacity.
    sharded: bool = False
    _resident: Optional[np.ndarray] = None

    def step(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- two-phase decode contract (base: eager adapter over step()) ----------

    def reset(self) -> None:
        """Zero the resident slot state (decode session start)."""
        self._resident = np.zeros((self.slots, self.d), np.float32)

    def submit(self, updates: Sequence[Update], step=None,
               request_ids=None, occupants=None):
        """Apply slot updates, dispatch one decode step; returns an
        opaque handle for collect(). Base implementation runs the step
        eagerly on the caller's thread. `step`/`request_ids` are
        diagnostic context for overflow errors (see
        DecodeStep.__call__); `occupants` is the full occupant
        request-id list, trace-only context (the sharded coordinator
        stamps it on its per-step shard.step span so worker spans
        link into each occupant's tree); the eager path has no
        fixed-shape limit and ignores them."""
        if self._resident is None:
            self.reset()
        for i, row in updates:
            self._resident[i] = row
        y = np.asarray(self.step(self._resident), np.float32)
        self._resident = y
        # One batched argmax for every slot — the per-row python loop
        # the sync scheduler used to run is measurable at step rates.
        return y.argmax(axis=1).astype(np.int32)

    def collect(self, handle) -> np.ndarray:
        """Block until the submitted step finishes; returns the [slots]
        int32 per-slot argmax token ids."""
        return handle

    def close(self) -> None:
        pass


class LocalExecutor(Executor):
    """In-process replica: the forward-only train_step model on a serving
    mesh whose ep ranks share one device.

    mode="pipelined" (default) builds a device-resident infer.DecodeStep:
    slot state lives on the device across steps, submit() stages the
    admitted rows in pinned buffers, queues the step and an asynchronous
    copy of its [slots] token ids into pinned host memory, and returns
    while the card runs; collect() waits for that copy alone. mode="sync"
    keeps the original shape (make_infer_step + a host copy of the whole
    batch a step) as the comparison baseline.

    Builds demo params when none are given (``train_step.init_params``
    from ``seed``); otherwise takes params in init_params layout, numpy
    arrays (``train_step.params_from_numpy``) or tensors; a float32 dict
    already on ``device`` is shared, not copied. All of a replica's work
    runs on its own CUDA stream. ``device=None`` means ``"cuda"``: the
    executor runs on the card unless the caller asks for the CPU, and
    with no CUDA device it raises. ``kernel=None`` means the all-to-all
    kernel (``"cuda"``) for the expert exchanges on a CUDA device and its
    plain version (``"torch"``) on the CPU; ``kernel="cuda"`` on the CPU
    raises. First-call costs are paid in the constructor (the decode
    step's warm-up, and ``warmup=True``'s dispatched step) so admission
    latency never includes them."""

    def __init__(self, params=None, mesh=None, slots: int = 8,
                 capacity_factor: float = 4.0, S: int = 1, d: int = 16,
                 h: int = 32, E: int = 1, seed: int = 0,
                 warmup: bool = True, mode: str = "pipelined",
                 device=None, kernel: Optional[str] = None):
        import contextlib
        import functools

        import torch

        from ..device import resolve_device
        from ..parallel.train_step import init_params, shard_params
        from .infer import (TokenHandle, make_decode_step, make_infer_step,
                            serving_mesh)

        if mode not in ("pipelined", "sync"):
            raise ValueError(f"mode must be pipelined|sync, got {mode!r}")
        self.pipelined = mode == "pipelined"
        self.device = resolve_device(device, "LocalExecutor")
        self.mesh = mesh if mesh is not None else serving_mesh()
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(device=self.device) if cuda else None
        if cuda:
            # Weights handed in were written on the caller's stream.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        # Bound to the stream, not to self: a closure over self would be a
        # cycle that keeps a dropped executor's device memory until the
        # cycle collector runs.
        self._on_stream = (functools.partial(torch.cuda.stream, self._stream)
                           if cuda else contextlib.nullcontext)
        with self._on_stream():
            if params is None:
                if E != self.mesh["ep"]:
                    raise ValueError(
                        f"demo params need E == ep axis size "
                        f"{self.mesh['ep']}, got {E}")
                params = init_params(S=S, d=d, h=h, E=E, seed=seed,
                                     device=self.device)
            shard = self.mesh["dp"] * self.mesh["ep"]
            if slots % shard:
                raise ValueError(
                    f"slots={slots} must divide over dp*ep={shard} "
                    f"(batch rows shard over both)")
            self.slots = slots
            self.params = shard_params(params, self.mesh, self.device)
            self.d = int(self.params["w1"].shape[1])
            if self.pipelined:
                self._decode = make_decode_step(
                    self.mesh, self.params, slots, capacity_factor,
                    kernel=kernel, device=self.device)
                self.kernel = self._decode.kernel
                self._handle = TokenHandle
                self._xdev = self._decode.init_state()
            else:
                self._infer = make_infer_step(
                    self.mesh, capacity_factor, kernel=kernel,
                    device=self.device)
                self.kernel = self._infer.kernel
        if warmup:
            if self.pipelined:
                # One dispatched step so the first request also skips
                # any first-execution lazy initialization.
                self.collect(self.submit([]))
                self.reset()
            else:
                self.step(np.zeros((self.slots, self.d), np.float32))

    def step(self, x: np.ndarray) -> np.ndarray:
        with self._on_stream():
            if not self.pipelined:
                return self._infer(self.params, x).cpu().numpy()
            # Compat adapter over the resident path: load x wholesale,
            # run one step, materialize the full next state — round-trips
            # the batch and exists for debugging, not the hot loop.
            rows = np.asarray(x, np.float32)
            self._xdev, _tokens = self._decode(
                self._xdev, list(enumerate(rows)))
            return self._xdev.cpu().numpy()

    def reset(self) -> None:
        if self.pipelined:
            with self._on_stream():
                self._xdev = self._decode.init_state()
        else:
            super().reset()

    def submit(self, updates: Sequence[Update], step=None,
               request_ids=None, occupants=None):
        if not self.pipelined:
            return super().submit(updates)
        # Both the state and the tokens stay in flight: the step and the
        # copy of its ids to pinned host memory are queued, not waited.
        with self._on_stream():
            self._xdev, tokens = self._decode(self._xdev, updates,
                                              step=step,
                                              request_ids=request_ids)
            return self._handle(tokens)

    def collect(self, handle) -> np.ndarray:
        if not self.pipelined:
            return handle
        return handle.wait()


class SyntheticExecutor(Executor):
    """Deterministic jax-free replica with a dialable per-step cost.

    y = tanh(x @ W) for a fixed seeded W, after sleeping step_time_s —
    the model-cost knob that makes scheduler/backpressure tests assert
    timing properties instead of hoping the CI box is quiet. With
    pipelined=True, steps run FIFO on a worker thread: submit returns
    immediately and collect blocks on the step's completion, so
    scheduler-overlap assertions (wall ≈ max(host, device), not the
    sum) hold by construction on shared CI boxes."""

    def __init__(self, slots: int = 8, d: int = 16,
                 step_time_s: float = 0.0, seed: int = 0,
                 pipelined: bool = False,
                 fault_site: Optional[str] = None):
        self.slots = slots
        self.d = d
        self.step_time_s = step_time_s
        self.pipelined = pipelined
        # Fault seam INSIDE the device: with pipelined=True the step
        # runs on the worker thread, where a FaultyExecutor wrapper
        # (which intercepts the submit/collect seam on the scheduler
        # thread) can't reach — naming a site here is how chaos tests
        # break the "device" itself.
        self.fault_site = fault_site
        self._w = np.random.RandomState(seed).randn(d, d).astype(
            np.float32) / np.sqrt(d)
        self.steps = 0
        # The base eager adapter IS one step of the contract (apply
        # updates, step, batched argmax); the worker only moves it off
        # the submitter's thread.
        self._worker = _GuardedWorker(
            "synthetic-step",
            step_fn=lambda updates: Executor.submit(self, updates),
            reset_fn=self._zero_resident)

    def _zero_resident(self) -> None:
        self._resident = np.zeros((self.slots, self.d), np.float32)

    def step(self, x: np.ndarray) -> np.ndarray:
        if self.fault_site is not None:
            faults.fire(f"{self.fault_site}.step")
        if self.step_time_s:
            time.sleep(self.step_time_s)
        self.steps += 1
        return np.tanh(x @ self._w)

    # -- pipelined: the worker thread is the "device" -------------------------

    def reset(self) -> None:
        if not self.pipelined or not self._worker.started:
            super().reset()
            return
        # The worker owns the resident state between submit and
        # collect; a reset must serialize behind queued steps.
        self._worker.reset()

    def submit(self, updates: Sequence[Update], step=None,
               request_ids=None, occupants=None):
        if not self.pipelined:
            return super().submit(updates)
        if self._resident is None:
            self._resident = np.zeros((self.slots, self.d), np.float32)
        return self._worker.submit(list(updates))

    def collect(self, handle) -> np.ndarray:
        if not self.pipelined:
            return handle
        handle.event.wait()
        if handle.error is not None:
            raise handle.error
        return handle.tokens

    def close(self) -> None:
        self._worker.close()


REPLICA_LIVE = "live"
REPLICA_BACKOFF = "backoff"
REPLICA_PARKED = "parked"


class ReplicaPool:
    """One ContinuousBatcher per executor over a shared AdmissionQueue
    — and, when `supervise` (the default), the SUPERVISOR that keeps
    them converged on "every replica live":

      * detection — a monitor thread polls every `poll_s` for replica
        DEATH (batcher thread exited with a recorded failure) and
        WEDGE (the batcher has been blocked on the device — step() or
        collect() — longer than `watchdog_s`; a hung device step can
        never time itself out, so the deadline lives out here);
      * requeue — the dead replica's in-flight requests are seized
        (under the batcher's settle lock: no double-settle) and
        re-admitted at the FRONT of the shared queue with a
        per-request attempts budget — past `max_attempts` replica
        failures a request 500s with RETRIES_EXHAUSTED_ERROR; a
        request whose deadline lapsed mid-failure settles exactly once
        (truncated 200 if it already has tokens, 503 deadline-shed
        otherwise) and never re-enters the queue;
      * restart — a fresh ContinuousBatcher over the same executor
        (which `reset()`s at loop start) under exponential backoff +
        jitter (SRE retry discipline: backoff bounds the flap rate,
        jitter de-synchronizes a fleet of restarts);
      * circuit breaker — `breaker_threshold` failures inside
        `breaker_window_s` PARK the replica: no more restarts, the
        pool serves degraded, and the operator sees
        serving_breaker_state=1 instead of an infinite crash loop.

    `watchdog_s` bounds the time a batcher may sit blocked on the
    device (step/collect/reset); executors must therefore pay their
    compile cost in the CONSTRUCTOR (the LocalExecutor contract since
    the first serving plane — warmup=True) or hand the pool a watchdog_s above their
    worst first step, or a cold compile reads as a wedge.

    Readiness contract consumed by the HTTP front-end: live replicas <
    `quorum` (default: all of them) → /readyz 503 "degraded"; zero
    live replicas → /healthz goes red too. Recovery metrics:
    serving_replica_restarts_total, serving_requeue_total{outcome},
    serving_breaker_state, serving_pool_replicas{state}."""

    def __init__(self, executors: Sequence[Executor], queue,
                 registry=None, *, supervise: bool = True,
                 watchdog_s: float = 5.0, max_attempts: int = 3,
                 restart_backoff_s: float = 0.05,
                 restart_backoff_cap_s: float = 2.0,
                 breaker_window_s: float = 30.0,
                 breaker_threshold: int = 5,
                 quorum: Optional[int] = None,
                 poll_s: float = 0.02, seed: int = 0,
                 tracer=None, flight_recorder=None,
                 role: str = "unified",
                 name_prefix: str = "replica",
                 batcher_kwargs: Optional[dict] = None):
        from .scheduler import ContinuousBatcher

        if not executors:
            raise ValueError("a pool needs at least one executor")
        # Role-typed pools (serving/disagg): `role` is the
        # serving_pool_replicas label (prefill|decode|unified) and
        # `name_prefix` namespaces replica names so a prefill pool's
        # replica0 and a decode pool's replica0 never collide in
        # per-replica series. `batcher_kwargs` rides every batcher
        # construction INCLUDING supervisor restarts — a restarted
        # prefill replica must keep its handoff hook.
        self.role = str(role)
        self.name_prefix = str(name_prefix)
        self.batcher_kwargs = dict(batcher_kwargs or {})
        self.queue = queue
        self.registry = registry
        if registry is not None:
            # Executors that keep their own step-internal series (the
            # FabricExecutor's shard collective/skew histograms) adopt
            # the pool's registry so a ServingServer-built pool
            # exposes them on /metrics with no extra wiring.
            for ex in executors:
                bind = getattr(ex, "bind_registry", None)
                if bind is not None:
                    bind(registry)
        self.tracer = (tracer if tracer is not None
                       else obs_trace.get_tracer())
        # Armed by the serving front-end (obs.FlightRecorder): the
        # supervisor snapshots the trace ring on wedge/death/breaker —
        # the moment the evidence exists, not when someone reproduces.
        self.flight_recorder = flight_recorder
        self.executors = list(executors)
        self.supervised = bool(supervise)
        self.watchdog_s = watchdog_s
        self.max_attempts = max_attempts
        self.restart_backoff_s = restart_backoff_s
        self.restart_backoff_cap_s = restart_backoff_cap_s
        self.breaker_window_s = breaker_window_s
        self.breaker_threshold = breaker_threshold
        self.quorum = (len(self.executors) if quorum is None
                       else max(1, int(quorum)))
        self.poll_s = poll_s
        self._rng = random.Random(seed)
        self._Batcher = ContinuousBatcher
        # _plock guards the state arrays and batcher swaps (monitor
        # thread vs readers like live_count); the per-batcher settle
        # lock guards request ownership.
        self._plock = threading.Lock()
        # Replica names are STABLE across attach/detach splices (the
        # autoscaler's role flips): index-derived names would rename
        # every later replica's metric series on each flip.
        self._names: List[str] = [f"{self.name_prefix}{i}"
                                  for i in range(len(self.executors))]
        self._name_seq = len(self.executors)
        self.batchers: List = [
            self._make_batcher(i, ex)
            for i, ex in enumerate(self.executors)
        ]
        n = len(self.executors)
        self._state = [REPLICA_LIVE] * n
        self._restart_at: List[Optional[float]] = [None] * n
        self._fail_times: List[deque] = [deque() for _ in range(n)]
        # Nonzero while a seize→requeue hand-off is in flight: in that
        # window the seized requests are in no batcher's slots and not
        # yet back in the queue, and quiesce() must not read the pool
        # as drained around them.
        self._seizing = 0
        self.restarts = [0] * n
        self._sup_stop = threading.Event()
        self._sup_thread: Optional[threading.Thread] = None

    def _rname(self, i: int) -> str:
        if i < len(self._names):
            return self._names[i]
        return f"{self.name_prefix}{i}"

    def _make_batcher(self, i: int, ex: Executor):
        return self._Batcher(ex, self.queue, registry=self.registry,
                             replica=self._rname(i),
                             crash_only=self.supervised,
                             tracer=self.tracer,
                             **self.batcher_kwargs)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        for b in self.batchers:
            b.start()
        if self.supervised:
            self._publish_state()
            self._sup_thread = threading.Thread(
                target=self._supervise, daemon=True,
                name="replica-supervisor")
            self._sup_thread.start()

    def stop(self) -> None:
        # Supervisor first: a replica dying DURING teardown must not be
        # requeued into a queue the server is about to fail_all().
        self._sup_stop.set()
        if self._sup_thread is not None:
            self._sup_thread.join(timeout=5)
        for b in self.batchers:
            b.stop()
        for ex in self.executors:
            ex.close()

    def active(self) -> int:
        return sum(b.active for b in self.batchers)

    # -- observability --------------------------------------------------------

    def live_count(self) -> int:
        """Replicas currently serving. Supervised: state LIVE (the
        monitor flips it within ~poll_s of a death/wedge).
        Unsupervised: batcher threads actually running."""
        with self._plock:
            if self.supervised:
                return sum(1 for s in self._state if s == REPLICA_LIVE)
            return sum(1 for b in self.batchers if b.thread_alive)

    def states(self) -> Dict[str, str]:
        with self._plock:
            return {self._rname(i): s
                    for i, s in enumerate(self._state)}

    def all_parked(self) -> bool:
        """True when every replica's breaker is open — no restart will
        ever be scheduled again, so the pool is dead, not degraded."""
        with self._plock:
            return all(s == REPLICA_PARKED for s in self._state)

    def _publish_state(self) -> None:
        if self.registry is None:
            return
        with self._plock:
            shard_dim = ["true" if getattr(ex, "sharded", False)
                         else "false" for ex in self.executors]
            counts = {(st, sh): 0.0
                      for st in (REPLICA_LIVE, REPLICA_BACKOFF,
                                 REPLICA_PARKED)
                      for sh in ("true", "false")}
            for i, s in enumerate(self._state):
                counts[(s, shard_dim[i])] += 1
        for (st, sh), n in counts.items():
            self.registry.gauge_set(
                "serving_pool_replicas", float(n),
                {"state": st, "sharded": sh, "role": self.role},
                help="replicas by supervision state, fabric-sharding, "
                     "and serving role (prefill|decode|unified)")

    def _count(self, name: str, labels: dict, help: str = "") -> None:
        if self.registry is not None:
            self.registry.counter_inc(name, labels, help=help)

    # -- the supervisor -------------------------------------------------------

    def _supervise(self) -> None:
        while not self._sup_stop.is_set():
            now = time.monotonic()
            for i in range(len(self.executors)):
                # Per-replica guard: the monitor IS the self-healing
                # plane — one throw here (thread exhaustion during a
                # fault storm, a poisoned executor attribute) must cost
                # at most this replica this cycle, never the thread.
                try:
                    with self._plock:
                        if i >= len(self.batchers):
                            # A detach_replica spliced the arrays
                            # mid-cycle; the next cycle re-ranges.
                            break
                        st = self._state[i]
                        b = self.batchers[i]
                        restart_at = self._restart_at[i]
                    if st == REPLICA_LIVE:
                        bs = b.blocked_since
                        wedged = (bs is not None
                                  and now - bs > self.watchdog_s)
                        dead = (not b.thread_alive and not b.stopping
                                and b._thread is not None)
                        if dead or wedged:
                            self._replica_down(
                                i, b, "wedged" if wedged else "died")
                    elif st == REPLICA_BACKOFF and restart_at is not None \
                            and now >= restart_at:
                        self._restart(i)
                except Exception:
                    log.exception("supervisor: %s cycle failed",
                                  self._rname(i))
            self._sup_stop.wait(self.poll_s)

    def _replica_down(self, i: int, batcher, why: str) -> None:
        err = batcher.failure
        self.tracer.event(
            "supervisor.detect",
            attrs={"replica": self._rname(i), "why": why,
                   "error": str(err)[:200] if err else None})
        # _seizing flips BEFORE seize(): at no instant is a seized
        # request in none of {batcher slots, this hand-off, the queue}
        # — the same closed-accounting contract the queue's inflight
        # counter keeps for pop→place (quiesce checks all three).
        with self._plock:
            self._seizing += 1
        try:
            t0 = time.monotonic()
            seized = batcher.seize()
            rids = [r.request_id for r in seized]
            self.tracer.record_span(
                "supervisor.seize", t0, time.monotonic(),
                attrs={"replica": self._rname(i), "why": why,
                       "request_ids": rids})
            self.tracer.decision("seize", replica=self._rname(i),
                                 why=why, request_ids=rids)
            log.warning("%s %s (%s); requeueing %d in-flight "
                        "request(s): %s", self._rname(i), why, err,
                        len(seized),
                        rids)
            self._requeue(i, seized)
        finally:
            with self._plock:
                self._seizing -= 1
        self._record_failure(i)
        self._flight_snapshot(why, replica=i)

    def _record_failure(self, i: int) -> None:
        """Window bookkeeping shared by the death/wedge path and a
        failed restart: park past the breaker threshold, otherwise
        schedule the next restart under exponential backoff + jitter."""
        now = time.monotonic()
        window = self._fail_times[i]
        window.append(now)
        while window and window[0] < now - self.breaker_window_s:
            window.popleft()
        if len(window) >= self.breaker_threshold:
            with self._plock:
                self._state[i] = REPLICA_PARKED
                self._restart_at[i] = None
            if self.registry is not None:
                self.registry.gauge_set(
                    "serving_breaker_state", 1.0,
                    {"replica": self._rname(i)},
                    help="1 when the replica's restart breaker is "
                         "open (replica parked)")
            self.tracer.event(
                "supervisor.breaker_open",
                attrs={"replica": self._rname(i),
                       "failures_in_window": len(window),
                       "window_s": self.breaker_window_s})
            self.tracer.decision("breaker_open",
                                 replica=self._rname(i))
            log.error("%s: breaker OPEN (%d failures in %.0fs) "
                      "— parked, pool degraded", self._rname(i),
                      len(window), self.breaker_window_s)
            # Publish BEFORE the flight snapshot: the snapshot is
            # disk I/O that can take >100 ms on a loaded box, and a
            # scraper reading serving_pool_replicas inside that
            # window must not see the replica parked in states() but
            # not in the gauge (observed as a full-suite flake).
            self._publish_state()
            self._flight_snapshot("breaker_open", replica=i)
        else:
            delay = min(self.restart_backoff_cap_s,
                        self.restart_backoff_s
                        * (2 ** (len(window) - 1)))
            delay *= 1.0 + 0.25 * self._rng.random()  # de-sync restarts
            with self._plock:
                self._state[i] = REPLICA_BACKOFF
                self._restart_at[i] = now + delay
        self._publish_state()

    def _requeue(self, i: int, reqs: List[GenerateRequest]) -> None:
        now = time.monotonic()
        replica = self._rname(i)
        for req in reqs:
            if req.done:
                # Settled before (or while) the replica fell over —
                # nothing to do, and settling again is the double-
                # settle this path exists to prevent.
                outcome = "already_done"
            elif req.deadline <= now:
                # Deadline lapsed mid-failure: settle ONCE, never
                # re-enter the queue (the pop-side shed would settle it
                # a second time). With tokens already decoded this is
                # the mid-decode truncation contract; with none it is
                # the queued-deadline shed.
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
                    lease = getattr(req, "kv_lease", None)
                    if lease is not None and lease.resumable:
                        # Paged-KV retry: the lease — the
                        # request's block-table ownership — rides the
                        # queue with it, so the restarted replica
                        # RE-ATTACHES the surviving pages and resumes
                        # from the last settled token. Tokens are
                        # KEPT: the deterministic recurrence makes the
                        # resumed stream identical to an unfailed
                        # run's, at a replay cost of in-flight steps
                        # instead of prompt-length re-decode.
                        outcome = "requeued_kv"
                    else:
                        # Fresh decode from the prompt: the recurrence
                        # is deterministic, so the retried stream is
                        # identical to an unfailed run's —
                        # half-decoded state must not leak into the
                        # retry.
                        req.tokens.clear()
                        req.truncated = False
                        outcome = "requeued"
                    self.queue.requeue(req)
            self._count("serving_requeue_total",
                        {"replica": replica, "outcome": outcome},
                        help="in-flight requests seized from failed "
                             "replicas, by disposition")
            # Parented to the request's root span: the recovery chain
            # (seize → requeue → re-decode) shows up in ITS trace, not
            # only in replica-level series.
            self.tracer.event(
                "supervisor.requeue", request_id=req.request_id,
                parent_id=req.trace_parent,
                attrs={"replica": replica, "outcome": outcome,
                       "attempts": req.attempts})
            self.tracer.decision("requeue", request_id=req.request_id,
                                 replica=replica, outcome=outcome)

    # -- autoscaler surface ----------------------------------------

    def _requeue_policy(self, name: str, reqs: List[GenerateRequest],
                        why: str) -> None:
        """Requeue requests displaced by POLICY (role flip, park-to-
        zero) rather than failure. Same exactly-once dispositions as
        the supervisor's `_requeue`, with one deliberate difference:
        `attempts` is NOT burned — the replica did nothing wrong and
        neither did the request, so a flip must never push a request
        toward RETRIES_EXHAUSTED_ERROR."""
        now = time.monotonic()
        for req in reqs:
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
                lease = getattr(req, "kv_lease", None)
                if lease is not None and lease.resumable:
                    # The executor object survives the flip, so the
                    # lease's pages do too: tokens are KEPT and the
                    # next attach either resumes (same executor) or
                    # releases-and-reprefills (foreign) — byte-
                    # identical either way.
                    outcome = f"{why}_kv"
                else:
                    req.tokens.clear()
                    req.truncated = False
                    outcome = why
                self.queue.requeue(req)
            self._count("serving_requeue_total",
                        {"replica": name, "outcome": outcome},
                        help="in-flight requests seized from failed "
                             "replicas, by disposition")
            self.tracer.event(
                "supervisor.requeue", request_id=req.request_id,
                parent_id=req.trace_parent,
                attrs={"replica": name, "outcome": outcome,
                       "attempts": req.attempts})

    def detach_replica(self, min_live: int = 1):
        """Remove one LIVE replica from the pool (the autoscaler's
        role-flip donor side). Seizes the batcher under its settle
        lock, requeues its in-flight occupants exactly once WITHOUT
        burning `attempts`, splices every parallel array, and returns
        the executor — still warm, pages intact — for
        `attach_replica` on the destination pool. Returns None rather
        than dropping the pool below `min_live` live replicas."""
        with self._plock:
            live = [j for j, s in enumerate(self._state)
                    if s == REPLICA_LIVE]
            if len(live) <= max(1, int(min_live)):
                return None
            i = live[-1]
            b = self.batchers[i]
            name = self._rname(i)
            self._seizing += 1
        try:
            seized = b.seize()
            b.stop(timeout=5.0)  # slots already empty: fails nothing
            self._requeue_policy(name, seized, "requeued_flip")
            with self._plock:
                ex = self.executors[i]
                for arr in (self.executors, self.batchers, self._state,
                            self._restart_at, self._fail_times,
                            self.restarts, self._names):
                    del arr[i]
                # A shrunk pool must not read as permanently degraded.
                self.quorum = max(1, min(self.quorum,
                                         len(self.executors)))
        finally:
            with self._plock:
                self._seizing -= 1
        self.tracer.event("pool.detach_replica",
                          attrs={"role": self.role, "replica": name,
                                 "seized": len(seized)})
        self._publish_state()
        return ex

    def attach_replica(self, ex: Executor) -> str:
        """Adopt an executor (the role-flip recipient side): build a
        batcher with THIS pool's `batcher_kwargs` — that is what makes
        the replica's new role real (a prefill pool's kwargs carry the
        handoff hook; a decode pool's do not) — and start serving from
        this pool's queue. Returns the replica's stable name."""
        if self.registry is not None:
            bind = getattr(ex, "bind_registry", None)
            if bind is not None:
                bind(self.registry)
        with self._plock:
            self.executors.append(ex)
            i = len(self.executors) - 1
            name = f"{self.name_prefix}{self._name_seq}"
            self._name_seq += 1
            self._names.append(name)
            b = self._make_batcher(i, ex)
            self.batchers.append(b)
            self._state.append(REPLICA_LIVE)
            self._restart_at.append(None)
            self._fail_times.append(deque())
            self.restarts.append(0)
        b.start()
        self.tracer.event("pool.attach_replica",
                          attrs={"role": self.role, "replica": name})
        self._publish_state()
        return name

    def park_replica(self, i: Optional[int] = None,
                     min_live: int = 0) -> Optional[str]:
        """Scale-to-zero: stop a LIVE replica and PARK it — the same
        terminal state the restart breaker uses, so the supervisor
        leaves it alone and states()/serving_pool_replicas read it as
        parked capacity. In-flight occupants requeue exactly once via
        the policy path (no `attempts` burn). Returns the replica
        name, or None when parking would drop live below
        `min_live` (or nothing is live)."""
        with self._plock:
            live = [j for j, s in enumerate(self._state)
                    if s == REPLICA_LIVE]
            if not live or len(live) - 1 < max(0, int(min_live)):
                return None
            if i is None:
                i = live[-1]
            elif self._state[i] != REPLICA_LIVE:
                return None
            b = self.batchers[i]
            name = self._rname(i)
            # State flips BEFORE the seize so the monitor never reads
            # the stopping batcher as a death to requeue+restart.
            self._state[i] = REPLICA_PARKED
            self._restart_at[i] = None
            self._seizing += 1
        try:
            seized = b.seize()
            b.stop(timeout=5.0)
            self._requeue_policy(name, seized, "requeued_park")
        finally:
            with self._plock:
                self._seizing -= 1
        self.tracer.event("pool.park_replica",
                          attrs={"role": self.role, "replica": name,
                                 "seized": len(seized)})
        self._publish_state()
        return name

    def unpark_replica(self, i: Optional[int] = None) -> Optional[str]:
        """Wake a PARKED replica (scale-from-zero). Builds a fresh
        batcher over the same executor — distinct from `_restart` so
        autoscale wakes never count as failure-recovery restarts and
        never touch the breaker window."""
        with self._plock:
            parked = [j for j, s in enumerate(self._state)
                      if s == REPLICA_PARKED]
            if i is None:
                if not parked:
                    return None
                i = parked[0]
            elif self._state[i] != REPLICA_PARKED:
                return None
            ex = self.executors[i]
            name = self._rname(i)
        try:
            b = self._make_batcher(i, ex)
        except Exception:
            log.exception("%s: unpark construction failed", name)
            return None
        with self._plock:
            if self._state[i] != REPLICA_PARKED:
                return None  # raced a concurrent unpark
            self.batchers[i] = b
            self._state[i] = REPLICA_LIVE
            self._restart_at[i] = None
            # Fresh start, fresh breaker window: the park that put it
            # here may have been policy, and even a breaker park's
            # stale failures should not instantly re-park the wake.
            self._fail_times[i].clear()
        b.start()
        if self.registry is not None:
            self.registry.gauge_set(
                "serving_breaker_state", 0.0, {"replica": name},
                help="1 when the replica's restart breaker is "
                     "open (replica parked)")
        self.tracer.event("pool.unpark_replica",
                          attrs={"role": self.role, "replica": name})
        self._publish_state()
        return name

    def _restart(self, i: int) -> None:
        ex = self.executors[i]
        t0 = time.monotonic()
        try:
            b = self._make_batcher(i, ex)
        except Exception:
            # Construction failure counts as another replica failure:
            # same window bookkeeping, so backoff escalates and the
            # breaker eventually parks a replica that cannot even be
            # rebuilt. (Executor-level failures surface later, in the
            # new batcher thread's reset/step, and come back through
            # the normal death path.)
            log.exception("%s: restart construction failed",
                          self._rname(i))
            self._record_failure(i)
            return
        with self._plock:
            self.batchers[i] = b
            # restarts increments under the same lock and BEFORE the
            # state flips LIVE: an observer seeing the pool at full
            # strength must also see every restart that got it there.
            self.restarts[i] += 1
            self._state[i] = REPLICA_LIVE
            self._restart_at[i] = None
        b.start()
        self._count("serving_replica_restarts_total",
                    {"replica": self._rname(i)},
                    help="supervisor-initiated replica restarts")
        self.tracer.record_span(
            "supervisor.restart", t0, time.monotonic(),
            attrs={"replica": self._rname(i),
                   "restarts": self.restarts[i]})
        self.tracer.decision("restart", replica=self._rname(i))
        self._publish_state()
        log.info("%s: restarted (attempt %d)", self._rname(i),
                 self.restarts[i])
        # The recovery snapshot: by restart time the ring holds the
        # WHOLE chain (fault → detect → seize → requeue → restart) —
        # the wedge-time snapshot necessarily ends at the seize.
        self._flight_snapshot("restart", replica=i)

    def _flight_snapshot(self, reason: str, replica: int) -> None:
        rec = self.flight_recorder
        if rec is None:
            return
        try:
            rec.snapshot(reason,
                         extra={"replica": self._rname(replica),
                                "states": self.states()})
        except Exception:
            # The recorder is evidence, not a dependency: a snapshot
            # failure must never take down the healing plane.
            log.exception("flight recorder snapshot (%s) failed",
                          reason)

    def quiesce(self, timeout: float = 30.0,
                poll_s: float = 0.02) -> bool:
        """Wait until queue, pop-to-slot hand-off, supervisor
        seize-to-requeue hand-off AND every batcher are empty (drain
        path: the queue has already stopped admitting, so empty is
        stable). inflight() covers the window where a request is
        popped but not yet in a slot; _seizing covers the one where a
        failed replica's requests are seized but not yet re-admitted —
        without either, a drain stop() could land exactly there and
        fail an admitted request."""

        def idle() -> bool:
            with self._plock:
                seizing = self._seizing
            return (seizing == 0 and self.queue.depth() == 0
                    and self.queue.inflight() == 0
                    and self.active() == 0)

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if idle():
                return True
            time.sleep(poll_s)
        return idle()
