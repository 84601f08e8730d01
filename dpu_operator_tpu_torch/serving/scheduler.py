"""Continuous batching: admit/retire at STEP boundaries, not batch ones.

The classic serving mistake is static batching — collect B requests,
run all their tokens, return, repeat — which makes every request wait
for the slowest member of its batch and leaves slots idle as members
finish early. Continuous batching (Orca, OSDI '22) re-forms the batch
every model step: a request occupies one SLOT, each step decodes one
token for every occupied slot, finished requests free their slot at
the step boundary and queued requests are admitted into free slots
before the next step. Occupancy tracks offered load step by step;
nobody waits for a stranger's tail.

The executor's batch shape is FIXED at [slots, d] (idle slots carry
zeros) so the jitted forward compiles once — occupancy varies, shapes
don't. One batcher per replica, one thread per batcher; the shared
AdmissionQueue is the only cross-replica coupling.

Two loop shapes (picked off `executor.pipelined`):

  * sync — the original loop: step(x) blocks, then retire/admit run while
    the device idles. Kept as the fallback for step()-only executors
    and as the measured baseline.
  * pipelined — the overlapped loop: submit step k (async dispatch), THEN
    retire step k-1's tokens and admit for step k+1 while the device
    runs k. Host bookkeeping hides behind device time; the device
    never waits for python. The semantic delta, by construction: a
    slot freed by step k-1's retire is admitted at step k+1, one step
    later than the sync loop would (submit(k) precedes retire(k-1)),
    and each slot hand-off decodes one stale step nobody reads. Token
    STREAMS are identical to the sync loop — rows decode
    independently, so a later admission shifts when tokens are
    computed, never what they are.

Step-time decomposition (per replica, both loops):
`serving_step_device_seconds` is time blocked on the device (sync:
step() wall; pipelined: collect() wall — the device time host work
did NOT hide); `serving_host_gap_seconds` is host bookkeeping between
observing one step's completion and dispatching the next — the window
the device sits idle in the sync loop, and the budget that must stay
under device step time for full overlap in the pipelined loop.
`serving_step_seconds` keeps its original series as the blocked-time
back-compat alias.

Failure policy is two-mode. Standalone batchers keep the legacy shape
(an executor failure 500s the current occupants and the loop keeps
running). Under a supervising ReplicaPool the batcher is CRASH-ONLY:
the failure exits the loop with the occupants left in their slots and
the supervisor seizes them (under this batcher's settle lock, so
nothing is ever settled twice), re-admits them to the shared queue and
restarts the replica. `blocked_since` is the watchdog hook: published
while the thread is blocked on the device, it lets the supervisor
detect a wedged step no in-thread timeout could ever fire on.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from ..obs import logging as obs_logging
from ..obs import trace as obs_trace
from .api import KV_OOM_ERROR, GenerateRequest
from .kvcache.allocator import KVCacheOOM
from .spec import token_run

log = logging.getLogger(__name__)

# Decode loops run 10^2..10^4 steps/s; the default request-latency
# buckets start two decades too high to resolve them.
_STEP_BUCKETS = (0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                 0.05, 0.1, 0.25, 1.0)
_OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)


class ContinuousBatcher:
    def __init__(self, executor, queue, registry=None,
                 replica: str = "replica0", idle_wait_s: float = 0.05,
                 pipelined: Optional[bool] = None,
                 crash_only: bool = False, tracer=None,
                 handoff=None):
        self.executor = executor
        self.queue = queue
        self.registry = registry
        self.tracer = (tracer if tracer is not None
                       else obs_trace.get_tracer())
        self.replica = replica
        self.idle_wait_s = idle_wait_s
        self.pipelined = (bool(executor.pipelined) if pipelined is None
                          else bool(pipelined))
        # Paged-KV executors (serving/kvcache) speak tokens, not
        # [slots, d] rows: admission binds a block-table lease and the
        # loop is _run_kv (chunked prefill + NO_TOKEN-aware retire).
        self.kv_mode = bool(getattr(executor, "kv", False))
        if (getattr(executor, "speculative", False) and self.pipelined
                and not bool(executor.pipelined)):
            # Speculation rides BOTH loop shapes, but
            # the plan-ahead discipline (draft from proposed tokens,
            # epoch-gated rollback) lives in the EXECUTOR — it must
            # have been built pipelined. Overriding a sync-built
            # speculative executor into the pipelined loop would plan
            # verify windows from stale last_token cursors (collect
            # has not run yet) and silently fork the stream.
            raise ValueError(
                "speculative executor was built for the sync loop "
                "shape; pipelined=True override is invalid (build it "
                "with pipelined speculation instead)")
        # Role hand-off (serving/disagg): when set, this batcher is a
        # PREFILL replica — a request that emits a token and is not
        # finished leaves its slot through kv_detach_slot and
        # handoff(req, detach) instead of decoding here. Called UNDER
        # the settle lock, so it must only enqueue (the transfer
        # plane's worker does the export/stream off-thread). KV-only:
        # the row plane has no transferable state.
        if handoff is not None and not self.kv_mode:
            raise ValueError("handoff requires a paged-KV executor")
        self.handoff = handoff
        # crash_only (Candea & Fox): an executor failure EXITS the loop
        # with the occupants left in their slots and the error on
        # self.failure — the supervisor (ReplicaPool) seizes, requeues
        # and restarts. Standalone batchers keep the legacy policy
        # (fail the current occupants, keep looping).
        self.crash_only = crash_only
        self.failure: Optional[BaseException] = None
        # monotonic timestamp published while the thread is blocked on
        # the device (step()/collect()) — the supervisor's watchdog
        # reads it to catch a wedged device step the loop itself can
        # never time out of.
        self.blocked_since: Optional[float] = None
        # Serializes settle/pop bookkeeping against a supervisor
        # seize(): once _abandoned flips under this lock, the loop will
        # never settle a request or pop the queue again — the no-
        # double-settle guarantee re-admission depends on.
        self._settle_lock = threading.Lock()
        self._abandoned = False
        self._slots: List[Optional[GenerateRequest]] = (
            [None] * executor.slots)
        self._x = np.zeros((executor.slots, executor.d), np.float32)
        self._zero_row = np.zeros(executor.d, np.float32)
        self._dirty: set = set()  # freed slots with stale device rows
        self._prezeroed: set = set()  # zeroed ahead of their retire
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.steps = 0

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"batcher-{self.replica}")
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        # Under the settle lock with _abandoned flipped: a thread that
        # outlived the join timeout (wedged in the executor) must not
        # settle anything after we fail its occupants here.
        with self._settle_lock:
            self._abandoned = True
            for i, req in enumerate(self._slots):
                if req is not None:
                    req.fail("server stopped")
                    self._slots[i] = None

    @property
    def thread_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def stopping(self) -> bool:
        return self._stop.is_set()

    def seize(self) -> List[GenerateRequest]:
        """Supervisor-side takeover of a dead or wedged replica's
        in-flight requests. Taking the settle lock first means an
        in-progress retire completes before ownership moves; after
        _abandoned flips, the batcher thread (should it ever wake from
        a wedge) exits without settling or popping anything — each
        seized request has exactly one owner: the caller."""
        self._stop.set()
        got = self._settle_lock.acquire(timeout=5.0)
        try:
            self._abandoned = True
            occ = [r for r in self._slots if r is not None]
            self._slots = [None] * len(self._slots)
            return occ
        finally:
            if got:
                self._settle_lock.release()

    @property
    def active(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    # -- metrics helpers ------------------------------------------------------

    def _observe(self, name: str, value: float, help: str = "",
                 buckets=None) -> None:
        if self.registry is not None:
            self.registry.observe(name, value, {"replica": self.replica},
                                  help=help, buckets=buckets)

    def _count(self, name: str, labels: dict, help: str = "",
               by: float = 1.0) -> None:
        if self.registry is not None:
            self.registry.counter_inc(name, labels, by=by, help=help)

    def _observe_step(self, blocked_s: float, n_active: int) -> None:
        self._observe("serving_step_device_seconds", blocked_s,
                      help="wall time blocked on the device per step "
                           "(device time not hidden by host work)",
                      buckets=_STEP_BUCKETS)
        self._observe("serving_step_seconds", blocked_s,
                      help="model step wall time")
        self._observe("serving_batch_occupancy",
                      n_active / self.executor.slots,
                      help="occupied fraction of batch slots",
                      buckets=_OCCUPANCY_BUCKETS)

    def _observe_gap(self, gap_s: float) -> None:
        self._observe("serving_host_gap_seconds", gap_s,
                      help="host bookkeeping between observing a step's "
                           "completion and dispatching the next",
                      buckets=_STEP_BUCKETS)

    # -- admission ------------------------------------------------------------

    def _pop_admissions(self, block: bool
                        ) -> List[Tuple[int, GenerateRequest,
                                        np.ndarray]]:
        """Pop up to len(free slots) requests and place each in a slot;
        returns [(slot, request, prompt_row)] for successful
        placements. The slot index binds BEFORE the guarded region: a
        failure inside it must report the real error against a known
        slot (the old `i = free.pop(0)` inside the try raised
        NameError('i') in its own handler, masking the actual failure
        and leaking the queue's inflight count)."""
        free = [i for i, r in enumerate(self._slots) if r is None]
        if not free:
            return []
        # Block only when fully idle: a running batch polls (timeout 0)
        # so decode steps are never held hostage to admission.
        timeout = self.idle_wait_s if block else 0.0
        placed: List[Tuple[int, GenerateRequest, np.ndarray]] = []
        for req in self.queue.get_many(len(free), timeout=timeout):
            i = free.pop(0)
            try:
                kv_cached = None
                if self.kv_mode:
                    # Bind (or re-attach) the request's KV lease: the
                    # executor reserves its worst-case pages here, so
                    # OOM is an admission decision, never a mid-decode
                    # failure.
                    vec = None
                    kv_cached = self.executor.kv_attach(i, req)
                else:
                    vec = np.asarray(req.prompt_vec, np.float32)
                    if vec.shape != (self.executor.d,):
                        raise ValueError(
                            f"prompt_vec shape {vec.shape} != "
                            f"({self.executor.d},)")
                req.admitted_at = time.monotonic()
                self._slots[i] = req
                placed.append((i, req, vec))
                if self.tracer.enabled:
                    # `lands_at_step` is the step whose scatter applies
                    # the row — in the pipelined loop that is by
                    # construction one step after the retire that freed
                    # the slot (the pipelined hand-off, visible in the
                    # trace instead of only in a docstring).
                    attrs = {"replica": self.replica, "slot": i,
                             "lands_at_step": self.steps + 1,
                             "pipelined": self.pipelined}
                    if kv_cached is not None:
                        attrs["kv_cached_tokens"] = kv_cached
                    self.tracer.event(
                        "batcher.admit", request_id=req.request_id,
                        parent_id=req.trace_parent, attrs=attrs)
                    self.tracer.decision(
                        "admit", request_id=req.request_id,
                        replica=self.replica, slot=i)
            except KVCacheOOM as e:
                # Capacity shed, not a replica failure: pages free as
                # in-flight work finishes, so the HTTP layer answers
                # 503 + Retry-After (KV_OOM_ERROR matched exactly).
                log.warning("batcher %s: kv admission shed "
                            "(request %s): %s", self.replica,
                            req.request_id, e)
                req.fail(KV_OOM_ERROR)
                self._count("serving_kv_admission_shed_total",
                            {"replica": self.replica},
                            help="requests shed at admission because "
                                 "the KV allocator had no pages")
                self.tracer.decision("shed_kv_oom",
                                     request_id=req.request_id,
                                     replica=self.replica)
            except Exception as e:
                # A request popped from the queue has exactly one owner
                # now — losing it here would park its handler thread
                # for the full deadline.
                log.exception("batcher %s: admit failed (request %s)",
                              self.replica, req.request_id)
                if self._slots[i] is req:
                    self._slots[i] = None
                if self.kv_mode:
                    # kv_attach may have bound the slot before a later
                    # admit statement raised; leaving it bound poisons
                    # the slot ("already bound" for every future admit)
                    # and keeps planning decode for a ghost state.
                    # No-op when nothing is bound; lease release is
                    # idempotent against fail()'s finish hook.
                    self.executor.kv_release_slot(i, cache=False)
                req.fail(f"admission failed: {e}")
            finally:
                # In a slot (or failed) — no longer "in flight between
                # queue and slot" for the drain quiesce accounting.
                self.queue.mark_placed(1)
        return placed

    def _maybe_preempt_kv(self) -> None:
        """QoS preemption, called under the settle lock
        right before admissions: when every slot is occupied and an
        INTERACTIVE request is waiting, park the coldest batch-class
        occupant (fewest settled tokens — the least work at stake)
        through ``kv_preempt_slot`` and requeue it at the front of its
        own class. Preemption is policy, not failure: the victim's
        ``attempts`` budget is untouched, its ``preemptions`` counter
        ticks, and its KV rides the requeue as a ParkedKV (or a
        reattached lease when nothing was parkable), so resume replays
        strictly less than a re-decode. One victim per loop iteration —
        the freed slot admits in the SAME _pop_admissions call, and the
        next iteration re-evaluates with fresh queue state."""
        if not self.kv_mode:
            return
        waiting = getattr(self.queue, "waiting", None)
        if waiting is None or waiting("interactive") <= 0:
            return
        if any(r is None for r in self._slots):
            return
        victims = [(len(r.tokens), i, r)
                   for i, r in enumerate(self._slots)
                   if r is not None and not r.done
                   and getattr(r, "priority", "interactive") == "batch"]
        if not victims:
            return
        _, i, victim = min(victims, key=lambda v: (v[0], v[1]))
        try:
            res = self.executor.kv_preempt_slot(i, victim)
        except Exception:
            if self.crash_only:
                raise
            # Park failed (tier fault): the victim is still BOUND and
            # still decoding — skip preemption this round rather than
            # turning a QoS decision into a request failure.
            log.exception("batcher %s: preempt park failed "
                          "(request %s)", self.replica,
                          victim.request_id)
            return
        self._slots[i] = None
        if res is None:
            # Settled concurrently: the slot freed through the choke
            # point, nothing to requeue.
            return
        victim.preemptions += 1
        self._count("serving_preempted_total",
                    {"replica": self.replica},
                    help="batch-class occupants preempted for an "
                         "interactive arrival (KV parked, requeued)")
        self.tracer.event(
            "batcher.preempt", request_id=victim.request_id,
            parent_id=victim.trace_parent,
            attrs={"replica": self.replica, "slot": i,
                   "tokens": len(victim.tokens),
                   "parked_blocks": res.get("parked_blocks", 0),
                   "preemptions": victim.preemptions})
        self.tracer.decision("preempt", request_id=victim.request_id,
                             replica=self.replica, slot=i)
        self.queue.requeue(victim, preempted=True)

    # -- sync loop (fallback + measured baseline) -----------------------------

    def _settle(self, req: GenerateRequest, token: int,
                now: float) -> bool:
        """Append one decoded token and finish the request if its
        budget or deadline says so; True when it leaves its slot. THE
        retire bookkeeping, shared by both loops — sync and pipelined
        request outcomes must never diverge (the token-stream
        equivalence contract)."""
        req.tokens.append(int(token))
        if req.first_token_at is None:
            req.first_token_at = now
        finished = len(req.tokens) >= req.max_tokens
        if not finished and now >= req.deadline:
            # Deadline mid-decode: return what exists, marked, at the
            # boundary — p99 for admitted work stays bounded by
            # deadline + one step, never by another request's tail.
            req.truncated = True
            finished = True
        if finished:
            self._count("serving_tokens_total",
                        {"replica": self.replica},
                        by=float(len(req.tokens)),
                        help="decoded tokens")
            req.finish()
            self.tracer.event(
                "batcher.retire", request_id=req.request_id,
                parent_id=req.trace_parent,
                attrs={"replica": self.replica,
                       "tokens": len(req.tokens),
                       "truncated": req.truncated})
        return finished

    def _admit(self) -> None:
        for i, _req, vec in self._pop_admissions(block=self.active == 0):
            self._x[i] = vec

    def _retire(self, y: np.ndarray, tokens: np.ndarray) -> None:
        """Step-boundary bookkeeping. `tokens` is ONE batched argmax
        over all slots (the per-row np.argmax python loop costs real
        time at decode step rates)."""
        now = time.monotonic()
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            if req.done:
                # Abandoned by the handler (wait timeout → 500): evict
                # rather than decode to max_tokens for nobody — zombie
                # slots are capacity loss exactly when capacity is short.
                self._slots[i] = None
                self._x[i] = 0.0
                continue
            if self._settle(req, tokens[i], now):
                self._slots[i] = None
                self._x[i] = 0.0
            else:
                self._x[i] = y[i]  # decode recurrence: output is next state

    def _run_sync(self) -> None:
        if self.crash_only:
            # A restarted replica must not inherit poisoned state from
            # the incarnation the supervisor just tore down. Under the
            # watchdog clock: a reset that serializes behind a still-
            # hung device step would otherwise block HERE invisibly,
            # recreating the exact wedge the supervisor just detected
            # while reporting the replica live.
            self.blocked_since = time.monotonic()
            self.executor.reset()
            self.blocked_since = None
        t_gap_start = None
        while not self._stop.is_set():
            # crash_only: any failure exits the loop with the slots
            # intact — the supervisor requeues and restarts. Legacy
            # (standalone) policy: the failure costs at most the
            # CURRENT occupants, never the thread.
            try:
                with self._settle_lock:
                    if self._abandoned:
                        return
                    if self.active == 0:
                        # Drained before the (possibly blocking) admit:
                        # queue-idle wait must not masquerade as host
                        # gap.
                        t_gap_start = None
                    self._admit()
                    n_active = self.active
                if n_active == 0:
                    t_gap_start = None
                    continue
                # One clock (time.monotonic) for metrics AND spans so
                # the step segments share the axis every other span —
                # and the fault plan's fired_at — lives on.
                traced = self.tracer.enabled
                rids = ([r.request_id for r in self._slots
                         if r is not None] if traced else None)
                t0 = time.monotonic()
                if t_gap_start is not None:
                    self._observe_gap(t0 - t_gap_start)
                    if traced:
                        self.tracer.record_span(
                            "step.host", t_gap_start, t0,
                            attrs={"replica": self.replica,
                                   "step": self.steps + 1,
                                   "mode": "sync",
                                   "request_ids": rids})
                self.blocked_since = t0
                y = np.asarray(self.executor.step(self._x), np.float32)
                self.blocked_since = None
                t1 = time.monotonic()
                t_gap_start = t1
                self.steps += 1
                self._observe_step(t1 - t0, n_active)
                if traced:
                    self.tracer.record_span(
                        "step.device", t0, t1,
                        attrs={"replica": self.replica,
                               "step": self.steps, "mode": "sync",
                               "n_active": n_active,
                               "request_ids": rids})
                with self._settle_lock:
                    if self._abandoned:
                        return
                    self._retire(y, y.argmax(axis=1))
            except Exception as e:
                self.blocked_since = None
                if self.crash_only:
                    raise
                log.exception("batcher %s: step failed", self.replica)
                self._fail_occupants(e)
                t_gap_start = None

    # -- pipelined loop (device-resident executors) ---------------------------

    def _retire_tokens(self, tokens: np.ndarray,
                       snapshot: List[Optional[GenerateRequest]]) -> None:
        """Retire against the slot SNAPSHOT taken at that step's
        submit: by retire time self._slots may already hold newer
        occupants (admissions run before collect). Freed slots join
        _dirty — their device rows are stale until the next submit
        zeroes them (or an admission overwrites them)."""
        now = time.monotonic()
        for i, req in enumerate(snapshot):
            if req is None:
                continue
            if req.done:
                # Finished or abandoned at an earlier boundary; this
                # step ran its slot for nobody (the one-step pipeline
                # cost). Free the slot only if still ours.
                if self._slots[i] is req:
                    self._free_slot(i)
                continue
            if self._settle(req, tokens[i], now) and self._slots[i] is req:
                self._free_slot(i)

    def _free_slot(self, i: int) -> None:
        """Release slot i at retire. Rows zeroed AHEAD of their retire
        (in the submit that overlapped it) are already clean on device;
        everything else carries stale state until the next scatter."""
        self._slots[i] = None
        if i in self._prezeroed:
            self._prezeroed.discard(i)
        else:
            self._dirty.add(i)

    def _zero_ahead(self, updates: list, snap_prev) -> None:
        """Zero rows whose occupant is certain to leave at the PENDING
        retire, in the scatter of the step being submitted. Without
        this, the hand-off step would run the finished request's stale
        nonzero row: content-derived row masking (infer.py's
        `any(x != 0)`) would count it active, and on an ep-sharded mesh
        under capacity pressure a ghost competitor can evict a real
        row's MoE dispatch — a divergence the sync loop never exhibits.
        Completion is predictable exactly for the max_tokens path
        (len + the pending token >= budget) and for already-abandoned
        requests; deadline truncation is timing-dependent and keeps its
        one stale step."""
        for i, req in enumerate(self._slots):
            if (req is not None and snap_prev[i] is req
                    and (req.done
                         or len(req.tokens) + 1 >= req.max_tokens)):
                updates.append((i, self._zero_row))
                self._prezeroed.add(i)

    def _run_pipelined(self) -> None:
        ex = self.executor
        # Under the watchdog clock (see _run_sync): on a restart after
        # a WEDGE, this reset can serialize behind the still-hung step
        # on the device/worker — blocked_since keeps the supervisor's
        # deadline on it, so a reset that never returns parks the
        # replica through the breaker instead of wedging it invisibly
        # in a state the pool reports as live.
        self.blocked_since = time.monotonic()
        ex.reset()
        self.blocked_since = None
        self._dirty.clear()
        self._prezeroed.clear()
        # (handle, slot snapshot, step no, occupant rids) in flight.
        # The rids list is computed ONCE per submitted step and shared
        # by every span that names the step's occupants — the tracing
        # budget is a handful of µs/step and list comprehensions over
        # the slots are the first thing to amortize.
        prev = None
        t_gap_start = None
        while not self._stop.is_set():
            try:
                submitted = None
                snapshot = None
                admit_rids: List[str] = []
                # Admission bookkeeping runs under the settle lock: a
                # supervisor seize() serializes against it, so an
                # abandoned batcher can never pop the queue again.
                with self._settle_lock:
                    if self._abandoned:
                        return
                    # Admit for step k+1 (block only when nothing is
                    # active AND nothing is in flight — a pending
                    # collect must not wait out the idle timeout behind
                    # an empty queue).
                    block = self.active == 0 and prev is None
                    updates = []
                    for i, req, vec in self._pop_admissions(block=block):
                        # Admission overwrites the row, whatever its
                        # state.
                        self._dirty.discard(i)
                        self._prezeroed.discard(i)
                        updates.append((i, vec))
                        admit_rids.append(req.request_id)
                    if self.active > 0:
                        # Freed-but-unadmitted slots get explicit zero
                        # rows: idle slots must be EXACTLY zero (the MoE
                        # row-mask contract) and must not keep decoding
                        # garbage.
                        for i in sorted(self._dirty):
                            updates.append((i, self._zero_row))
                        self._dirty.clear()
                        if prev is not None:
                            self._zero_ahead(updates, prev[1])
                        snapshot = list(self._slots)
                if snapshot is not None:
                    # Dispatch OUTSIDE the settle lock, under the
                    # watchdog clock: a submit that blocks (a wedged
                    # device can stall dispatch, not just completion)
                    # must be seizable — held across the lock it would
                    # deadlock stop()/seize() AND hide from the
                    # watchdog. A seize landing between the lock and
                    # this dispatch only wastes one step: the retire
                    # path re-checks _abandoned before settling.
                    traced = self.tracer.enabled
                    cur_rids = ([r.request_id for r in snapshot
                                 if r is not None] if traced else None)
                    ts0 = time.monotonic()
                    if t_gap_start is not None:
                        self._observe_gap(ts0 - t_gap_start)
                        if traced:
                            self.tracer.record_span(
                                "step.host", t_gap_start, ts0,
                                attrs={"replica": self.replica,
                                       "step": self.steps + 1,
                                       "mode": "pipelined",
                                       "request_ids": cur_rids})
                    self.blocked_since = ts0
                    # step/request_ids are diagnostic context: an
                    # update-overflow ValueError out of the device
                    # step must name the step and the admitting
                    # requests (the seize path can race admissions
                    # close to the slot limit).
                    # occupants is trace-only context: a sharded
                    # executor stamps it on its shard.step span so
                    # the worker-side subtree links into every
                    # occupant's /debug/traces tree.
                    handle = ex.submit(updates, step=self.steps + 1,
                                       request_ids=admit_rids or None,
                                       occupants=cur_rids)
                    self.blocked_since = None
                    self.steps += 1
                    if traced:
                        # `admits_landing` marks the pipelined hand-off:
                        # these rows were freed at step k-1's retire
                        # and land in step k+1's scatter — one step
                        # later than the sync loop, by construction.
                        self.tracer.record_span(
                            "executor.submit", ts0, time.monotonic(),
                            attrs={"replica": self.replica,
                                   "step": self.steps,
                                   "n_updates": len(updates),
                                   "admits_landing": admit_rids or None,
                                   "request_ids": cur_rids})
                    submitted = (handle, snapshot, self.steps, cur_rids)
                # Step k runs on the device while the host settles step
                # k-1: collect its token ids and do retire bookkeeping.
                # collect() is the one place a wedged device parks this
                # thread forever, so it runs OUTSIDE the settle lock
                # with blocked_since published — the supervisor's
                # watchdog can both see the wedge and seize around it.
                if prev is not None:
                    h_prev, snap_prev, step_prev, prev_rids = prev
                    tc = time.monotonic()
                    self.blocked_since = tc
                    tokens = ex.collect(h_prev)
                    self.blocked_since = None
                    t_done = time.monotonic()
                    n_prev = sum(1 for r in snap_prev if r is not None)
                    self._observe_step(t_done - tc, n_prev)
                    if self.tracer.enabled and prev_rids is not None:
                        dev = self.tracer.record_span(
                            "step.device", tc, t_done,
                            attrs={"replica": self.replica,
                                   "step": step_prev,
                                   "mode": "pipelined",
                                   "n_active": n_prev,
                                   "request_ids": prev_rids})
                        self.tracer.record_span(
                            "executor.collect", tc, t_done,
                            parent_id=dev,
                            attrs={"replica": self.replica,
                                   "step": step_prev,
                                   "request_ids": prev_rids})
                    with self._settle_lock:
                        if self._abandoned:
                            return
                        self._retire_tokens(tokens, snap_prev)
                    # Gap clock starts at device completion so retire
                    # bookkeeping counts toward the host gap it is.
                    t_gap_start = t_done
                if submitted is None:
                    t_gap_start = None  # pipeline drained: idle queue
                    # waits must not masquerade as host gap
                prev = submitted
            except Exception as e:
                self.blocked_since = None
                if self.crash_only:
                    raise
                log.exception("batcher %s: step failed", self.replica)
                self._fail_occupants(e)
                prev = None
                self._dirty.clear()
                self._prezeroed.clear()
                t_gap_start = None
                try:
                    ex.reset()  # drop poisoned device state
                except Exception:
                    log.exception("batcher %s: executor reset failed",
                                  self.replica)
        self._drain_stopped(prev)

    def _drain_stopped(self, prev) -> None:
        """Collect the step a pipelined loop left in flight when it
        stopped. A stop() that lands between a step's retire and the
        loop's next check ends the loop with the step submitted after
        that retire uncollected, so the executor's ledger (a shard
        set's ``outstanding()``) would hold it until close. Its tokens
        settle nothing: stop() fails whatever still occupies a slot.
        Skipped once a seize owns the slots (the supervisor resets the
        executor itself)."""
        if prev is None or self._abandoned:
            return
        try:
            self.executor.collect(prev[0])
        except Exception:
            log.exception("batcher %s: collecting the step in flight "
                          "at stop failed", self.replica)

    # -- paged-KV loop (token-level executors) ------------------------

    def _retire_kv(self, tokens, snapshot) -> None:
        """KV-aware retire against the submit-time snapshot. NO_TOKEN
        (-1) marks a slot whose step emitted nothing — a mid-prefill
        chunk (the request stays, its prompt still filling under the
        chunk budget) or a stale post-seize handle. A speculative
        executor's collect returns [slots, chunk] ACCEPTED RUNS
        instead of [slots] single tokens; both shapes
        normalize through spec.token_run and the per-request checks
        move to PER-ACCEPTED-TOKEN — a slot may finish mid-run
        (max_tokens reached, or the deadline lapsed after an earlier
        token of the same run), and tokens past that point are
        dropped exactly as an unspeculated run would never have
        decoded them. Emitted tokens settle like the row plane,
        except the lease is released-AND-cached before finish() so
        the settle hook no-ops and the prompt's full blocks enter the
        prefix tree while the owner refs still hold them."""
        ex = self.executor
        now = time.monotonic()
        for i, req in enumerate(snapshot):
            if req is None or self._slots[i] is not req:
                continue
            if req.done:
                # Abandoned by the handler (wait timeout → 500): the
                # finish hook already released the lease, so no cache
                # insert — just evict the zombie slot.
                ex.kv_release_slot(i, cache=False)
                self._slots[i] = None
                continue
            # ONE extraction for both collect shapes (a 1-D entry is
            # a run of length <= 1) — the hoisted idiom, literally.
            run = token_run(tokens[i])
            emitted = bool(run)
            if emitted and req.first_token_at is None:
                req.first_token_at = now
            finished = False
            for t in run:
                req.tokens.append(t)
                if len(req.tokens) >= req.max_tokens:
                    finished = True
                    break
                if now >= req.deadline:
                    # Deadline mid-run: keep what settled, drop the
                    # accepted tail.
                    req.truncated = True
                    finished = True
                    break
            if not finished and now >= req.deadline:
                # Deadline mid-decode OR mid-prefill: return whatever
                # exists, marked truncated, at the step boundary —
                # the bounded-p99 contract extended to prompts
                # still prefilling (possibly zero tokens).
                req.truncated = True
                finished = True
            if not finished and emitted and self.handoff is not None:
                # Prefill replica: the emit means prefill completed
                # (the step that processes the last prompt token emits
                # the first decode token), so the request's KV is
                # built and its decode regime belongs elsewhere.
                # Detach the lease (pages stay owned — a failed
                # transfer resumes here) and hand ownership to the
                # transfer plane. A retry that re-attached here first
                # re-decodes exactly one token and hands off again —
                # the stream stays byte-identical either way.
                detach = ex.kv_detach_slot(i)
                if detach is None:
                    # Settled concurrently by the handler thread (the
                    # finish choke point released the lease between
                    # the done-check above and the detach): pages
                    # already returned, nothing to hand off — just
                    # free the slot, like the req.done branch.
                    self._slots[i] = None
                    continue
                self.tracer.event(
                    "disagg.handoff", request_id=req.request_id,
                    parent_id=req.trace_parent,
                    attrs={"replica": self.replica,
                           "tokens": len(req.tokens),
                           "confirmed": detach["confirmed"]})
                self.tracer.decision("handoff",
                                     request_id=req.request_id,
                                     replica=self.replica)
                # Hand off BEFORE emptying the slot: the transfer
                # plane's _transferring counter must cover the request
                # before active() stops counting it, or a quiesce poll
                # landing in the gap reads the pool as drained around
                # a live hand-off (the supervisor's _seizing
                # discipline: flip the accounting flag first).
                self.handoff(req, detach)
                self._slots[i] = None
                continue
            if finished:
                ex.kv_release_slot(i, cache=True)
                self._count("serving_tokens_total",
                            {"replica": self.replica},
                            by=float(len(req.tokens)),
                            help="decoded tokens")
                req.finish()
                self.tracer.event(
                    "batcher.retire", request_id=req.request_id,
                    parent_id=req.trace_parent,
                    attrs={"replica": self.replica,
                           "tokens": len(req.tokens),
                           "truncated": req.truncated, "kv": True})
                self._slots[i] = None

    def _collect_retire_kv(self, submitted) -> Optional[float]:
        """Collect one in-flight KV step and settle it; returns the
        device-done timestamp (the gap clock's start), or None when a
        supervisor seize landed — the loop must exit without touching
        anything further."""
        handle, snap, step_no, rids = submitted
        ex = self.executor
        tc = time.monotonic()
        self.blocked_since = tc
        tokens = ex.collect(handle)
        self.blocked_since = None
        t_done = time.monotonic()
        n_active = sum(1 for r in snap if r is not None)
        self._observe_step(t_done - tc, n_active)
        if self.tracer.enabled and rids is not None:
            dev = self.tracer.record_span(
                "step.device", tc, t_done,
                attrs={"replica": self.replica, "step": step_no,
                       "mode": "kv", "n_active": n_active,
                       "request_ids": rids})
            self.tracer.record_span(
                "executor.collect", tc, t_done, parent_id=dev,
                attrs={"replica": self.replica, "step": step_no,
                       "request_ids": rids})
        with self._settle_lock:
            if self._abandoned:
                return None
            self._retire_kv(tokens, snap)
        return t_done

    def _run_kv(self) -> None:
        """Token-level loop over a paged-KV executor. Same skeleton
        and seize/watchdog contracts as _run_pipelined — admissions
        and settling under the settle lock, dispatch and collect
        outside it with blocked_since published — but the step payload
        is the EXECUTOR's chunked-prefill/decode plan (no row
        scatter), admission binds a KV lease, and retire understands
        NO_TOKEN. `pipelined` picks the shape: True settles step k-1
        while step k runs on the device (the decode recurrence chains
        on device, so dispatch needs no host token); False collects
        every step before the next dispatch — the measured baseline.
        Speculative executors ride EITHER shape with no loop branch
        here (collect just returns runs): sync drafts from the
        previous step's accepted tokens; pipelined drafts
        window w+1 from window w's PROPOSED tokens inside the
        executor's plan, with epoch-gated rollback on
        mis-speculation. Token STREAMS are identical either way:
        rows decode independently and the plan depends only on
        committed cursors (the pipelining equivalence argument, carried
        to tokens — extended to speculation by the exact greedy
        prefix-match acceptance).

        The `gen` captured under the settle lock makes the
        documented dispatch-outside-the-lock window safe on the KV
        plane: a submit raced by a seize→reset lands with a stale
        generation and becomes a no-op handle instead of advancing
        the restarted session's cursors."""
        ex = self.executor
        self.blocked_since = time.monotonic()
        ex.reset()
        self.blocked_since = None
        prev = None  # (handle, slot snapshot, step no, occupant rids)
        t_gap_start = None
        while not self._stop.is_set():
            try:
                submitted = None
                admit_rids: List[str] = []
                with self._settle_lock:
                    if self._abandoned:
                        return
                    self._maybe_preempt_kv()
                    block = self.active == 0 and prev is None
                    for _i, req, _vec in self._pop_admissions(
                            block=block):
                        admit_rids.append(req.request_id)
                    snapshot = (list(self._slots) if self.active > 0
                                else None)
                    gen = ex.kv_gen()
                if snapshot is not None:
                    traced = self.tracer.enabled
                    cur_rids = ([r.request_id for r in snapshot
                                 if r is not None] if traced else None)
                    ts0 = time.monotonic()
                    if t_gap_start is not None:
                        self._observe_gap(ts0 - t_gap_start)
                        if traced:
                            self.tracer.record_span(
                                "step.host", t_gap_start, ts0,
                                attrs={"replica": self.replica,
                                       "step": self.steps + 1,
                                       "mode": "kv",
                                       "request_ids": cur_rids})
                    self.blocked_since = ts0
                    handle = ex.submit((), step=self.steps + 1,
                                       request_ids=admit_rids or None,
                                       gen=gen)
                    self.blocked_since = None
                    self.steps += 1
                    if traced:
                        self.tracer.record_span(
                            "executor.submit", ts0, time.monotonic(),
                            attrs={"replica": self.replica,
                                   "step": self.steps, "mode": "kv",
                                   "admits_landing": admit_rids or None,
                                   "request_ids": cur_rids})
                    submitted = (handle, snapshot, self.steps, cur_rids)
                if not self.pipelined:
                    # Sync shape: settle THIS step before the next
                    # dispatch; nothing ever carries across iterations.
                    if submitted is not None:
                        t_gap_start = self._collect_retire_kv(submitted)
                        if t_gap_start is None:
                            return
                    else:
                        t_gap_start = None
                    continue
                if prev is not None:
                    t_done = self._collect_retire_kv(prev)
                    if t_done is None:
                        return
                    t_gap_start = t_done
                if submitted is None:
                    t_gap_start = None  # pipeline drained: idle queue
                    # waits must not masquerade as host gap
                prev = submitted
            except Exception as e:
                self.blocked_since = None
                if self.crash_only:
                    raise
                log.exception("batcher %s: kv step failed",
                              self.replica)
                self._fail_occupants(e)
                prev = None
                t_gap_start = None
                try:
                    ex.reset()  # unbind poisoned slot states
                except Exception:
                    log.exception("batcher %s: executor reset failed",
                                  self.replica)
        self._drain_stopped(prev)

    def _fail_occupants(self, e: Exception) -> None:
        # Under the settle lock, like every other settle path (GL012):
        # the legacy loops call this bare from their except handlers,
        # and a concurrent stop() — which fails occupants itself —
        # used to interleave with this loop and settle the same
        # request twice (its error overwritten after the handler
        # thread already woke). _abandoned re-checked under the lock:
        # once a stop/seize owns the slots, they are not ours to fail.
        with self._settle_lock:
            if self._abandoned:
                return
            for i, req in enumerate(self._slots):
                if req is not None:
                    req.fail(f"executor failed: {e}")
                    self.tracer.event(
                        "batcher.fail", request_id=req.request_id,
                        parent_id=req.trace_parent,
                        attrs={"replica": self.replica,
                               "error": str(e)[:200]})
                    self._slots[i] = None
                    self._x[i] = 0.0

    def _run(self) -> None:
        try:
            # Every record this thread emits carries its replica (the
            # JSON-lines ContextFilter stamps it) — request ids are
            # bound per call site, the replica once here.
            with obs_logging.context(replica=self.replica):
                if self.kv_mode:
                    self._run_kv()
                elif self.pipelined:
                    self._run_pipelined()
                else:
                    self._run_sync()
        except Exception as e:
            # crash_only loops re-raise here; the recorded failure and
            # the dead thread ARE the signal the supervisor keys on.
            # (A legacy loop only reaches this for a harness bug — the
            # loops themselves absorb executor failures.)
            self.blocked_since = None
            self.failure = e
            log.error("batcher %s: replica failed (%s); awaiting "
                      "supervision", self.replica, e)
