"""Bounded admission queue — the backpressure point of the serving plane.

Overload policy (the Orca/vLLM-era contract): the queue has a hard
depth; past it, submission fails IMMEDIATELY with QueueFull and the
HTTP layer returns 503 + Retry-After. Latency for admitted requests
stays bounded because the excess is rejected at the door instead of
parked — queue depth, not queue time, is the knob. Requests whose
deadline expires while still queued are shed at pop time (they would
only waste batch slots on an answer nobody is waiting for).

Multi-tenant QoS: with a ``tenants=`` budget map installed,
admission and pop both become tenant-aware —

  * **token buckets** — each tenant's submissions spend a seeded
    bucket (``rate`` req/s refill up to ``burst``); an empty bucket
    raises TenantOverBudget (HTTP 429 + Retry-After) so one flooding
    tenant sheds against its OWN budget while everyone else admits
    normally. A tenant's queued depth is additionally capped at its
    weight's share of ``max_depth`` — the queue itself can't be
    monopolized between refills.
  * **priority classes** — two strict classes (api.PRIORITIES):
    every queued ``interactive`` request pops before any ``batch``
    request. Within a class, tenants are served weighted round-robin
    (``weight`` consecutive pops per visit), so equal-weight tenants
    interleave even when one keeps its deque full.

Without ``tenants=`` the queue is byte-for-byte the single-tenant
contract every earlier PR tested: one global depth bound, FIFO within
each priority class (and everything defaults to interactive).

begin_drain() flips the queue to refuse-new mode for SIGTERM drain:
already-queued work still pops and completes; submissions raise
Draining. ``requeue`` — the supervisor's seize path AND the batcher's
preemption park — stays exempt from depth, drain and budgets: the
request was admitted once already, and shedding it now would convert
a fault (or a policy decision) into a client-visible overload answer.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .. import faults
from ..obs import trace as obs_trace
from .api import (DEADLINE_QUEUED_ERROR, PRIORITIES, Draining,
                  GenerateRequest, QueueFull, TenantOverBudget,
                  bounded_tenant_label)


class TenantBudget:
    """One tenant's admission contract: ``rate`` requests/second of
    token-bucket refill up to ``burst`` (None rate = unmetered), and a
    ``weight`` that sets both its round-robin quantum within its
    priority class and its share of the queue's depth bound."""

    __slots__ = ("rate", "burst", "weight")

    def __init__(self, rate: Optional[float] = None,
                 burst: Optional[float] = None, weight: float = 1.0):
        if rate is not None and rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        self.rate = float(rate) if rate is not None else None
        self.burst = (float(burst) if burst is not None
                      else max(1.0, self.rate or 1.0))
        self.weight = float(weight)


class AdmissionQueue:
    def __init__(self, max_depth: int = 64, retry_after_s: float = 1.0,
                 registry=None, tracer=None,
                 tenants: Optional[Dict[str, TenantBudget]] = None,
                 default_budget: Optional[TenantBudget] = None):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self.retry_after_s = retry_after_s
        self._registry = registry
        self.tracer = (tracer if tracer is not None
                       else obs_trace.get_tracer())
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        # priority -> tenant -> deque. Deques are pruned when empty so
        # tenant-name cardinality can't grow the pop scan unboundedly.
        self._qs: Dict[str, Dict[str, deque]] = {p: {}
                                                 for p in PRIORITIES}
        # Per-priority weighted-RR pop state: (tenant, quantum_left).
        self._cursor: Dict[str, Optional[Tuple[str, float]]] = {
            p: None for p in PRIORITIES}
        self._n = 0
        self._n_by_prio: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self._n_by_tenant: Dict[str, int] = {}
        self._tenants = dict(tenants) if tenants else {}
        self._default_budget = default_budget
        # tenant -> [tokens, last_refill] (monotonic clock).
        self._buckets: Dict[str, List[float]] = {}
        self._label_seen: set = set()
        self._draining = False
        self._inflight = 0  # popped by a batcher, not yet in a slot
        self.rejected_full = 0
        self.rejected_draining = 0
        self.rejected_over_budget = 0
        self.shed_expired = 0
        self.requeued = 0
        self.preempted_requeued = 0

    # -- tenant bookkeeping ---------------------------------------------------

    def _budget(self, tenant: str) -> Optional[TenantBudget]:
        got = self._tenants.get(tenant)
        return got if got is not None else self._default_budget

    def _weight(self, tenant: str) -> float:
        b = self._budget(tenant)
        return b.weight if b is not None else 1.0

    def _tenant_depth_cap(self, tenant: str) -> int:
        """This tenant's share of max_depth, by weight — only enforced
        when a tenant budget map is installed (the single-tenant plane
        keeps the one global bound)."""
        if not self._tenants:
            return self.max_depth
        total = sum(b.weight for b in self._tenants.values())
        if self._default_budget is not None:
            total += self._default_budget.weight
        share = self._weight(tenant) / max(1e-9, total)
        return max(1, int(self.max_depth * share))

    def _charge_bucket(self, tenant: str, now: float) -> bool:
        """Spend one token from the tenant's bucket; False = empty.
        Unmetered tenants (no budget / no rate) always pass."""
        b = self._budget(tenant)
        if b is None or b.rate is None:
            return True
        cell = self._buckets.get(tenant)
        if cell is None:
            cell = self._buckets[tenant] = [b.burst, now]
        tokens = min(b.burst, cell[0] + (now - cell[1]) * b.rate)
        cell[1] = now
        if tokens < 1.0:
            cell[0] = tokens
            return False
        cell[0] = tokens - 1.0
        return True

    def _count_shed(self, tenant: str, reason: str) -> None:
        if self._registry is not None:
            label = bounded_tenant_label(tenant, self._label_seen)
            self._registry.counter_inc(
                "serving_queue_shed_total",
                {"tenant": label, "reason": reason},
                help="admission-queue sheds by tenant and reason "
                     "(tenant label bounded at TENANT_LABEL_CAP)")

    def _gauge(self) -> None:
        if self._registry is not None:
            self._registry.gauge_set(
                "serving_queue_depth", float(self._n),
                help="requests waiting for a batch slot")

    # -- enqueue/dequeue core (callers hold self._lock) -----------------------

    def _push_locked(self, req: GenerateRequest, front: bool) -> None:
        prio = req.priority if req.priority in PRIORITIES else "interactive"
        dq = self._qs[prio].get(req.tenant)
        if dq is None:
            dq = self._qs[prio][req.tenant] = deque()
        (dq.appendleft if front else dq.append)(req)
        self._n += 1
        self._n_by_prio[prio] += 1
        self._n_by_tenant[req.tenant] = (
            self._n_by_tenant.get(req.tenant, 0) + 1)

    def _pop_locked(self) -> Optional[GenerateRequest]:
        """Next request by strict priority class, weighted round-robin
        across tenants within the class: the cursor tenant serves up
        to ``weight`` consecutive pops, then the next tenant (sorted
        name order — deterministic) takes over."""
        for prio in PRIORITIES:
            qs = self._qs[prio]
            if not self._n_by_prio[prio]:
                continue
            names = sorted(t for t in qs if qs[t])
            if not names:
                continue
            cur = self._cursor[prio]
            if (cur is None or cur[1] < 1.0 or not qs.get(cur[0])):
                prev = cur[0] if cur is not None else None
                later = [t for t in names
                         if prev is None or t > prev]
                name = (later or names)[0]
                cur = (name, self._weight(name))
            name, left = cur
            req = qs[name].popleft()
            if not qs[name]:
                del qs[name]
            self._cursor[prio] = (name, left - 1.0)
            self._n -= 1
            self._n_by_prio[prio] -= 1
            nt = self._n_by_tenant.get(name, 0) - 1
            if nt <= 0:
                self._n_by_tenant.pop(name, None)
            else:
                self._n_by_tenant[name] = nt
            return req
        return None

    # -- public API -----------------------------------------------------------

    def submit(self, req: GenerateRequest) -> None:
        faults.fire("queue.submit")
        shed_tenant: Optional[Tuple[str, str]] = None
        try:
            with self._lock:
                if self._draining:
                    self.rejected_draining += 1
                    raise Draining("server is draining")
                now = time.monotonic()
                if not self._charge_bucket(req.tenant, now):
                    self.rejected_over_budget += 1
                    shed_tenant = (req.tenant, "over_budget")
                    b = self._budget(req.tenant)
                    raise TenantOverBudget(
                        req.tenant,
                        max(self.retry_after_s,
                            1.0 / b.rate if b and b.rate else 0.0))
                if (self._n >= self.max_depth
                        or (self._n_by_tenant.get(req.tenant, 0)
                            >= self._tenant_depth_cap(req.tenant))):
                    self.rejected_full += 1
                    shed_tenant = (req.tenant, "full")
                    raise QueueFull(self._n, self.retry_after_s)
                req.enqueued_at = now
                self._push_locked(req, front=False)
                depth = self._n
                self._gauge()
                self._nonempty.notify()
        finally:
            # Counter AND trace outside the queue lock (both take
            # their own locks; this one is on the submit hot path).
            if shed_tenant is not None:
                self._count_shed(*shed_tenant)
        self.tracer.event("queue.enqueue", request_id=req.request_id,
                          parent_id=req.trace_parent,
                          attrs={"depth": depth,
                                 "tenant": req.tenant,
                                 "priority": req.priority})

    def get_many(self, n: int, timeout: float = 0.0
                 ) -> List[GenerateRequest]:
        """Pop up to n requests; blocks up to `timeout` only while the
        queue is empty (a busy batcher polls with timeout=0 so decode
        steps never stall on admission). Expired entries settle here:
        a 503-mapped fail — or, when a requeued request already
        carries settled tokens, the truncated-200 mid-decode contract
        (same disposition as the supervisor's _requeue)."""
        out: List[GenerateRequest] = []
        shed: List[Tuple[GenerateRequest, str]] = []
        with self._lock:
            if not self._n and timeout > 0:
                self._nonempty.wait(timeout)
            now = time.monotonic()
            while len(out) < n:
                req = self._pop_locked()
                if req is None:
                    break
                if req.done:
                    # Settled elsewhere while queued (e.g. the HTTP
                    # handler's wedge-timeout 500): drop. Settling
                    # again would mutate truncated/finished_at after
                    # the response was written — the same double-
                    # settle the supervisor's _requeue guards against.
                    continue
                if req.deadline <= now:
                    if req.tokens:
                        # A requeued resumable-lease request keeps its
                        # settled tokens: its deadline
                        # lapsing HERE is the same mid-decode
                        # truncation as lapsing mid-failure in the
                        # supervisor's _requeue — 200 with what was
                        # decoded, never a 503 that discards it.
                        # finish() releases the lease via the settle
                        # choke point (a preemption-parked lease's
                        # pinned tier pages check in the same way).
                        req.truncated = True
                        req.finish()
                        shed.append((req, "deadline_truncated"))
                    else:
                        self.shed_expired += 1
                        req.fail(DEADLINE_QUEUED_ERROR)
                        shed.append((req, "deadline_queued"))
                    continue
                out.append(req)
            # Popped requests are invisible to depth() but not yet in a
            # slot (active). Counting them under the SAME lock as the
            # pop closes the quiesce race: at no instant can a request
            # be in none of depth/inflight/active — drain's "everything
            # finished" check must see it somewhere.
            self._inflight += len(out)
            self._gauge()
        # Trace OUTSIDE the lock: span recording is lock-light but the
        # queue lock is on the submit hot path.
        for req, reason in shed:
            self._count_shed(req.tenant, reason)
        tr = self.tracer
        if tr.enabled:
            for req, reason in shed:
                tr.event("queue.shed", request_id=req.request_id,
                         parent_id=req.trace_parent,
                         attrs={"reason": reason,
                                "tenant": req.tenant})
                tr.decision("shed", request_id=req.request_id)
            for req in out:
                # The wait span covers (re-)enqueue → pop — the
                # "queue" leg of the request's timeline. enqueued_at,
                # not arrival: a requeued request's second wait must
                # not swallow its failed first decode attempt.
                tr.record_span("queue.wait", req.enqueued_at, now,
                               request_id=req.request_id,
                               parent_id=req.trace_parent)
        return out

    def requeue(self, req: GenerateRequest,
                preempted: bool = False) -> None:
        """Re-admission of an already-admitted request: the
        supervisor's seize path, and — with ``preempted=True`` — the
        batcher's KV-preemption park. Front of its OWN priority class
        (it already waited its turn once; a parked batch request must
        still never overtake queued interactive work) and EXEMPT from
        the depth bound, the drain refusal and the tenant budgets: the
        request was admitted before the failure/park, so shedding it
        now would convert a replica fault — or a scheduling decision —
        into a client-visible overload answer even while capacity
        exists. Never touches ``attempts``: that budget counts replica
        faults survived, and preemption is policy, not failure."""
        with self._lock:
            req.enqueued_at = time.monotonic()
            self._push_locked(req, front=True)
            self.requeued += 1
            if preempted:
                self.preempted_requeued += 1
            self._gauge()
            self._nonempty.notify()
        # kv_blocks records block-table ownership riding the queue
        # (paged KV): a resumable lease means the next admit re-attaches
        # these pages instead of re-prefilling the prompt (a parked
        # ParkedKV resumes from pinned host-tier pages the same way).
        lease = getattr(req, "kv_lease", None)
        self.tracer.event(
            "queue.requeue", request_id=req.request_id,
            parent_id=req.trace_parent,
            attrs={"attempts": req.attempts,
                   "preempted": preempted,
                   "kv_blocks": (len(lease.blocks)
                                 if lease is not None
                                 and lease.resumable else 0)})

    def waiting(self, priority: Optional[str] = None) -> int:
        """Queued count, optionally for one priority class — the
        batcher's preemption trigger reads waiting("interactive")."""
        with self._lock:
            if priority is None:
                return self._n
            return self._n_by_prio.get(priority, 0)

    def mark_placed(self, n: int) -> None:
        """The batcher finished placing (or failing) n popped requests."""
        with self._lock:
            self._inflight -= n

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def depth(self) -> int:
        with self._lock:
            return self._n

    def begin_drain(self) -> None:
        with self._lock:
            self._draining = True
            self._nonempty.notify_all()

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def fail_all(self, error: str) -> int:
        """Empty the queue, failing every waiter (server stop path)."""
        with self._lock:
            n = self._n
            while True:
                req = self._pop_locked()
                if req is None:
                    break
                req.fail(error)
            self._gauge()
        return n
