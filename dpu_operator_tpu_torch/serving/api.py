"""Request/response vocabulary of the serving plane.

A GenerateRequest is the unit the continuous-batching scheduler moves:
it enters through the HTTP front-end (server.py), waits in the bounded
AdmissionQueue, occupies one batch SLOT in a ContinuousBatcher for
`max_tokens` decode steps (or until its deadline), and completes back
into the waiting handler thread via its event. Everything here is
dependency-free (no jax) so the queue/scheduler plane imports in any
process — the model only enters through the Executor seam.
"""

from __future__ import annotations

import hashlib
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class ServingError(Exception):
    """Base class for serving-plane rejections."""


class QueueFull(ServingError):
    """Admission refused: queue at max depth. Carries the backpressure
    hint the HTTP layer turns into a 503 + Retry-After."""

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(f"admission queue full (depth={depth})")
        self.depth = depth
        self.retry_after_s = retry_after_s


class Draining(ServingError):
    """Admission refused: server is draining (SIGTERM received).
    In-flight requests keep running; new ones must go elsewhere."""


class TenantOverBudget(ServingError):
    """Admission refused: this tenant's token bucket is empty. Carries
    the refill hint the HTTP layer turns into a 429 + Retry-After —
    per-tenant backpressure, distinct from QueueFull's 503: the SERVER
    has capacity, this tenant has spent its share of it."""

    def __init__(self, tenant: str, retry_after_s: float):
        super().__init__(f"tenant {tenant!r} over admission budget")
        self.tenant = tenant
        self.retry_after_s = retry_after_s


#: Priority classes, in strict pop order: every queued interactive
#: request is served before any batch request, and a batch occupant is
#: the only legal preemption victim. Unknown classes are rejected at
#: the HTTP door (400) — a typo must not silently become a new class.
PRIORITIES = ("interactive", "batch")

#: Default cap on distinct tenant label values any one metrics series
#: may carry. Tenant names arrive from the wire, so an adversarial
#: client could otherwise mint unbounded label cardinality.
TENANT_LABEL_CAP = 16


def bounded_tenant_label(tenant: str, seen: set,
                         cap: int = TENANT_LABEL_CAP) -> str:
    """Metrics-safe tenant label: the first `cap` distinct tenants keep
    their own label value, everyone later folds into "other". `seen` is
    the caller-owned admitted-label set (callers mutate it under their
    own lock — the queue and server each bound their series
    independently, so one plane's overflow never renames the other's)."""
    if tenant in seen:
        return tenant
    if len(seen) < cap:
        seen.add(tenant)
        return tenant
    return "other"


# The queue's shed-at-pop error, matched EXACTLY by the HTTP layer to
# pick 503 (back off and retry elsewhere) over 500 (replica failure) —
# a substring match would misclassify executor errors that merely
# mention deadlines (e.g. a collective's DEADLINE_EXCEEDED).
DEADLINE_QUEUED_ERROR = "deadline exceeded while queued"

# The supervisor's give-up error: a request that rode `attempts`
# replica failures has burned its retry budget — 500, not 503, because
# retrying elsewhere is exactly what already failed (matched exactly,
# same reasoning as above).
RETRIES_EXHAUSTED_ERROR = "retries_exhausted"

# KV admission shed: the paged allocator has no pages for this
# request's worst case (prompt + max_tokens). Matched EXACTLY by the
# HTTP layer → 503 + Retry-After: capacity pressure, not a replica
# failure, and pages free as in-flight requests finish.
KV_OOM_ERROR = "kv cache exhausted"


def encode_prompt(text: str, d: int) -> np.ndarray:
    """Deterministic prompt → [d] model-state embedding. The serving
    model (a forward-only view of train_step's stage stack) consumes
    hidden vectors, not token strings; this is the stand-in tokenizer:
    same text always maps to the same state, distinct texts to distinct
    states, so caching/batching behavior is measurable end-to-end."""
    seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:4], "big")
    return np.random.RandomState(seed).randn(d).astype(np.float32)


def encode_prompt_tokens(text: str, n: int, vocab: int) -> List[int]:
    """Deterministic prompt → n token ids in [0, vocab): the stand-in
    tokenizer for the paged-KV plane (token ids, not hidden vectors —
    the KV executors embed them on device). Same text, same ids, so
    prefix caching across identical prompts is measurable end-to-end."""
    seed = int.from_bytes(hashlib.sha256(text.encode()).digest()[:4], "big")
    return [int(t) for t in
            np.random.RandomState(seed).randint(0, vocab, size=n)]


@dataclass
class GenerateRequest:
    """One in-flight generation. Timestamps are time.monotonic() so
    queue/decode decomposition survives wall-clock jumps."""

    prompt_vec: np.ndarray
    max_tokens: int
    deadline: float                      # absolute monotonic
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex[:12])
    arrival: float = field(default_factory=time.monotonic)
    admitted_at: Optional[float] = None  # scheduler placed it in a slot
    # First decoded token settled (TTFT's right edge): stamped by the
    # retire paths on the first append only, so it covers queue +
    # admission + the whole prefill — exactly what a prefix-cache hit
    # shrinks and what serving_ttft_p99_ms measures.
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    truncated: bool = False              # deadline hit mid-decode
    error: Optional[str] = None
    # Replica failures survived so far: the supervisor bumps this on
    # every re-admission after a replica death/wedge; past the pool's
    # attempts budget the request 500s with RETRIES_EXHAUSTED_ERROR.
    attempts: int = 0
    # Multi-tenant QoS: who this request bills to and which
    # priority class it rides. Preemption is policy, not failure — a
    # preempted request requeues WITHOUT touching `attempts` (that
    # budget counts replica faults survived, and a batch request parked
    # N times under interactive pressure has survived zero of them);
    # `preemptions` counts the parks separately for tracing/tests.
    tenant: str = "default"
    priority: str = "interactive"
    preemptions: int = 0
    # Span id (int) of the HTTP handler's root "request" span: the
    # explicit parent every cross-thread span for this request hangs
    # off (queue, admit/retire, supervisor requeue). None for requests
    # submitted without a traced front door.
    trace_parent: Optional[int] = None
    # (Re-)enqueue time, stamped by AdmissionQueue.submit/requeue: the
    # queue.wait span's t0. Distinct from arrival so a requeued
    # request's second wait leg doesn't swallow its failed first
    # decode attempt (seize/requeue latency has its own spans).
    enqueued_at: float = field(default_factory=time.monotonic)
    # Paged-KV plane: token-id prompt (the KV executors
    # embed ids on device; prompt_vec is the legacy hidden-vector
    # plane and is None for KV requests) and the request's KV-page
    # lease. The lease is OPAQUE here (duck-typed kvcache.KVLease —
    # this module stays dependency-free) and rides the request through
    # the supervisor's seize→requeue path: block-table ownership
    # travels the queue, which is what makes retry re-attach pages
    # instead of re-decoding the prompt.
    prompt_tokens: Optional[List[int]] = None
    kv_lease: Optional[object] = field(default=None, repr=False)
    # The step log of the replica whose slot the request was last
    # placed in (duck-typed serving/stepclock.StepLog, bound at
    # admission), and the sums of its earlier slot tenancies, folded in
    # as it was placed again: timings_ms reads the request's step sums
    # from them.
    step_log: Optional[object] = field(default=None, repr=False)
    step_acc: Optional[tuple] = field(default=None, repr=False)
    _done: threading.Event = field(default_factory=threading.Event,
                                   repr=False)

    def finish(self) -> None:
        self.finished_at = time.monotonic()
        # The one settle choke point for KV pages: whichever path
        # settles this request (retire, fail, shed, server stop), the
        # lease releases exactly once (release is idempotent — the
        # happy retire path already released-and-cached before
        # finishing, and this no-ops).
        lease = self.kv_lease
        if lease is not None:
            lease.on_request_settled()
        self._done.set()

    def fail(self, error: str) -> None:
        self.error = error
        self.finish()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def timings_ms(self) -> dict:
        """queue/decode/total decomposition for the response body, and
        the batcher's sums over the request's steps: ``steps``,
        ``submit_ms``, ``device_ms``, ``gap_ms``, ``starved_steps`` and
        ``gc_ms`` where measured (see serving/stepclock.py)."""
        end = self.finished_at or time.monotonic()
        admitted = self.admitted_at
        queue_ms = ((admitted - self.arrival) if admitted is not None
                    else (end - self.arrival)) * 1000.0
        decode_ms = ((end - admitted) * 1000.0
                     if admitted is not None else 0.0)
        out = {
            "queue_ms": round(queue_ms, 3),
            "decode_ms": round(decode_ms, 3),
            "total_ms": round((end - self.arrival) * 1000.0, 3),
        }
        if self.first_token_at is not None:
            out["ttft_ms"] = round(
                (self.first_token_at - self.arrival) * 1000.0, 3)
        if self.step_log is not None:
            out.update(self.step_log.sums(self))
        return out
