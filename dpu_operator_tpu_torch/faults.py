"""Deterministic fault injection — the seam the self-healing plane is
proven against.

The recovery machinery in the serving plane (replica supervision,
requeue, watchdog, circuit breaker) is only trustworthy if every
recovery path is exercised by a fault we *chose*, at a step we *chose*
— not by whatever a flaky CI box happens to do. This module is that
choice: a process-global, test-controllable ``FaultPlan`` holding
specs keyed by **site** strings (``"replica0.step"``,
``"queue.submit"``, ``"fabric.connect"``, ``"vsp.ping"``). Production
code threads two tiny hooks through its seams:

    faults.fire(site)            # before the operation: may raise/hang
    faults.wrap(site, result)    # after it: may corrupt the return

Both are near-free no-ops until a plan is installed (one module-global
read), so the seams stay in the shipped code — the same binary that
serves traffic is the one chaos tests break on demand.

Triggers are deterministic by default: ``at_calls`` fires on exact
1-based call indices of the site, ``times`` caps total firings, and
``probability`` draws from the plan's own seeded RNG — a chaos run is
replayable from its seed. Behaviors: raise a chosen exception, hang
for N seconds (a wedged device step), or corrupt/None a return value.

``FaultyExecutor`` wraps any serving ``Executor`` so a single replica
of a pool can be targeted by name (sites ``{site}.step/.submit/
.collect/.reset``) without the scheduler knowing anything happened.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence

from .obs import trace as _obs_trace


class FaultError(RuntimeError):
    """Default exception type for injected raises."""


class FaultSpec:
    """One armed fault at one site. Mutable only through its plan."""

    __slots__ = ("site", "exc", "hang_s", "corrupt", "at_calls",
                 "probability", "times", "fired")

    def __init__(self, site: str, *, exc=None, hang_s: float = 0.0,
                 corrupt: Optional[Callable[[Any], Any]] = None,
                 at_calls: Optional[Sequence[int]] = None,
                 probability: Optional[float] = None,
                 times: Optional[int] = None):
        if exc is None and not hang_s and corrupt is None:
            raise ValueError(f"fault at {site!r} has no behavior "
                             f"(exc / hang_s / corrupt)")
        if at_calls is not None and probability is not None:
            raise ValueError("at_calls and probability are exclusive "
                             "triggers")
        self.site = site
        self.exc = exc
        self.hang_s = float(hang_s)
        self.corrupt = corrupt
        self.at_calls = frozenset(int(c) for c in at_calls) \
            if at_calls is not None else None
        self.probability = probability
        self.times = times
        self.fired = 0

    def __repr__(self):
        how = ("raise" if self.exc is not None
               else f"hang {self.hang_s}s" if self.hang_s else "corrupt")
        return (f"FaultSpec({self.site!r}, {how}, at={self.at_calls}, "
                f"p={self.probability}, fired={self.fired})")


class FaultPlan:
    """All armed faults plus per-site call accounting. Thread-safe:
    seams fire from batcher/worker/transport threads concurrently."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._pending = threading.local()  # site -> spec, fire→wrap
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}
        self.fired_at: Dict[str, List[float]] = {}

    def inject(self, site: str, **kw) -> FaultSpec:
        spec = FaultSpec(site, **kw)
        with self._lock:
            self._specs.setdefault(site, []).append(spec)
        return spec

    def clear(self, site: Optional[str] = None) -> None:
        with self._lock:
            if site is None:
                self._specs.clear()
            else:
                self._specs.pop(site, None)

    def _record_fired(self, site: str, spec: FaultSpec,
                      extra: Optional[dict] = None) -> None:
        spec.fired += 1
        self.fired[site] = self.fired.get(site, 0) + 1
        self.fired_at.setdefault(site, []).append(time.monotonic())
        # Fault firings are span EVENTS in the same monotonic timeline
        # the serving spans live in: a flight-recorder snapshot can
        # order injection → detection → recovery without correlating
        # clocks. Recorded before a hang behavior sleeps (this runs at
        # arm time), so the event marks when the fault STARTED.
        behavior = ("raise" if spec.exc is not None
                    else "hang" if spec.hang_s else "corrupt")
        attrs = {"site": site, "behavior": behavior,
                 "hang_s": spec.hang_s or None}
        if extra:
            # Seam-site context (e.g. the shard plane's rank): the
            # flight recorder's per-rank `shards` section groups on
            # it, so a kill-one-shard post-mortem shows the fault
            # firing IN the victim rank's own tail.
            attrs.update(extra)
        _obs_trace.event("fault.fired", attrs=attrs)

    def _arm(self, site: str,
             attrs: Optional[dict] = None) -> Optional[FaultSpec]:
        """Count the call; return the first spec that triggers on it.
        raise/hang specs are recorded as fired here; a corrupt-only
        spec is recorded only when wrap() APPLIES it — a fire-only
        seam (queue.submit, fabric.*) never calls wrap, and a fault
        that did nothing must not report itself as injected (the
        bench treats fired_at as a kill's ground truth)."""
        with self._lock:
            n = self.calls.get(site, 0) + 1
            self.calls[site] = n
            for spec in self._specs.get(site, ()):
                if spec.times is not None and spec.fired >= spec.times:
                    continue
                if spec.at_calls is not None:
                    hit = n in spec.at_calls
                elif spec.probability is not None:
                    hit = self._rng.random() < spec.probability
                else:
                    hit = True
                if hit:
                    if spec.exc is not None or spec.hang_s:
                        self._record_fired(site, spec, extra=attrs)
                    return spec
            return None

    def fire(self, site: str,
             attrs: Optional[dict] = None) -> None:
        # Drop any corruption armed by a PREVIOUS fire whose operation
        # raised before wrap() could consume it — a stale pending spec
        # must never corrupt a later, un-targeted call (and must not
        # record a firing at a call it never armed).
        pend = getattr(self._pending, "by_site", None)
        if pend:
            pend.pop(site, None)
        spec = self._arm(site, attrs=attrs)
        if spec is None:
            return
        if spec.hang_s:
            time.sleep(spec.hang_s)
        if spec.exc is not None:
            exc = spec.exc
            if isinstance(exc, type):
                exc = exc(f"injected fault at {site}")
            raise exc
        if spec.corrupt is not None:
            # Defer to wrap(): the corruption applies to the seam's
            # RESULT, which doesn't exist yet at fire time.
            if not hasattr(self._pending, "by_site"):
                self._pending.by_site = {}
            self._pending.by_site[site] = spec

    def wrap(self, site: str, result):
        pend = getattr(self._pending, "by_site", None)
        spec = pend.pop(site, None) if pend else None
        if spec is not None and spec.corrupt is not None:
            with self._lock:
                self._record_fired(site, spec)
            return spec.corrupt(result)
        return result


# -- process-global plan -------------------------------------------------------

_plan: Optional[FaultPlan] = None
_plan_lock = threading.Lock()


def install(plan: Optional[FaultPlan] = None, seed: int = 0) -> FaultPlan:
    """Install (and return) the process-global plan. Idempotence is
    deliberate NOT provided: chaos tests own the lifecycle and a
    leaked plan between tests is a bug worth surfacing."""
    global _plan
    with _plan_lock:
        _plan = plan if plan is not None else FaultPlan(seed)
        return _plan


def uninstall() -> None:
    global _plan
    with _plan_lock:
        _plan = None


def active_plan() -> Optional[FaultPlan]:
    return _plan


def fire(site: str, attrs: Optional[dict] = None) -> None:
    """Seam hook, pre-operation. No-op unless a plan is installed.
    ``attrs`` merge into the fault.fired span event (site context the
    site string alone can't carry structurally — the shard plane
    passes its rank)."""
    p = _plan
    if p is not None:
        p.fire(site, attrs=attrs)


def wrap(site: str, result):
    """Seam hook, post-operation. No-op unless a plan is installed."""
    p = _plan
    if p is not None:
        return p.wrap(site, result)
    return result


@contextmanager
def injected(seed: int = 0):
    """``with faults.injected() as plan:`` — install for a scope,
    always uninstall (a leaked plan would bleed faults across tests)."""
    plan = install(seed=seed)
    try:
        yield plan
    finally:
        uninstall()


# -- the executor-seam wrapper -------------------------------------------------


class FaultyExecutor:
    """Wrap one serving Executor so its seam methods pass through
    named fault points: ``{site}.step``, ``{site}.submit``,
    ``{site}.collect``, ``{site}.reset``. Everything else (slots, d,
    pipelined, steps, …) delegates to the wrapped executor, so the
    scheduler and pool treat it as the replica it wraps — per-replica
    targeting is just a distinct ``site`` per wrapped executor."""

    def __init__(self, inner, site: str = "executor"):
        self.inner = inner
        self.site = site

    def step(self, x):
        fire(f"{self.site}.step")
        return wrap(f"{self.site}.step", self.inner.step(x))

    def reset(self) -> None:
        fire(f"{self.site}.reset")
        self.inner.reset()

    def submit(self, updates, **meta):
        # **meta forwards the diagnostic/guard kwargs (step,
        # request_ids, the KV executors' gen) untouched — the wrapper
        # must never change what the scheduler told the replica.
        fire(f"{self.site}.submit")
        return wrap(f"{self.site}.submit",
                    self.inner.submit(updates, **meta))

    def collect(self, handle):
        fire(f"{self.site}.collect")
        return wrap(f"{self.site}.collect", self.inner.collect(handle))

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name):
        return getattr(self.inner, name)
