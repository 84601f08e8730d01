"""Each served step's device interval on the host's monotonic clock, and
the per-replica log of steps that the per-request sums read.

An executor with a device clock answers ``step_clock(handle)`` for a
collected step with a ``StepClock``: when the step started and ended on
the device, the idle gap since the previous step's end on the same
stream, whether the device had already run out of this replica's work
when the step's submit returned (``starved``), and the host's marks
inside the step's submit and collect (planning done, uploads queued,
the wait over) that split the batcher's ``executor.submit`` and
``executor.collect`` spans into their parts. Executors without a device
clock answer None.

On a CUDA device (``CudaStepClock``) a step ends in a timing-enabled
``done`` event from a small pool. Its start is timed by a second event
only where the stream may have run dry before it: the previous step's
``done`` had completed when the dispatch began (one ``query``). On a
busy stream the step starts as the step before it ends, with no gap.
Each event is timed from a reference event, one ``done`` a ``REFRESH_S``
window, so every event has a device time on one axis and no rounding
accumulates along the steps (elapsed times are whole microseconds or
coarser; chained step to step they drift by hundreds of them a second).
That axis is placed on the host's clock by bounds from both sides: a
start event cannot run before the host reads its clock and records it,
and a ``done`` event has run by the time the host reads its clock after
waiting for it. The lower bound is tight where the stream sat idle
before the start (a gap of more than ``IDLE_S``: the event ran as soon
as it was recorded), the upper bound where the collect had to wait for
the step. The two clocks drift apart (by some hundreds of parts a
million on an H100's host), so each bound loosens by ``DRIFT`` for every
second of device time since it was taken. The clock takes the freshest
tight bound of either kind, kept within the highest lower and the lowest
upper bound of all; the lowest upper bound where no bound is tight.

``StepLog`` holds one replica's collected steps as cumulative counters,
each with its submit's start and its collect's end. A request's sums
are read once it has finished, as the difference over the steps
submitted after its admission and collected before its end: exactly the
steps whose slot snapshot held it, less a pipelined loop's last step
over a slot it had left (that step runs the slot for nobody). Nothing
is done per request or per slot while the loop runs.
"""

from __future__ import annotations

import time
from bisect import bisect_left, bisect_right
from operator import itemgetter
from typing import NamedTuple, Optional

from ..obs.trace import gc_pauses


class StepClock(NamedTuple):
    """One collected step on the host's monotonic clock (seconds)."""

    #: the step's start on the device: before its first upload
    t0: float
    #: the step's end on the device: its ``done``
    t1: float
    #: the previous step's end to this step's start, on the same stream
    gap_s: float
    #: the previous step had already ended when this step's submit
    #: returned: the device ran out of work while the host enqueued
    starved: bool
    #: host marks, None where the executor has none: inside the submit,
    #: planning done and the dispatch begun; the uploads queued
    t_start: Optional[float] = None
    t_upload: Optional[float] = None
    #: inside the collect: the wait for the step's end over
    t_waited: Optional[float] = None


class _CudaStep:
    """One step's events, ``start`` (None on a busy stream) and ``done``;
    ``starved``; the host's clock as the dispatch began (``t_rec``),
    once the uploads were queued (``t_up``, set by the executor) and
    right after the host saw ``done`` complete (``seen``), and whether
    it had to wait for that (``waited``)."""

    __slots__ = ("start", "done", "starved", "t_rec", "t_up", "seen",
                 "waited")

    def __init__(self, t_rec):
        self.start = None
        self.done = None
        self.starved = False
        self.t_rec = t_rec
        self.t_up = None
        self.seen = 0.0
        self.waited = False


class CudaStepClock:
    """StepClock from timing-enabled CUDA events on one stream. All calls
    come from the executor's one submitting and collecting thread.

    ``start(stream)`` before the step's first upload, ``done(step,
    stream)`` after its last launch, ``submitted(step)`` as its submit
    returns, ``wait(step)`` to wait for it, ``clock(step)`` once it has
    been waited for, in submission order."""

    #: the length of one window of bounds (seconds)
    REFRESH_S = 0.5
    #: a gap longer than this before a step's start means the stream was
    #: idle when the start was recorded (back to back, events on one
    #: stream run a few microseconds apart)
    IDLE_S = 2e-5
    #: how fast a bound loosens (seconds a second of device time): above
    #: the two clocks' drift
    DRIFT = 1e-3

    def __init__(self):
        import torch
        self._event = torch.cuda.Event
        self._free = []
        self._last: Optional[_CudaStep] = None
        # The reference event of this window and the device time of the
        # last clocked step's done after it (s).
        self._ref = None
        self._tail_t = None
        # The last clocked step's done: back to the pool at the next
        # clock, since the next submit may still query it.
        self._held = None
        self._window_at = None
        # Bounds on the reference's host time, each with the device time
        # it was taken at, [bound, at], None where unset: the highest
        # (tight) lower bound, the lowest upper bound, and the freshest
        # tight upper bound.
        self._lo = None
        self._hi = None
        self._tight_hi = None

    def _take(self):
        if self._free:
            return self._free.pop()
        return self._event(enable_timing=True)

    def start(self, stream) -> _CudaStep:
        st = _CudaStep(time.monotonic())
        prev = self._last
        if prev is None or prev.done.query():
            # The stream may be idle: time this step's start. The step
            # before has ended, so this one is starved.
            st.start = self._take()
            st.start.record(stream)
            st.starved = True
        return st

    def done(self, st: _CudaStep, stream):
        st.done = self._take()
        st.done.record(stream)
        return st.done

    def submitted(self, st: _CudaStep) -> None:
        if not st.starved:
            st.starved = self._last.done.query()
        self._last = st

    def reset(self) -> None:
        """A new decode session: the next step has no predecessor."""
        self._last = None

    def wait(self, st: _CudaStep) -> None:
        t = time.monotonic()
        st.done.synchronize()
        st.seen = time.monotonic()
        st.waited = st.seen - t > self.IDLE_S

    def clock(self, st: _CudaStep) -> StepClock:
        ref = self._ref
        if ref is None:
            ref = self._ref = st.start if st.start is not None else st.done
            self._window_at = st.seen
        rd = ref.elapsed_time(st.done) * 1e-3
        tail_t = self._tail_t
        if st.start is not None:
            rs = ref.elapsed_time(st.start) * 1e-3
            gap = rs - tail_t if tail_t is not None else 0.0
            if st.start is not ref:
                self._free.append(st.start)
        else:
            # Recorded behind the previous step's done on a busy stream:
            # it began as that step ended.
            rs = tail_t if tail_t is not None else rd
            gap = 0.0
        held, self._held = self._held, st.done
        if held is not None and held is not ref:
            self._free.append(held)
        drift = self.DRIFT
        lo, hi, tight = self._lo, self._hi, self._tight_hi
        if tail_t is not None and gap > self.IDLE_S:
            b = st.t_rec - rs
            if lo is None or b > lo[0] - drift * (rs - lo[1]):
                lo = self._lo = [b, rs]
        # A bound from this step's wait is kept as taken at its start: it
        # ages the more, and a lower bound of the same step is as fresh.
        b = st.seen - rd
        if hi is None or b < hi[0] + drift * (rs - hi[1]):
            hi = self._hi = [b, rs]
        if st.waited:
            tight = self._tight_hi = [b, rs]
        # Each bound as it stands at the step's start, so the interval
        # keeps its device length.
        cap = hi[0] + drift * (rs - hi[1])
        at = cap
        if tight is not None:
            at = min(cap, tight[0] + drift * (rs - tight[1]))
        if lo is not None:
            floor = lo[0] - drift * (rs - lo[1])
            if tight is None or lo[1] >= tight[1]:
                at = floor
            at = max(floor, min(at, cap))
        if st.seen - self._window_at >= self.REFRESH_S:
            # A new window, measured from this step's done: the bounds
            # move with the reference.
            for bound in (lo, hi, tight):
                if bound is not None:
                    bound[0] += rd
                    bound[1] -= rd
            self._free.append(ref)
            self._ref = st.done
            self._window_at = st.seen
            self._tail_t = 0.0
        else:
            self._tail_t = rd
        return StepClock(at + rs, at + rd, gap, st.starved, st.t_rec,
                         st.t_up, st.seen)


_SUBMITTED = itemgetter(0)
_COLLECTED = itemgetter(1)
#: steps, steps with a device clock, device s, gap s, starved steps,
#: submit s
_ZERO = (0, 0, 0.0, 0.0, 0, 0.0)


class StepLog:
    """One replica's collected steps, in submission order: each step's
    submit start and collect end on the monotonic clock, and the
    counters summed over every step up to it. Appended by the batcher's
    thread; read from any thread (a response's ``timings``).

    ``submits``: the replica's loop submits and collects (its steps have
    a ``submit_ms``); the synchronous row loop has no submit. Gaps and
    starved steps count only where the step was ``counted``: the loop
    had not drained before it, the rule the host gap follows."""

    #: steps kept at least: a request whose first step is older reads no
    #: sums
    KEEP = 1 << 14

    def __init__(self, submits: bool):
        self.submits = submits
        self._cum = _ZERO
        # (index of the first entry kept, entries), replaced whole when
        # trimmed so a reader never sees a list shift under it.
        self._state = (0, [])

    def add(self, ts0: float, t_done: float, clk: Optional[StepClock],
            counted: bool, submit_s: float) -> None:
        n, clocked, dev, gap, starved, sub = self._cum
        n += 1
        sub += submit_s
        if clk is not None:
            clocked += 1
            dev += clk.t1 - clk.t0
            if counted:
                gap += clk.gap_s
                starved += clk.starved
        self._cum = cum = (n, clocked, dev, gap, starved, sub)
        base, entries = self._state
        entries.append((ts0, t_done) + cum)
        if len(entries) > 2 * self.KEEP:
            self._state = (base + self.KEEP, entries[self.KEEP:])

    def between(self, t_from: float, t_to: float) -> Optional[tuple]:
        """The counters over the steps submitted at or after ``t_from``
        and collected at or before ``t_to``; None where the first of
        them is no longer kept."""
        base, entries = self._state
        i = bisect_left(entries, t_from, key=_SUBMITTED)
        j = bisect_right(entries, t_to, key=_COLLECTED)
        if j <= i:
            return _ZERO
        if i == 0 and base:
            return None
        a = entries[i - 1][2:] if i else _ZERO
        return tuple(y - x for x, y in zip(a, entries[j - 1][2:]))

    def _tenancy(self, req, t_to: float) -> Optional[tuple]:
        """The request's steps here from its admission to ``t_to``, and
        the GC pauses between: the counters and the pause (s); None
        where its first step is no longer kept."""
        got = self.between(req.admitted_at, t_to)
        if got is None:
            return None
        return got + (gc_pauses.between(req.admitted_at, t_to),)

    def admit(self, req) -> None:
        """Bind a request being placed in one of this replica's slots,
        BEFORE its ``admitted_at`` moves on. A request that held a slot
        before (preempted, handed off or seized, then requeued) first
        folds that tenancy, which ended as it was requeued."""
        prev = req.step_log
        if prev is not None and req.admitted_at is not None:
            got = prev._tenancy(req, req.enqueued_at)
            acc = req.step_acc
            if got is not None:
                req.step_acc = (got if acc is None else
                                tuple(a + b for a, b in zip(acc, got)))
        req.step_log = self

    def sums(self, req) -> dict:
        """A request's step sums for its response's ``timings``: its
        ``steps`` and ``submit_ms``; with a device clock on every step,
        ``device_ms``, ``gap_ms`` and ``starved_steps``; while the GC
        hook is installed, ``gc_ms``. Empty before its first step."""
        if req.admitted_at is None:
            return {}
        got = self._tenancy(req, req.finished_at or time.monotonic())
        if got is None:
            return {}
        acc = req.step_acc
        if acc is not None:
            got = tuple(a + b for a, b in zip(acc, got))
        steps, clocked, dev, gap, starved, sub, gc_s = got
        if not steps:
            return {}
        out = {"steps": steps}
        if self.submits:
            out["submit_ms"] = round(sub * 1e3, 3)
        if clocked == steps:
            out["device_ms"] = round(dev * 1e3, 3)
            out["gap_ms"] = round(gap * 1e3, 3)
            out["starved_steps"] = starved
        if gc_pauses.installed:
            out["gc_ms"] = round(gc_s * 1e3, 3)
        return out
