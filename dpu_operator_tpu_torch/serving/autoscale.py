"""RoleAutoscaler — live prefill:decode ratio control.

A disaggregated pool fixes its prefill:decode split at construction,
but the workload does not hold still: a prompt-heavy burst starves the
front (prefill) queue while decode replicas idle, and a long-decode
phase does the opposite. This controller retunes the ratio LIVE by
moving replicas between the two role pools — the executor object
(allocator, prefix tree, host tier, resident pages) survives the move;
only the batcher is rebuilt with the destination pool's kwargs, which
is exactly what a "role" is in this codebase (prefill batchers carry
the handoff hook, decode batchers do not).

Signals, all already exported by the serving plane:

  * prefill pressure — the front/admission queue depth (the front
    queue IS the prefill queue in the disagg topology);
  * decode pressure — decode queue depth + transfer backlog (pages
    enqueued or in flight prefill->decode: each is a decode admission
    the decode pool has not absorbed yet);
  * host-gap dampener — the decode pool's serving_host_gap share
    (host_gap / (host_gap + device)). When decode steps are dominated
    by host bookkeeping rather than device time, decode is not
    capacity-bound and a prefill->decode flip buys nothing — the
    controller skips it and counts the dampened tick instead.

Discipline: `hysteresis` consecutive one-sided ticks before any flip,
plus a `cooldown_s` dead time after each — a flip requeues in-flight
work (exactly once, no `attempts` burn), so flapping is strictly worse
than either steady state. Pools never drop below one live replica per
role.

Scale-to-zero reuses the breaker's PARKED state: after
`idle_park_s` of zero pressure and zero active work, surplus replicas
park one per tick down to `min_live`; the first tick of returning
pressure unparks them one per tick, in LIFO order. Only replicas THIS
controller parked are ever unparked — a breaker-parked (crash-looping)
replica stays parked.

Every decision is driven through `tick()`, which is public and
thread-free so tests can step the controller deterministically;
`start()` merely runs `tick()` on a timer thread.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Tuple

from ..obs import trace as obs_trace

log = logging.getLogger(__name__)

__all__ = ["RoleAutoscaler"]


class RoleAutoscaler:
    """Queue-depth / transfer-backlog / host-gap driven controller
    over a DisaggPool: role flips, plus park-to-zero on idle."""

    def __init__(self, pool, registry=None, *,
                 interval_s: float = 0.05,
                 flip_margin: int = 4,
                 hysteresis: int = 3,
                 cooldown_s: float = 1.0,
                 host_gap_ceiling: float = 0.9,
                 idle_park_s: Optional[float] = None,
                 min_live: int = 1,
                 tracer=None):
        self.pool = pool
        self.registry = registry
        self.tracer = (tracer if tracer is not None
                       else obs_trace.get_tracer())
        self.interval_s = float(interval_s)
        self.flip_margin = max(1, int(flip_margin))
        self.hysteresis = max(1, int(hysteresis))
        self.cooldown_s = float(cooldown_s)
        self.host_gap_ceiling = float(host_gap_ceiling)
        self.idle_park_s = idle_park_s
        self.min_live = max(1, int(min_live))
        # Signed streak of one-sided pressure ticks: positive runs
        # argue decode->prefill, negative runs prefill->decode.
        self._streak = 0
        self._last_flip = float("-inf")
        self._idle_since: Optional[float] = None
        # (pool, replica name) parks THIS controller made, LIFO.
        self._parked: List[Tuple[object, str]] = []
        self.flips = 0
        self.parks = 0
        self.unparks = 0
        self.dampened = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="role-autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                # The controller is an optimizer, not a dependency: a
                # bad tick must cost one interval, never the thread.
                log.exception("role autoscaler: tick failed")
            self._stop.wait(self.interval_s)

    # -- signals --------------------------------------------------------------

    def pressures(self) -> Tuple[int, int]:
        """(prefill, decode) pressure right now."""
        prefill = int(self.pool.queue.depth())
        decode = int(self.pool.decode_queue.depth()
                     + self.pool.transfer_backlog())
        return prefill, decode

    def decode_host_gap_fraction(self) -> Optional[float]:
        """Aggregate host-gap share of the decode pool's step wall —
        None until the pool has stepped (no signal is not a veto)."""
        if self.registry is None:
            return None
        prefix = self.pool.decode_pool.name_prefix
        device = self.registry.histogram_totals(
            "serving_step_device_seconds")
        gap_sum = dev_sum = 0.0
        for key, (s, _n) in self.registry.histogram_totals(
                "serving_host_gap_seconds").items():
            labels = dict(key)
            if not str(labels.get("replica", "")).startswith(prefix):
                continue
            gap_sum += s
            dev_sum += device.get(key, (0.0, 0))[0]
        total = gap_sum + dev_sum
        if total <= 0:
            return None
        return gap_sum / total

    # -- the control loop ------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One control decision. Returns the action taken
        ("flip_to_prefill" | "flip_to_decode" | "park" | "unpark" |
        None) — the deterministic seam the tests drive."""
        if now is None:
            now = time.monotonic()
        prefill, decode = self.pressures()
        self._publish(prefill, decode)

        # Scale-from-zero first: parked capacity is useless capacity
        # the moment there is pressure.
        if (prefill + decode) > 0 and self._parked:
            if self._unpark_one():
                self._idle_since = None
                return "unpark"

        skew = prefill - decode
        if skew >= self.flip_margin:
            self._streak = max(1, self._streak + 1)
        elif -skew >= self.flip_margin:
            self._streak = min(-1, self._streak - 1)
        else:
            self._streak = 0

        if abs(self._streak) >= self.hysteresis \
                and now - self._last_flip >= self.cooldown_s:
            if self._streak > 0:
                # Prefill-starved: borrow a decode replica.
                if self.pool.flip_role("decode") is not None:
                    return self._flipped(now, "flip_to_prefill")
            else:
                # Decode-starved — unless decode is host-bound, in
                # which case another decode replica just adds another
                # python loop to the same wall.
                frac = self.decode_host_gap_fraction()
                if frac is not None and frac > self.host_gap_ceiling:
                    self.dampened += 1
                    self._count("serving_autoscale_dampened_total",
                                {"reason": "host_gap"},
                                help="prefill->decode flips skipped "
                                     "because decode is host-bound, "
                                     "not capacity-bound")
                    self._streak = 0
                elif self.pool.flip_role("prefill") is not None:
                    return self._flipped(now, "flip_to_decode")

        # Park-to-zero bookkeeping.
        if self.idle_park_s is not None:
            idle = (prefill + decode) == 0 and self.pool.active() == 0
            if not idle:
                self._idle_since = None
            elif self._idle_since is None:
                self._idle_since = now
            elif now - self._idle_since >= self.idle_park_s:
                if self._park_one():
                    return "park"
        return None

    def _flipped(self, now: float, action: str) -> str:
        self.flips += 1
        self._last_flip = now
        self._streak = 0
        self._idle_since = None
        self._count("serving_autoscale_flips_total", {"action": action},
                    help="role flips committed by the autoscaler")
        return action

    # -- park / unpark ---------------------------------------------------------

    def _park_one(self) -> bool:
        # Prefill surplus parks first: with zero pressure the front
        # door sees new work before the decode plane does, and
        # unparking is LIFO, so the replica that wakes first is the
        # one the first new request needs.
        for p in (self.pool.prefill_pool, self.pool.decode_pool):
            name = p.park_replica(min_live=self.min_live)
            if name is not None:
                self._parked.append((p, name))
                self.parks += 1
                self._count("serving_autoscale_parks_total",
                            {"action": "park"},
                            help="scale-to-zero parks and unparks by "
                                 "the role autoscaler")
                return True
        return False

    def _unpark_one(self) -> bool:
        while self._parked:
            p, name = self._parked.pop()
            try:
                i = p._names.index(name)
            except ValueError:
                continue  # detached since (role flip); nothing to wake
            if p.unpark_replica(i) is not None:
                self.unparks += 1
                self._count("serving_autoscale_parks_total",
                            {"action": "unpark"},
                            help="scale-to-zero parks and unparks by "
                                 "the role autoscaler")
                return True
        return False

    # -- observability ---------------------------------------------------------

    def _count(self, name: str, labels: dict, help: str = "") -> None:
        if self.registry is not None:
            self.registry.counter_inc(name, labels, help=help)

    def _publish(self, prefill: int, decode: int) -> None:
        if self.registry is None:
            return
        self.registry.gauge_set(
            "serving_autoscale_pressure", float(prefill),
            {"role": "prefill"},
            help="autoscaler pressure signal per role (queue depth; "
                 "decode adds transfer backlog)")
        self.registry.gauge_set(
            "serving_autoscale_pressure", float(decode),
            {"role": "decode"},
            help="autoscaler pressure signal per role (queue depth; "
                 "decode adds transfer backlog)")
        self.registry.gauge_set(
            "serving_autoscale_replicas",
            float(self.pool.prefill_pool.live_count()),
            {"role": "prefill"},
            help="live replicas per role as the autoscaler last "
                 "observed them")
        self.registry.gauge_set(
            "serving_autoscale_replicas",
            float(self.pool.decode_pool.live_count()),
            {"role": "decode"},
            help="live replicas per role as the autoscaler last "
                 "observed them")
