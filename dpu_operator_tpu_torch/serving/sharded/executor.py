"""FabricExecutor — one serving replica sharded across many workers.

A copy of the JAX package's ``serving/sharded/executor.py``, statement
for statement. The replica's decode step spans ``world`` shard workers,
each holding one tensor-parallel slice of the params (``shard_math``)
and a replica of the [slots, d] decode state. The coordinator speaks the
serving plane's two-phase contract unchanged, so the pipelined batcher
loop and the pool's supervisor drive it exactly as they drive a
``LocalExecutor``:

  * ``submit(updates)`` broadcasts the step's scatter updates to every
    shard and returns while the shards compute;
  * ``collect(handle)`` gathers the per-slot token ids off the shard
    plane under a hard ``step_timeout_s`` deadline;
  * ``step(x)`` (mode="sync") is the full-state round trip: load every
    row, run one step, materialize the next state from shard 0.

Shard backends speak one duck contract (``reset`` / ``submit(step,
updates, want_state)→handle`` / ``collect(handle, timeout)→
StepOutput`` / ``close``): ``SyntheticShardSet`` (thread shards) and
``ShardProcessSet`` (real ``shard_worker`` processes over the fabric
ring transport).

Per step it observes ``serving_shard_collective_seconds`` (the slowest
shard's time inside the allreduce; under overlap only the non-hidden
wait) and ``serving_shard_step_skew_seconds`` (fastest-vs-slowest shard
compute), both labelled ``{replica, codec}``; the ``ReplicaPool`` binds
its registry via ``bind_registry``.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Sequence

import numpy as np

from ...obs import trace as obs_trace
from ...obs.xproc import federate_labels
from ..executor import Executor

# Collective/skew distributions live at decode-step scale, same as the
# scheduler's step histograms.
_SHARD_BUCKETS = (0.0002, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                  0.05, 0.1, 0.25, 1.0)


class _TracedStep:
    """One in-flight step's coordinator-side trace context: the
    reserved shard.step span id the workers parent on, the submit
    stamp, and the occupant request ids the recorded span will carry
    (what links the whole shard subtree into each request's
    /debug/traces tree)."""

    __slots__ = ("sid", "t0", "rids", "step_no", "handle")

    def __init__(self, sid: Optional[int], t0: float, rids,
                 step_no: int):
        self.sid = sid
        self.t0 = t0
        self.rids = list(rids) if rids else None
        self.step_no = step_no
        self.handle = None


class FabricExecutor(Executor):
    """Coordinator for one sharded replica. ``shards`` is any shard
    set speaking the duck contract above; ``mode`` picks the scheduler
    loop exactly as LocalExecutor's does."""

    sharded = True

    def __init__(self, shards, mode: str = "pipelined",
                 step_timeout_s: float = 60.0, registry=None,
                 name: str = "sharded0"):
        if mode not in ("pipelined", "sync"):
            raise ValueError(f"mode must be pipelined|sync, got "
                             f"{mode!r}")
        self.shards = shards
        self.slots = int(shards.slots)
        self.d = int(shards.d)
        # The wire codec the shard plane reduces over, stamped on the
        # shard metrics: a quantized and an fp32 replica must never
        # aggregate into one latency series (they are different
        # physical collectives).
        self.codec_name = str(getattr(shards, "codec_name", "fp32"))
        self.pipelined = mode == "pipelined"
        self.step_timeout_s = step_timeout_s
        self.name = name
        self._registry = registry
        self._step_no = 0
        # Cross-process ingest bookkeeping: last published
        # per-rank ship-loss total (the counter re-exports deltas so
        # the series stays monotonic per coordinator).
        self._ship_dropped_pub: Dict[int, int] = {}

    # -- wiring ---------------------------------------------------------------

    def bind_registry(self, registry) -> None:
        """ReplicaPool hook: adopt the pool's registry unless the
        constructor already bound one (explicit wins)."""
        if self._registry is None:
            self._registry = registry

    # -- the two-phase decode contract ----------------------------------------

    def reset(self) -> None:
        self._step_no = 0
        # Reset may respawn the worker set (fresh processes, fresh
        # cumulative counters): stale ship-loss cursors would misread
        # the first post-respawn totals.
        self._ship_dropped_pub.clear()
        self.shards.reset()

    def submit(self, updates: Sequence, step=None, request_ids=None,
               occupants=None):
        self._step_no += 1
        tstep = self._begin_step(occupants or request_ids)
        tstep.handle = self.shards.submit(self._step_no,
                                          list(updates),
                                          want_state=False,
                                          trace_parent=tstep.sid)
        if self.pipelined:
            return tstep
        # Sync-shape two-phase callers (the base adapter contract):
        # eager — the step completes before submit returns.
        return self._gather(tstep)

    def collect(self, handle):
        if not self.pipelined:
            return handle  # already token ids (eager submit)
        return self._gather(handle)

    def step(self, x: np.ndarray) -> np.ndarray:
        """The sync loop's full-state round trip: every row loads as
        an update, the next state materializes from shard 0."""
        rows = np.asarray(x, np.float32)
        self._step_no += 1
        tstep = self._begin_step(None)
        tstep.handle = self.shards.submit(self._step_no,
                                          list(enumerate(rows)),
                                          want_state=True,
                                          trace_parent=tstep.sid)
        out = self.shards.collect(tstep.handle,
                                  timeout=self.step_timeout_s)
        self._finish_step(tstep, out)
        if out.state is None:
            raise RuntimeError("shard plane returned no state for a "
                               "sync step")
        return out.state

    def close(self) -> None:
        self.shards.close()

    # -- internals ------------------------------------------------------------

    def _begin_step(self, rids) -> "_TracedStep":
        """Reserve the step's coordinator span id: workers
        parent their shard.compute spans on it BEFORE it is recorded
        — the span itself closes at collect, when its submit→gather
        wall exists."""
        tr = obs_trace.get_tracer()
        sid = tr.reserve_id() if tr.enabled else None
        return _TracedStep(sid, time.monotonic(), rids, self._step_no)

    def _gather(self, tstep: "_TracedStep") -> np.ndarray:
        try:
            out = self.shards.collect(tstep.handle,
                                      timeout=self.step_timeout_s)
        except BaseException as e:
            # The reserved id was already shipped: record the failed
            # step against it so the workers' spans (and the chaos
            # timeline) keep their parent instead of dangling.
            tr = obs_trace.get_tracer()
            if tstep.sid is not None and tr.enabled:
                tr.record_span(
                    "shard.step", tstep.t0, time.monotonic(),
                    span_id=tstep.sid,
                    attrs={"replica": self.name,
                           "step": tstep.step_no,
                           "world": int(self.shards.world),
                           "codec": self.codec_name,
                           "request_ids": tstep.rids,
                           "error": type(e).__name__})
            raise
        self._finish_step(tstep, out)
        return out.tokens

    def _finish_step(self, tstep: "_TracedStep", out) -> None:
        tr = obs_trace.get_tracer()
        if tstep.sid is not None and tr.enabled:
            tr.record_span(
                "shard.step", tstep.t0, time.monotonic(),
                span_id=tstep.sid,
                attrs={"replica": self.name, "step": tstep.step_no,
                       "world": int(self.shards.world),
                       "codec": self.codec_name,
                       "request_ids": tstep.rids})
        self._ingest(out, tr)
        self._observe(out)

    def _ingest(self, out, tr) -> None:
        """Drain the shard plane's piggyback into the coordinator:
        foreign spans onto the process tracer (clock-shifted, offset
        and uncertainty stamped), federated metrics re-exported with
        rank/codec labels, ship losses published as a counter."""
        if out.spans_by_rank:
            for rank, wires in out.spans_by_rank.items():
                off, unc = (out.clock_by_rank or {}).get(
                    rank, (0.0, float("inf")))
                attrs = {"clock_offset_s": round(off, 6)}
                if math.isfinite(unc):
                    attrs["clock_unc_s"] = round(unc, 6)
                else:
                    # No round-trip estimate yet: spans land
                    # unshifted and SAY SO — an unaligned foreign
                    # span must not masquerade as an aligned one.
                    off = 0.0
                    attrs["clock_unaligned"] = True
                tr.ingest(wires, offset=off, attrs=attrs)
        reg = self._registry
        if reg is None:
            return
        if out.span_dropped_by_rank:
            for rank, total in out.span_dropped_by_rank.items():
                last = self._ship_dropped_pub.get(rank, 0)
                # A total BELOW the high-water mark means the worker
                # respawned (fresh process, counter restarted from 0):
                # everything it reports is new loss — resyncing the
                # cursor without publishing would swallow it.
                delta = total - last if total >= last else total
                if delta > 0:
                    reg.counter_inc(
                        "serving_shard_trace_dropped_total",
                        {"replica": self.name, "rank": str(rank)},
                        by=float(delta),
                        help="worker spans lost to the bounded "
                             "piggyback ship buffer")
                self._ship_dropped_pub[rank] = total
        if out.metrics_by_rank:
            for rank, snap in out.metrics_by_rank.items():
                reg.apply_federated(
                    snap, extra_labels=federate_labels(
                        rank, self.codec_name, self.name))

    def _observe(self, out) -> None:
        reg = self._registry
        if reg is None or not out.compute_s:
            return
        labels = {"replica": self.name, "codec": self.codec_name}
        reg.observe(
            "serving_shard_collective_seconds",
            max(out.collective_s), labels,
            help="slowest shard's time inside the per-step collective "
                 "(the step pays the slowest ring member)",
            buckets=_SHARD_BUCKETS)
        reg.observe(
            "serving_shard_step_skew_seconds",
            max(out.compute_s) - min(out.compute_s), labels,
            help="fastest-vs-slowest shard local compute per step — "
                 "imbalance that surfaces as collective wait",
            buckets=_SHARD_BUCKETS)
