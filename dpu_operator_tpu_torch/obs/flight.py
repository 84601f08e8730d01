"""The wedge flight recorder: post-mortem without reproduction.

When the supervisor declares a replica wedged, a replica crashes, or
the breaker parks one, the interesting evidence is ALREADY in the
tracer's ring buffer — the fault firing, the last decode steps, the
watchdog detection, the seize/requeue chain. This module snapshots
that ring (plus the recent scheduler decisions and the drop counter)
to a JSON file at the moment of failure, so a chaos-run post-mortem
reads a timeline instead of re-rolling the dice. ``GET /debug/flight``
serves the same snapshot on demand without writing a file.

Snapshots are bounded like everything else on this plane: at most
``keep`` files survive per directory (oldest pruned), and a write
failure degrades to an in-memory snapshot with ``write_error`` set —
the recorder must never make a failing replica's day worse.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import tempfile
import time
from collections import deque
from datetime import datetime, timezone
from typing import Optional

from .trace import Tracer, get_tracer

log = logging.getLogger(__name__)

_seq = itertools.count(1)


def default_flight_dir() -> str:
    return os.environ.get(
        "DPU_FLIGHT_DIR",
        os.path.join(tempfile.gettempdir(), "dpu_flight"))


class FlightRecorder:
    def __init__(self, tracer: Optional[Tracer] = None,
                 flight_dir: Optional[str] = None, keep: int = 24,
                 registry=None, prefix: str = "flight",
                 max_spans: int = 2048, shard_tail: int = 128):
        self._tracer = tracer
        self.flight_dir = (flight_dir if flight_dir is not None
                           else default_flight_dir())
        self.keep = int(keep)
        self.registry = registry
        self.prefix = prefix
        # Snapshot the ring's TAIL, not the whole thing: the supervisor
        # writes synchronously at failure time, and a post-mortem wants
        # the recent history around the failure — dumping a full 16k
        # ring would make every replica death pay a multi-hundred-ms
        # serialization bill.
        self.max_spans = int(max_spans)
        # Per-rank span tail for the `shards` section: a
        # chaos post-mortem needs the victim rank's last moments even
        # when a busy coordinator flooded the main tail.
        self.shard_tail = int(shard_tail)

    @property
    def tracer(self) -> Tracer:
        # Resolved per snapshot, not per ctor: a test that installs a
        # scoped tracer AFTER building the server still records into
        # the active one.
        return self._tracer if self._tracer is not None else get_tracer()

    def snapshot(self, reason: str, extra: Optional[dict] = None,
                 write: bool = True) -> dict:
        tracer = self.tracer
        spans = tracer.spans_snapshot()
        # The `shards` section: every rank-attributed span
        # (shard.compute/reduce_blocked/encode, fabric.*, a rank-
        # stamped fault.fired) grouped per rank, tail-bounded PER RANK
        # and taken from the FULL snapshot before the main tail
        # truncates — a kill-one-shard post-mortem must show the
        # victim's fault firing and its peers' reduce stalls even when
        # the coordinator's own spans flooded the recent end. Foreign
        # spans arrive clock-aligned (Tracer.ingest shifted them) with
        # their offset+uncertainty stamped, so ordering claims across
        # the section carry their own error bars.
        shards: dict = {}
        for sp in spans:
            rank = sp.attrs.get("rank") if sp.attrs else None
            if rank is None:
                continue
            tail = shards.get(str(rank))
            if tail is None:
                # deque(maxlen): O(1) eviction, and to_dict() runs
                # only over the KEPT tail below — this is the
                # supervisor's synchronous failure path, where a
                # rank-heavy 16k ring must not pay dict
                # materialization for spans it immediately discards.
                tail = shards[str(rank)] = deque(
                    maxlen=self.shard_tail)
            tail.append(sp)
        shards = {rank: [sp.to_dict() for sp in tail]
                  for rank, tail in shards.items()}
        truncated = len(spans) - self.max_spans
        if truncated > 0:
            spans = spans[-self.max_spans:]
        data = {
            "reason": reason,
            "pid": os.getpid(),
            "wall_time": datetime.now(timezone.utc).isoformat(),
            # The monotonic anchor every span t0/t1 (and the fault
            # plan's fired_at) is relative to — the one shared axis.
            "monotonic": round(time.monotonic(), 6),
            "trace_dropped_total": tracer.dropped_total(),
            "spans_truncated": max(0, truncated),
            "spans": [sp.to_dict() for sp in spans],
            "decisions": tracer.decisions_snapshot(),
        }
        if shards:
            data["shards"] = shards
        if extra:
            data["extra"] = extra
        if self.registry is not None:
            self.registry.counter_inc(
                "serving_flight_snapshots_total", {"reason": reason},
                help="flight-recorder snapshots by trigger")
        if write:
            try:
                os.makedirs(self.flight_dir, exist_ok=True)
                name = (f"{self.prefix}-{reason}-{os.getpid()}"
                        f"-{next(_seq):05d}.json")
                path = os.path.join(self.flight_dir, name)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(data, f, indent=1, default=str)
                os.replace(tmp, path)
                data["path"] = path
                self._prune()
            except OSError as e:
                # Disk trouble must not escalate a replica failure into
                # a supervisor failure; the in-memory snapshot is still
                # returned to /debug/flight callers.
                log.warning("flight recorder: snapshot write failed: "
                            "%s", e)
                data["write_error"] = str(e)
        return data

    def _prune(self) -> None:
        try:
            entries = sorted(
                f for f in os.listdir(self.flight_dir)
                if f.startswith(self.prefix + "-")
                and f.endswith(".json"))
            for stale in entries[:-self.keep] if self.keep else entries:
                os.unlink(os.path.join(self.flight_dir, stale))
        except OSError:
            pass
