"""The device trace of a fixed slice of the traced window.

``torch.profiler`` records the slice, the device's activity only; its
Chrome trace is read back and reduced to what the per-layer metrics and
the result's ``breakdown`` need: every device operation's interval on the
host's monotonic clock (the trace's times are wall-clock times from its
``baseTimeNanoseconds``; the offset of the wall clock from the monotonic
one, read when the slice starts, ties the two), the union of those
intervals over every stream (the device's busy time), and the gaps
between them, each named by the batcher's span that the host was in at
the gap's middle. The profiler's first start costs seconds of the
interpreter's lock, so a traced run warms it up in set-up (``warm_up``),
and the trace is read only once the window has closed (``read``).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: Chrome-trace categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: The batcher's spans that say what the host was doing, in preference
#: order where two cover one instant.
HOST_SPANS = ("executor.submit", "step.host", "executor.collect")
#: A kernel's name is kept to this many characters in the breakdown.
NAME_CHARS = 120


@dataclass
class Trace:
    t0: float
    t1: float
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    stats: Dict[str, object] = field(default_factory=dict)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, sorted."""
        out: List[List[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def kernel_time(self, names: Tuple[str, ...]) -> Tuple[int, float]:
        """(launches, device seconds) of the operations whose name holds
        one of ``names``."""
        n, t = 0, 0.0
        for name, a, b in self.ops:
            if any(k in name for k in names):
                n += 1
                t += b - a
        return n, t

    def top_ops(self, k: int = 10) -> List[list]:
        """The ``k`` device operations that took most time (names cut to
        ``NAME_CHARS``), with their seconds in the slice."""
        by: Dict[str, float] = {}
        for name, a, b in self.ops:
            name = name[:NAME_CHARS]
            by[name] = by.get(name, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
                ][:k]

    def idle_gaps(self, k: int = 10) -> List[list]:
        edges = [self.t0]
        for a, b in self.busy():
            edges += [a, b]
        edges.append(self.t1)
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_at((a + b) / 2), b - a] for a, b in gaps[:k]]

    def host_at(self, t: float) -> str:
        best: Optional[str] = None
        for name, a, b in self.spans:
            if a <= t <= b and (best is None or HOST_SPANS.index(name)
                                < HOST_SPANS.index(best)):
                best = name
        return best or "no batcher span"


class Slice:
    """Start and stop the profiler around a slice; ``read`` returns the
    reduced ``Trace``."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        # Without a card (the CPU tests) there is no device to record.
        act = (ProfilerActivity.CUDA if torch.cuda.is_available()
               else ProfilerActivity.CPU)
        self.prof = profile(activities=[act])
        self.wall_minus_mono = 0.0
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        self.prof.start()
        self.wall_minus_mono = time.time() - time.monotonic()
        self.t0 = time.monotonic()

    def warm_up(self) -> None:
        """Start and stop the profiler and read its trace, throwing it
        away: the profiler's one-time costs."""
        self.start()
        import torch
        if torch.cuda.is_available():
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        self.stop()
        self.read([])

    def stop(self) -> None:
        """Stop recording; the trace is read later, by ``read``, once
        the window has closed."""
        self.t1 = time.monotonic()
        self.prof.stop()

    def read(self, spans) -> Trace:
        """Export the recorded trace, read it back and reduce it."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.unlink(path)
        base = float(doc.get("baseTimeNanoseconds", 0)) / 1e9
        return reduce(doc["traceEvents"], base - self.wall_minus_mono,
                      self.t0, self.t1, spans)

def reduce(events, origin: float, t0: float, t1: float, spans) -> Trace:
    """The trace's device operations on the monotonic clock (a trace time
    of ``ts`` microseconds is ``origin + ts / 1e6``), clipped to [t0, t1],
    and the batcher's host spans in it."""
    tr = Trace(t0, t1)
    lo = hi = None
    n_dev = 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        n_dev += 1
        a = origin + float(e["ts"]) / 1e6
        b = a + float(e.get("dur", 0.0)) / 1e6
        lo = a if lo is None else min(lo, a)
        hi = b if hi is None else max(hi, b)
        a, b = max(a, t0), min(b, t1)
        if b > a:
            tr.ops.append((str(e.get("name")), a, b))
    tr.stats = {"device_events": n_dev, "in_slice": len(tr.ops),
                "first_s": None if lo is None else lo - t0,
                "last_s": None if hi is None else hi - t0}
    tr.spans = [(s.name, s.t0, s.t1) for s in spans
                if s.name in HOST_SPANS and s.t1 is not None
                and s.t1 >= t0 and s.t0 <= t1]
    return tr
