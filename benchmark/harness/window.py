"""What one run's window gives the metric readers."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from cost import PEAKS


def nearest_rank(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank (ceil) percentile over a SORTED sample list: p99
    over <100 samples must still be able to land on the worst
    observation — int() truncation would exclude it. (A copy of the
    serving bench's convention.)"""
    n = len(sorted_vals)
    return sorted_vals[min(n - 1, max(0, math.ceil(n * q) - 1))]


@dataclass
class Window:
    t_open: float
    t_close: float
    setup_s: float
    #: every request the load generator recorded, answered or not
    records: List[dict]
    counters: Dict[str, float]
    traffic: Any
    system: Any
    trace: Optional[Any] = None
    bounds: Dict[str, Optional[float]] = field(default_factory=dict)
    peaks: Dict[str, Any] = field(default_factory=lambda: dict(PEAKS))

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    @property
    def finished(self) -> List[dict]:
        """Requests whose answer, or failure, came inside the window."""
        return [r for r in self.records
                if self.t_open <= r["t_done"] <= self.t_close]

    @property
    def answered(self) -> List[dict]:
        return [r for r in self.finished if r["status"] == 200]

    @property
    def failed(self) -> List[dict]:
        return [r for r in self.finished if r["status"] != 200]

    def latencies_ms(self) -> List[float]:
        """Client-side time from when each request was due to its whole
        answer; a failed request is infinitely late."""
        lat = [(r["t_done"] - r["t_due"]) * 1e3 for r in self.answered]
        return lat + [math.inf] * len(self.failed)
