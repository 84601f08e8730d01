"""Nearest-rank p95 of the client-side latency, from when a request was
due to its whole answer, over every request that finished inside the
window; a failed or refused request counts as infinitely late."""

import math

from harness.window import nearest_rank

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "host_clock", None, \
    None


def read(w):
    lat = sorted(w.latencies_ms())
    if not lat:
        return None
    v = nearest_rank(lat, 0.95)
    return v if math.isfinite(v) else None
