"""Median over the answered requests of the client's latency less the
server's own ``timings.total_ms``: the HTTP front door, the JSON and the
loopback both ways."""

import statistics

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "host_clock", \
    "HTTP front door (serving/server.py)", "latency_p95_ms"


def read(w):
    vals = [(r["t_done"] - r["t_send"]) * 1e3 - r["timings"]["total_ms"]
            for r in w.answered if "total_ms" in r.get("timings", {})]
    return statistics.median(vals) if vals else None
