"""Nearest-rank p95 of the server's ``timings.queue_ms`` (arrival to a
batch slot) over the answered requests."""

from harness.window import nearest_rank

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "program_span", \
    "admission (serving/queue.py)", "latency_p95_ms"


def read(w):
    vals = sorted(r["timings"]["queue_ms"] for r in w.answered
                  if "queue_ms" in r.get("timings", {}))
    return nearest_rank(vals, 0.95) if vals else None
