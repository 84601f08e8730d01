"""Nearest-rank p95 of the server's ``timings.ttft_ms`` (arrival to the
first token settled) over the answered requests."""

from harness.window import nearest_rank

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "program_span", \
    "batcher (serving/scheduler.py)", "latency_p95_ms"


def read(w):
    vals = sorted(r["timings"]["ttft_ms"] for r in w.answered
                  if "ttft_ms" in r.get("timings", {}))
    return nearest_rank(vals, 0.95) if vals else None
