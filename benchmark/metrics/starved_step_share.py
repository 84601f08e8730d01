"""Share of the replica's steps submitted after the device had run out
of its work: 100 * sum(``timings.starved_steps``) / sum(``timings.steps``)
over the answered requests.

A step is starved when, at the moment its submit returned, the previous
step's end event had already completed: the device sat idle while the
host was still planning and enqueueing (the batcher's pipelined loops
in serving/scheduler.py, counted while the loop was not drained). Each
request sums the steps that held it, so the sum weights a step by its
occupants. ``None`` where no answer carries the fields (an executor
without a device clock)."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "lower", "program_counter", \
    "executor and planner (serving/kvcache/executor.py, " \
    "serving/executor.py)", "tokens_per_s"


def read(w):
    starved = steps = 0
    for r in w.answered:
        t = r.get("timings", {})
        if "starved_steps" in t and "steps" in t:
            starved += t["starved_steps"]
            steps += t["steps"]
    return 100.0 * starved / steps if steps else None
