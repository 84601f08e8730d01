"""The window's milliseconds over the batcher's steps in it
(``ContinuousBatcher.steps`` read at the window's open and close)."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "program_counter", \
    "executor and planner (serving/kvcache/executor.py, " \
    "serving/executor.py)", "tokens_per_s"


def read(w):
    steps = w.counters.get("steps", 0)
    return w.seconds * 1e3 / steps if steps else None
