"""Host milliseconds a step spends in the executor's submit (the
``executor.submit`` span: plan, uploads, launches): sum(
``timings.submit_ms``) / sum(``timings.steps``) over the answered
requests.

Each request sums the submits of the steps that held it, so the mean
weights a step by its occupants. ``None`` where no answer carries the
fields (a loop with no submit)."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "ms", "lower", "program_span", \
    "executor and planner (serving/kvcache/executor.py, " \
    "serving/executor.py)", "tokens_per_s"


def read(w):
    ms = 0.0
    steps = 0
    for r in w.answered:
        t = r.get("timings", {})
        if "submit_ms" in t and "steps" in t:
            ms += t["submit_ms"]
            steps += t["steps"]
    return ms / steps if steps else None
