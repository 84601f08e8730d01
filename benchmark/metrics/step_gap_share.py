"""Share of the device's step time idle between the replica's steps:
100 * sum(``timings.gap_ms``) / sum(``timings.device_ms`` +
``timings.gap_ms``) over the answered requests.

The program's step clock (serving/stepclock.py) times each step on the
device with events on the executor's stream; ``gap_ms`` is the idle
time from the previous step's end to this step's start, counted while
the batcher's loop was not drained. Each request sums the steps that
held it, so the sum weights a step by its occupants. Idle time inside
a step, where the device waits for the host's launches, is part of
``device_ms``: it shows in ``starved_step_share`` and in the
``submit.launch`` span, not here. ``None`` where no answer carries the
fields (an executor without a device clock)."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "lower", "program_counter", \
    "device (H100)", "tokens_per_s"


def read(w):
    gap = busy = 0.0
    for r in w.answered:
        t = r.get("timings", {})
        if "gap_ms" in t and "device_ms" in t:
            gap += t["gap_ms"]
            busy += t["device_ms"]
    return 100.0 * gap / (gap + busy) if gap + busy > 0 else None
