"""Share of the profiled slice in which no operation ran on the device:
one less the union of every stream's operation intervals over the
slice."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "lower", "device_trace", \
    "device (H100)", "tokens_per_s"


def read(w):
    if w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s() / w.trace.window_s)
