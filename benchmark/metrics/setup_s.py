"""From the run's process start to the window's opening: imports, the
weights, the executor and its warm-up, the server, the load generator's
connections and the first cohort of requests."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "s", "lower", "host_clock", None, None


def read(w):
    return w.setup_s
