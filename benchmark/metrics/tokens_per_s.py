"""Output tokens of the requests answered inside the window, over the
window's seconds: all the window's work over all its time."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "tokens/s", "higher", "host_clock", \
    None, None


def read(w):
    return sum(len(r["tokens"]) for r in w.answered) / w.seconds
