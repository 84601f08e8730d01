"""The model's operations for the requests answered inside the window
(``cost/model.py``: the work the model needs, not the rows the program
computes) over the window's seconds and the card's dense TF32 peak (the
configurations are float32, which no float32-accurate scheme runs
faster than)."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "higher", "host_clock", \
    "model step (serving/kvcache/paged.py, serving/infer.py)", \
    "tokens_per_s"


def read(w):
    flops = sum(w.system.request_flops(w.traffic, r) for r in w.answered)
    if not flops:
        return None
    return 100.0 * flops / (w.seconds * w.peaks["tf32_flop_per_s"])
