"""Kernel 10's share of its roofline over the profiled slice: its launches
times the bound of one (``cost/exchange.py``: the ``[E·E·C, d]`` f32
buckets read and written once, over HBM's bandwidth) over their device
time."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "higher", "device_trace", \
    "kernel 10 (csrc/all_to_all.cu via parallel/moe.py)", "tokens_per_s"
KERNELS = ("all_to_all_kernel",)


def read(w):
    bound = w.bounds.get("all_to_all")
    if w.trace is None or not bound:
        return None
    n, t = w.trace.kernel_time(KERNELS)
    return 100.0 * n * bound / t if n else None
