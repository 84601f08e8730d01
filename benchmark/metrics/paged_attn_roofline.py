"""Kernel 1's share of its roofline over the profiled slice: its launches
times their mean bound (``cost/attn.py`` on each recorded step plan's
``ctx`` and ``n_new``: the larger of operations over the TF32 peak and
bytes over HBM's) over their device time."""

UNIT, BETTER, SOURCE, LAYER, MOVES = "%", "higher", "device_trace", \
    "kernel 1 (csrc/paged_attn.cu via parallel/paged_attn.py)", \
    "tokens_per_s"
KERNELS = ("paged_attn_kernel",)


def read(w):
    bound = w.bounds.get("paged_attn")
    if w.trace is None or not bound:
        return None
    n, t = w.trace.kernel_time(KERNELS)
    return 100.0 * n * bound / t if n else None
