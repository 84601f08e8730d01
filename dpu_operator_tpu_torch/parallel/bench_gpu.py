"""On-card benchmark runner: tensor-core and memory numbers of one CUDA
card, as one JSON dict on stdout.

    python -m dpu_operator_tpu_torch.parallel.bench_gpu

Counterpart of the JAX package's ``parallel/bench_tpu.py``, run in a
process of its own so that a caller can bound it with a timeout. Keys:
``platform``, ``device_kind``, ``n_devices``; the matmul race at n=4096,
``mxu_torch_tflops`` (``torch.matmul``) against ``mxu_kernel_tflops``
(the hand-written kernel at ``mxu_kernel_config``, the reference's pinned
blocks); the 8-step burn chain at 1024^2, ``burn_torch_tflops`` against
``burn_kernel_tflops``; ``hbm_gbps``. Each is the median of three runs,
with ``<key>_minmax``. Then the ring block: ``ring_gbps`` and
``ring_axis_size`` from one ``measure_ring_bandwidth`` of the one-way
ring all-gather kernel (gigabits per second, the reference's figure),
and ``ring_bidir_gbps`` (median of three, ``_minmax``) from the
bidirectional kernel. The reference ran this block on two or more
devices; here ``RING_RANKS`` ranks share the one card
(``ring_ranks_share_card``), so the figures rate the ring protocol and
the copies within that card's memory and say nothing about any link
between cards. ``kernel_launches`` counts the kernel launches of this
process. A section that fails leaves ``<section>_error`` and the others'
numbers.

Without a CUDA device it exits 2 and prints nothing on stdout: it has no
CPU result.
"""

from __future__ import annotations

import functools
import json
import math
import statistics
import sys

# The reference's pinned blocks (full K: the accumulator-free route).
KERNEL_CONFIG = (1024, 256, 4096)
BURN_N = 1024
# The ring block's mesh: every rank on the one card.
RING_RANKS = 8


def _runs(measure, n: int = 3) -> list:
    """n independent run-level samples (each already a median of
    slopes), so the result carries min/median/max."""
    return [measure() for _ in range(n)]


def _record(out: dict, key: str, vals: list) -> None:
    out[key] = round(statistics.median(vals), 1)
    out[f"{key}_minmax"] = [round(min(vals), 1), round(max(vals), 1)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_gpu: no CUDA device; this benchmark measures a card "
              "and has no CPU result", file=sys.stderr)
        return 2

    from . import burn, mxu_bench, ring_probe

    device = torch.device("cuda", torch.cuda.current_device())
    out: dict = {
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(device),
        "n_devices": torch.cuda.device_count(),
    }

    _record(out, "mxu_torch_tflops", _runs(
        lambda: mxu_bench.measure_matmul_tflops(
            torch.matmul, device=device)["tflops"]))

    try:
        bm, bn, bk = KERNEL_CONFIG
        mm = functools.partial(mxu_bench.pallas_matmul, bm=bm, bn=bn, bk=bk)
        _record(out, "mxu_kernel_tflops", _runs(
            lambda: mxu_bench.measure_matmul_tflops(
                mm, reps=3, device=device)["tflops"]))
        out["mxu_kernel_config"] = list(KERNEL_CONFIG)
    except Exception as e:  # a kernel failure must not hide torch's number
        out["mxu_kernel_error"] = str(e)[:200]

    # The burn chain, the operator's own hot op (the chip-health probe: 8
    # chained matmul + tanh at 1024^2): the kernel runs it as one launch,
    # torch as 8 library matmuls and 8 tanh passes (bf16 out of each,
    # where the reference's XLA chain rounded once per step).
    try:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        shape = (BURN_N, BURN_N)
        x = torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16)
        w = (torch.randn(shape, generator=gen, device=device)
             / math.sqrt(BURN_N)).to(torch.bfloat16)

        def torch_burn8(h, w):
            for _ in range(8):
                h = torch.tanh(h @ w)
            return h

        def measure_burn(fn):
            per_call = mxu_bench._paired_slope(
                mxu_bench._chained(fn, 200), mxu_bench._chained(fn, 1000),
                (x, w), 200, 1000, 5)
            return 8 * 2 * BURN_N ** 3 / per_call / 1e12

        _record(out, "burn_torch_tflops",
                _runs(lambda: measure_burn(torch_burn8)))
        _record(out, "burn_kernel_tflops", _runs(lambda: measure_burn(
            lambda h, w: burn.burn_chain(h, w, length=8))))
    except Exception as e:
        out["burn_error"] = str(e)[:200]

    best = max(out.get("mxu_kernel_tflops", 0.0),
               out.get("mxu_torch_tflops", 0.0),
               out.get("burn_kernel_tflops", 0.0))
    out["mxu_tflops"] = best
    out["mxu_utilization"] = round(
        best / mxu_bench.H100_PEAK_BF16_TFLOPS, 3)

    try:
        _record(out, "hbm_gbps", _runs(
            lambda: mxu_bench.measure_hbm_gbps(device=device)["gbps"]))
        out["hbm_utilization"] = round(
            out["hbm_gbps"] / mxu_bench.H100_PEAK_HBM_GBPS, 3)
    except Exception as e:  # never discard the numbers already taken
        out["hbm_error"] = str(e)[:200]

    # The one-way ring keeps the reference figure's meaning (the bytes a
    # rank receives over the round's time); the bidirectional figure
    # moves the same bytes both ways round at once. Own try and error key
    # each: a bidirectional failure must not mislabel the one-way figure.
    mesh = {"dp": 1, "sp": RING_RANKS, "tp": 1}
    out["ring_ranks_share_card"] = True
    try:
        ring = ring_probe.measure_ring_bandwidth(mesh, "sp", device=device)
        out["ring_gbps"] = round(ring["effective_gbps"], 2)
        out["ring_axis_size"] = ring["axis_size"]
    except Exception as e:
        out["ring_error"] = str(e)[:200]
        ring = None
    if ring is not None and ring.get("mode") == "unidir":
        try:
            _record(out, "ring_bidir_gbps", _runs(
                lambda: ring_probe.measure_ring_bandwidth(
                    mesh, "sp", bidirectional=True,
                    device=device)["effective_gbps"]))
        except Exception as e:
            out["ring_bidir_error"] = str(e)[:200]

    out["kernel_launches"] = {
        "burn_chain": burn.burn_chain.launches,
        "burn_tile": burn.burn_tile.launches,
        "mm_fullk": mxu_bench.mm_fullk.launches,
        "mm_kblocked": mxu_bench.mm_kblocked.launches,
        "ring_all_gather": ring_probe.ring_all_gather_cuda.launches,
        "ring_all_gather_bidir":
            ring_probe.ring_all_gather_cuda.launches_bidir,
        "ring_reduce_scatter": ring_probe.ring_reduce_scatter_cuda.launches,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
