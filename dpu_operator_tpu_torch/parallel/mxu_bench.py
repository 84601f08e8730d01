"""Tensor-core / HBM microbenchmarks: the "is it actually fast" numbers
of the card the operator manages.

Counterpart of the JAX package's ``parallel/mxu_bench.py``. Two
implementations of the hot op are raced:

  * ``pallas_matmul``: the hand-written bf16 tile product
    (``csrc/tile_mma.cu``), launched through ``mm_fullk`` or
    ``mm_kblocked`` by the reference's own route rule;
  * ``torch.matmul``: the library's, as the reference left ``x @ w`` to
    XLA.

Timing keeps the reference's scheme: each measurement runs a chain of L
dependent matmuls ending in a host readback (``.item()``, the sync), and
the per-matmul time is the median slope between a short and a long chain
timed back to back in interleaved pairs, so fixed per-run costs cancel
and drift hits both lengths alike.

The measurement functions take ``device``: the CUDA card unless the
caller asks for the CPU, and each result names the device it ran on.
"""

from __future__ import annotations

import functools
import math
import statistics
import time
from typing import Callable

import torch

from ..device import resolve_device
from . import tile_mma

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3
# bandwidth, at the 700 W power limit.
H100_PEAK_BF16_TFLOPS = 989.0
H100_PEAK_HBM_GBPS = 3350.0


# -- the benchmark matmul -----------------------------------------------------


def matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``bf16(f32(x) @ f32(w))``: the kernels' function, f32 sums, one
    rounding."""
    return (x.float() @ w.float()).to(torch.bfloat16)


def mm_fullk(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's accumulator-free route (``n_k == 1``,
    ``_mm_kernel_fullk``): one launch of the tile kernel."""
    if x.device.type == "cpu":
        return matmul_plain(x, w)
    out = tile_mma.product("mm_fullk", x, w, apply_tanh=False)
    mm_fullk.launches += 1
    return out


def mm_kblocked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's K-blocked route (``n_k > 1``, ``_mm_kernel``): one
    launch of the same tile kernel. The TPU carried the f32 accumulator
    across sequential K grid steps in VMEM; here the K loop runs inside
    each CTA with the accumulator in registers either way, so there is
    no round trip left for the full-K route to save."""
    if x.device.type == "cpu":
        return matmul_plain(x, w)
    out = tile_mma.product("mm_kblocked", x, w, apply_tanh=False)
    mm_kblocked.launches += 1
    return out


#: Kernel launches so far (CPU calls of the wrappers do not count).
mm_fullk.launches = 0
mm_kblocked.launches = 0


def pallas_matmul(x: torch.Tensor, w: torch.Tensor, bm: int = 512,
                  bn: int = 512, bk: int = 1024) -> torch.Tensor:
    """bf16 ``x @ w`` -> bf16 with f32 accumulation, by the hand-written
    kernel. ``bm, bn, bk`` are the reference's TPU VMEM blocks: here they
    only check shapes (m, n, k must divide by them, ValueError otherwise)
    and choose the route, ``mm_fullk`` where ``bk == k`` and
    ``mm_kblocked`` elsewhere. The kernel picks its own CTA tile (128 x
    ``tile_mma.TILE_WIDTH``, K steps of 64 brought in by TMA): a TPU block
    of 512 x 512 x 1024 is far over a Hopper SM's 227 KB of shared
    memory."""
    m, k = x.shape
    k2, n = w.shape
    if not (k == k2 and m % bm == 0 and n % bn == 0 and k % bk == 0):
        raise ValueError(f"pallas_matmul: blocks ({bm}, {bn}, {bk}) do not "
                         f"divide {tuple(x.shape)} @ {tuple(w.shape)}")
    return (mm_fullk if k // bk == 1 else mm_kblocked)(x, w)


# -- slope timing -------------------------------------------------------------


def _chained(matmul: Callable, L: int) -> Callable:
    def run(x, w):
        h = x
        for _ in range(L):
            h = matmul(h, w).to(h.dtype)
        return torch.sum(h.float())

    return run


def _paired_slope(f_short, f_long, args, l_short: int, l_long: int,
                  reps: int) -> float:
    """Median per-op slope from interleaved (short, long) chain timings.
    Interleaving makes drift hit both lengths equally; the median rejects
    the occasional contended pair."""
    float(f_short(*args))  # warm up (first launches, kernel build)
    float(f_long(*args))
    slopes = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(f_short(*args))  # the host readback is the sync
        t_short = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(f_long(*args))
        t_long = time.perf_counter() - t0
        slopes.append((t_long - t_short) / (l_long - l_short))
    return max(statistics.median(slopes), 1e-9)


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def measure_matmul_tflops(matmul: Callable, n: int = 4096,
                          l_short: int = 100, l_long: int = 300,
                          reps: int = 5, seed: int = 0,
                          device=None) -> dict:
    """Per-matmul sustained TFLOP/s for ``matmul`` on n x n bf16
    operands."""
    device = resolve_device(device, "measure_matmul_tflops")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((n, n), generator=gen, device=device).to(torch.bfloat16)
    # Scaled so repeated h @ w neither overflows nor goes subnormal in bf16.
    w = (torch.randn((n, n), generator=gen, device=device)
         / math.sqrt(n)).to(torch.bfloat16)
    per_mm = _paired_slope(_chained(matmul, l_short),
                           _chained(matmul, l_long), (x, w), l_short,
                           l_long, reps)
    tflops = 2 * n * n * n / per_mm / 1e12
    return {
        "n": n,
        "seconds_per_matmul": per_mm,
        "tflops": tflops,
        "utilization_vs_peak": tflops / H100_PEAK_BF16_TFLOPS,
        "device": _device_name(device),
    }


def measure_hbm_gbps(mbytes: int = 256, l_short: int = 20, l_long: int = 100,
                     reps: int = 5, device=None) -> dict:
    """Sustained device-memory read+write bandwidth from a chain of
    elementwise passes over a 2-D bf16 array, each pass one read and one
    write of the whole array."""
    device = resolve_device(device, "measure_hbm_gbps")
    rows = mbytes * 1024 * 1024 // (8192 * 2)
    x = torch.ones((rows, 8192), dtype=torch.bfloat16, device=device)
    bufs = (torch.empty_like(x), torch.empty_like(x))

    def run_l(L):
        def run(x):
            h = x
            for i in range(L):
                # One kernel that reads h once and writes the other
                # buffer once. The reference's `h * 1.0000001 + 1e-7` was
                # one fused XLA pass; in eager PyTorch it would be two
                # kernels and twice the bytes the formula below counts.
                h = torch.mul(h, 1.0000001, out=bufs[i % 2])
            return torch.sum(h[0, :8].float())

        return run

    per_pass = _paired_slope(run_l(l_short), run_l(l_long), (x,), l_short,
                             l_long, reps)
    gbps = 2 * x.numel() * x.element_size() / per_pass / 1e9
    return {
        "mbytes": mbytes,
        "seconds_per_pass": per_pass,
        "gbps": gbps,
        "utilization_vs_peak": gbps / H100_PEAK_HBM_GBPS,
        "device": _device_name(device),
    }


def best_pallas_config(n: int = 4096,
                       configs=((1024, 256, 4096), (512, 512, 4096),
                                (1024, 1024, 512), (512, 512, 1024)),
                       reps: int = 3, device=None) -> tuple:
    """Sweep over the reference's block shapes; returns ``(config,
    result)`` of the fastest. ``bk == n`` entries take the full-K route,
    the others the K-blocked one. Blocks that do not divide n are
    skipped."""
    best = None
    for cfg in configs:
        bm, bn, bk = cfg
        if n % bm or n % bn or n % bk:
            continue
        mm = functools.partial(pallas_matmul, bm=bm, bn=bn, bk=bk)
        r = measure_matmul_tflops(mm, n=n, reps=reps, device=device)
        if best is None or r["tflops"] > best[1]["tflops"]:
            best = (cfg, r)
    if best is None:
        raise RuntimeError(f"no block config divides n={n}")
    return best
