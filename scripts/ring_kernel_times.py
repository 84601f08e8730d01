#!/usr/bin/env python3
"""Device times of the port's ring and tile kernels in one source tree, on
one card.

    python3 scripts/ring_kernel_times.py [TREE]

TREE (default: this checkout) is a checkout of the repository, e.g. a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists. Its own ``chip_smoke.py`` helpers and kernels are
used, so two trees timed in turns in one command (parent, change, change,
parent) compare on the same card. Prints one JSON line: ms of the one-way
and the bidirectional ring all-gather at the probe's 16 MiB and at 256
MiB (beyond the 50 MB L2), of the ring
reduce-scatter at 16 MiB a rank and of the all-reduce composed of the two
(``make_ring_all_gather`` after ``make_ring_reduce_scatter``), of ring
attention at S = 32768, d 128 (8 ranks sharing the card) f32 causal, f32
non-causal and bf16 causal, of the
all-to-all at 16 MiB where the tree has it, of the tile kernels at the
health/bench path's shapes (the burn chain at 1024^2, the burn tile at
2048^2, the matmul at 4096^3 with the full-K route's blocks and with the
K-blocked route's), and, where the tree has them, of the collective
matmuls at the tensor-parallel MLP's shapes (x [4096, 4096] @ w1
[4096, 8192]; relu(h) [4096, 8192] @ w2 [8192, 4096]; 8 ranks sharing
the card) in f32 and bf16, of the matmul reduce-scatter's f32 partial
traffic alone (the same [4096, 4096] output and 8 ranks with a
contraction of 8 a rank, so that the products are negligible and the
time is the partials' writes, copies and folds), and of the one-way ring
all-gather of the all-gather matmul's own x (bf16, 4 MiB shards; the
all-gather's own protocol, not the matmul's relay). Beside the burn
chain: a launch's device time (``torch.profiler``), the host's time to
queue a call, and the time of its function composed of 8 x
(``torch.matmul`` + ``torch.tanh``), a yardstick of 16 library launches
and not one call; and the wall ms of phase 7's health check (inputs
drawn, one chain launch, the signature read back), median of 20. Then
the paged-attention decode step at ``chip_smoke.py``'s phase-3 shape and
inputs, int8 and fp32 pools, and the all-to-all's launch on the card
(``torch.profiler``) and its host time a call, whole and by part of the
tree's wrapper (``chip_smoke.a2a_host_split`` of this checkout where the
tree's wrapper keeps its launch state, ``a2a_host_split_before`` here
where it does not: the form before).
With the card's name and power limit. Needs a CUDA card.
"""

import importlib.util
import json
import os
import statistics
import sys
import time

here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else here)
sys.path.insert(0, tree)

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402

# This checkout's helpers, run on the tree's package (they import it
# lazily, from the tree first on the path).
_spec = importlib.util.spec_from_file_location(
    "chip_smoke_here", os.path.join(here, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
from dpu_operator_tpu_torch.parallel import burn, fabric_probe  # noqa: E402
from dpu_operator_tpu_torch.parallel import mxu_bench  # noqa: E402
from dpu_operator_tpu_torch.parallel import ring_attention as ra  # noqa: E402
from dpu_operator_tpu_torch.parallel import ring_probe as rp  # noqa: E402


def a2a_host_split_before(torch, rp, x, n):
    """{part: host us a call} of the all-to-all wrapper's form before its
    launch state was kept: the checks, the allocation, the pointer
    array, the device context and stream, the control words (their epoch
    advanced), the C entry (the card queries and the cooperative launch)
    and the library lookup, each timed alone, and the whole call."""
    import ctypes

    dev = x.device
    rank_bytes = x.shape[0] // n * x.shape[1] * x.element_size()
    lib = rp._a2a_library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ctl = rp._control(dev, stream, rp._A2AControl)
    outs = (ctypes.c_void_p * n)(*(out.data_ptr() + r * rank_bytes
                                   for r in range(n)))

    def checks():
        rp._a2a_rows(x, n)
        rp._kernel_input(x, n, "all_to_all_cuda")

    def device_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    def c_launch():
        ctl.epoch += 1
        err = lib.all_to_all_launch(x.data_ptr(), outs, ctl.flags.data_ptr(),
                                    n, rank_bytes // n, ctl.epoch, stream)
        smoke.check(err == 0, f"all_to_all_launch: CUDA error {err}")

    return smoke.host_us(torch, {
        "checks": checks,
        "alloc": lambda: torch.empty_like(x),
        "pointer_array": lambda: (ctypes.c_void_p * n)(
            *(out.data_ptr() + r * rank_bytes for r in range(n))),
        "device_stream": device_stream,
        "control": lambda: rp._control(dev, stream, rp._A2AControl),
        "c_launch": c_launch,
        "library": rp._a2a_library,
        "call": lambda: rp.all_to_all_cuda(x, n),
        **smoke.cudart_parts(dev)})


def composition(h, w):
    """The burn chain's function composed of library calls, 8 x
    (``torch.matmul`` + ``torch.tanh``) in bf16 (``bench_gpu``'s
    ``burn_torch_tflops`` yardstick): 16 launches, not one call."""
    for _ in range(8):
        h = torch.tanh(torch.matmul(h, w))
    return h


def health_wall_ms(runs=20):
    """Median host ms of one health check as phase 7 runs it: the burn's
    inputs drawn on the card, ``best_burn_step()`` (one chain launch),
    the signature read back."""
    def once():
        t0 = time.perf_counter()
        float(burn.best_burn_step()(
            *fabric_probe.burn_example_args(device="cuda")))
        return (time.perf_counter() - t0) * 1e3

    once()
    return statistics.median(once() for _ in range(runs))


def main() -> int:
    if not torch.cuda.is_available():
        print("ring_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    n = 8
    x = c.coll_payload(torch, 8192, 512, torch.float32, seed=31)
    X = c.coll_payload(torch, n * 8192, 512, torch.float32, seed=30)
    q, k, v = c.ring_inputs(torch, 32768, 128, 128, torch.float32, seed=20)
    out = {"tree": os.path.basename(tree)}
    out["all_gather_ms"] = c.time_ms(
        torch, lambda: rp.ring_all_gather_cuda(x, n, False), n=10, warm=2)
    out["all_gather_bidir_ms"] = c.time_ms(
        torch, lambda: rp.ring_all_gather_cuda(x, n, True), n=10, warm=2)
    big = c.coll_payload(torch, 256 * 2 ** 20 // (4 * 512), 512,
                         torch.float32, seed=32)
    for key, bidirectional in (("all_gather_256mib_ms", False),
                               ("all_gather_bidir_256mib_ms", True)):
        out[key] = c.time_ms(
            torch, lambda: rp.ring_all_gather_cuda(big, n, bidirectional),
            n=5, warm=1, batch=2)
    del big
    torch.cuda.empty_cache()
    out["reduce_scatter_ms"] = c.time_ms(
        torch, lambda: rp.ring_reduce_scatter_cuda(X, n), n=10, warm=2)
    rs = rp.make_ring_reduce_scatter(c.RING_MESH, "sp")
    ag = rp.make_ring_all_gather(c.RING_MESH, "sp")
    out["all_reduce_ms"] = c.time_ms(torch, lambda: ag(rs(X)), n=10, warm=2)
    out["ring_attn_ms"] = c.time_ms(
        torch, lambda: ra.ring_attention_cuda(q, k, v, n, True), n=5, warm=1,
        batch=2)
    out["ring_attn_noncausal_ms"] = c.time_ms(
        torch, lambda: ra.ring_attention_cuda(q, k, v, n, False), n=5,
        warm=1, batch=2)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    out["ring_attn_bf16_ms"] = c.time_ms(
        torch, lambda: ra.ring_attention_cuda(qb, kb, vb, n, True), n=5,
        warm=1, batch=2)
    del q, k, v, qb, kb, vb
    if hasattr(rp, "all_to_all_cuda"):
        out["all_to_all_ms"] = c.time_ms(
            torch, lambda: rp.all_to_all_cuda(x, n), n=10, warm=2)
    hx, hw = fabric_probe.burn_example_args(device="cuda")
    out["burn_chain_ms"] = c.time_ms(torch, lambda: burn.burn_chain(hx, hw))
    out["burn_chain_launch_ms"], _, out["burn_chain_launch_read"] = (
        smoke.device_ms(torch, lambda: burn.burn_chain(hx, hw),
                        "chain_kernel"))
    out["burn_chain_host_us"] = smoke.host_us(
        torch, {"call": lambda: burn.burn_chain(hx, hw)})["call"]
    out["burn_chain_composition_ms"] = c.time_ms(
        torch, lambda: composition(hx, hw))
    out["health_wall_ms"] = health_wall_ms()
    tx, tw = c.randn_pair(torch, 2048, 2048, seed=1)
    out["burn_tile_ms"] = c.time_ms(torch, lambda: burn.burn_tile(tx, tw))
    mx, mw = c.randn_pair(torch, 4096, 4096, seed=3)
    out["matmul_ms"] = c.time_ms(
        torch, lambda: mxu_bench.pallas_matmul(mx, mw, 1024, 256, 4096))
    out["matmul_kblocked_ms"] = c.time_ms(
        torch, lambda: mxu_bench.pallas_matmul(mx, mw, 512, 512, 1024))
    if hasattr(c, "tp_weights"):
        from dpu_operator_tpu_torch.parallel import collective_matmul as cm
        n = c.TP_MESH["tp"]
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            x, w1, w2 = c.tp_weights(torch, dtype, seed=0)
            h = torch.relu(cm.ag_matmul_cuda(x, w1, n))
            out[f"ag_matmul_{name}_ms"] = c.time_ms(
                torch, lambda: cm.ag_matmul_cuda(x, w1, n), n=5, warm=1,
                batch=2)
            out[f"mm_rs_{name}_ms"] = c.time_ms(
                torch, lambda: cm.mm_rs_cuda(h, w2, n), n=5, warm=1,
                batch=2)
            xs, ws = x[:, :8 * n].contiguous(), w2[:8 * n].contiguous()
            out[f"mm_rs_traffic_{name}_ms"] = c.time_ms(
                torch, lambda: cm.mm_rs_cuda(xs, ws, n), n=5, warm=1,
                batch=2)
            if dtype == torch.bfloat16:
                out["all_gather_bf16_4mib_ms"] = c.time_ms(
                    torch, lambda: rp.ring_all_gather_cuda(x, n, False),
                    n=10, warm=2)
            del x, w1, w2, h, xs, ws
            torch.cuda.empty_cache()
    from dpu_operator_tpu_torch.parallel import paged_attn as pa
    for pool in ("int8", "fp32"):
        args, _, _ = smoke.kernel_inputs(torch, pool, False)
        out[f"paged_attn_{pool}_ms"] = c.time_ms(
            torch, lambda: pa.paged_attn_step_cuda(*args))
        del args
        torch.cuda.empty_cache()
    n = c.RING_MESH["sp"]
    xa = c.coll_payload(torch, 8192, 512, torch.float32, seed=31)
    out["all_to_all_launch_ms"], _, out["all_to_all_launch_read"] = (
        smoke.device_ms(torch, lambda: rp.all_to_all_cuda(xa, n),
                    "all_to_all_kernel"))
    split = (smoke.a2a_host_split if hasattr(rp, "_a2a_launch")
             else a2a_host_split_before)
    out["all_to_all_host_us"] = split(torch, rp, xa, n)
    out["card"] = c.card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
