#!/usr/bin/env python3
"""Where a mesh-stage serving step's time goes, in each form of its w1
product, on one card.

    python3 scripts/mesh_stage_profile.py [ROUNDS]

Builds ``chip_smoke.py``'s phase 18 (a) configuration (the row model at
E = 1, ``FAB_MODEL`` widths and depth, seed-0 weights, ``FAB_SLOTS``
slots over tp = ``FAB_WORLD`` ranks stacked on the card) and steps
``shard_math.make_mesh_stage_fn`` in its two forms: the default, whose w1
product is one launch of the all-gather matmul kernel a stage, and
``overlap=False``, one ``torch.matmul`` a stage. ROUNDS (default 10)
rounds time one step of each form in turns, the first form alternating:
wall ms (the step ends in a copy to the host) and ms between CUDA events
around it. Then ``torch.profiler`` over 5 steps of each form: device
busy ms against wall ms (idle share; the profiler's own host cost
inflates the wall, so the share is an upper bound) and device time by
kernel (after one profiled step that takes the profiler's start-up).
Prints one JSON line a form with the card's name and power limit.
Needs a CUDA card.
"""

import json
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_stage_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from dpu_operator_tpu_torch.parallel import train_step as ts
    from dpu_operator_tpu_torch.serving import encode_prompt
    from dpu_operator_tpu_torch.serving.sharded import shard_math as sm

    torch.backends.cuda.matmul.allow_tf32 = False
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    S, d, h, E = (c.FAB_MODEL[k] for k in ("S", "d", "h", "E"))
    params = ts.init_params(S, d, h, E, seed=0, device="cuda")
    mesh = {"tp": c.FAB_WORLD}
    x0 = np.stack([encode_prompt(p, d) for p in c.fabric_prompts(
        "mesh", c.FAB_SLOTS)]).astype(np.float32)
    steps = {"kernel": sm.make_mesh_stage_fn(mesh, params),
             "overlap=False": sm.make_mesh_stage_fn(mesh, params,
                                                   overlap=False)}
    for step in steps.values():
        for _ in range(2):
            step(x0)
    torch.cuda.synchronize()
    wall = {k: [] for k in steps}
    events = {k: [] for k in steps}
    order = list(steps)
    for r in range(rounds):
        for label in order if r % 2 == 0 else order[::-1]:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            steps[label](x0)
            b.record()
            wall[label].append((time.perf_counter() - t0) * 1e3)
            b.synchronize()
            events[label].append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        steps["kernel"](x0)  # the profiler's own start-up, not counted
        torch.cuda.synchronize()
    for label, step in steps.items():
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step(x0)
            torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
        rows, busy = c.device_rows(prof)
        print(json.dumps({
            "form": label, "rounds": rounds,
            "wall_ms": statistics.median(wall[label]),
            "wall_ms_all": [round(v, 4) for v in wall[label]],
            "event_ms": statistics.median(events[label]),
            "profiled_steps": 5, "profiled_wall_ms": prof_wall,
            "device_busy_ms": busy, "idle_share": 1 - busy / prof_wall,
            "by_kernel": [[round(us / 1e3, 4), n, key[:80]]
                          for us, n, key in rows[:8]],
            "card": c.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
