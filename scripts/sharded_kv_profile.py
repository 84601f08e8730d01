#!/usr/bin/env python3
"""Where a context-parallel paged-KV step's time goes, on one card.

    python3 scripts/sharded_kv_profile.py

Drives ``chip_smoke.py``'s served model and 8 prompts (int8 pools, sync
mode) straight through the executors' submit/collect loop, with no HTTP
server and no batcher: the single worker (``PagedKVExecutor``), then
``ShardedPagedKVExecutor`` head world 2 and world 4 (rank threads
sharing the card), head world 2 once more with the interpreter's thread
switch interval at 0.2 ms (a test of whether threads waiting for the
interpreter lock hold the step), and the single worker and head world 2
under ``torch.profiler``: device busy time against the wall, and the
top kernels and copies by device time. The streams of every lane must
equal the single worker's. Prints one JSON line a lane, each with the
card's name and power limit. Needs a CUDA card.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

SWITCH_INTERVAL_S = 2e-4
TOP = 10


def drive(ex, prompts):
    """Attach every prompt, step until each has its tokens; (steps, wall
    s, streams)."""
    from dpu_operator_tpu_torch.serving import GenerateRequest

    reqs = [GenerateRequest(prompt_vec=None, max_tokens=cs.MAX_TOKENS,
                            deadline=time.monotonic() + 600,
                            prompt_tokens=list(p)) for p in prompts]
    for s, r in enumerate(reqs):
        ex.kv_attach(s, r)
    live = set(range(len(reqs)))
    steps = 0
    t0 = time.monotonic()
    while live:
        toks = ex.collect(ex.submit((), gen=ex.kv_gen()))
        steps += 1
        cs.check(steps < 4000, "decode never finished")
        for s in sorted(live):
            if toks[s] >= 0:
                reqs[s].tokens.append(int(toks[s]))
            if len(reqs[s].tokens) == cs.MAX_TOKENS:
                ex.kv_release_slot(s, cache=False)
                live.discard(s)
    return steps, time.monotonic() - t0, [list(r.tokens) for r in reqs]


def device_rows(prof):
    rows = []
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            rows.append((us, evt.count, evt.key))
    return sorted(rows, reverse=True)


def lane(torch, card, label, make, prompts, gold, interval=None,
         profiled=False):
    from torch.profiler import ProfilerActivity, profile

    ex = make()
    old = sys.getswitchinterval()
    if interval:
        sys.setswitchinterval(interval)
    try:
        if profiled:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                steps, wall, streams = drive(ex, prompts)
            rows = device_rows(prof)
        else:
            steps, wall, streams = drive(ex, prompts)
    finally:
        sys.setswitchinterval(old)
        if hasattr(ex, "shards"):
            cs.shard_close(ex)
    cs.check(gold is None or streams == gold,
             f"{label}: streams differ from the single worker's")
    out = dict(lane=label, steps=steps, wall_s=wall,
               ms_per_step=wall / steps * 1e3,
               switch_interval_s=interval or old, profiled=profiled,
               card=card)
    if profiled:
        busy = sum(r[0] for r in rows) / 1e3
        out.update(device_busy_ms=busy, idle_share=1 - busy / (wall * 1e3),
                   top=[dict(ms=us / 1e3, count=n, name=key[:90])
                        for us, n, key in rows[:TOP]])
    print(json.dumps(out), flush=True)
    del ex
    torch.cuda.empty_cache()
    return streams


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sharded_kv_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dpu_operator_tpu_torch import cuda_build
    from dpu_operator_tpu_torch.serving import (PagedKVExecutor,
                                                ShardedPagedKVExecutor)

    card = cs.card_line()
    cuda_build.build("paged_attn")
    kw = dict(cs.SERVE, pool_dtype="int8", mode="sync", kernel="cuda",
              device="cuda")
    prompts = cs.serve_prompts()

    def single():
        return PagedKVExecutor(**kw)

    def head(world):
        return lambda: ShardedPagedKVExecutor(**kw, world=world,
                                              shard_axis="head")

    gold = lane(torch, card, "single", single, prompts, None)
    lane(torch, card, "head world 2", head(2), prompts, gold)
    lane(torch, card, "head world 4", head(4), prompts, gold)
    lane(torch, card, "head world 2", head(2), prompts, gold,
         interval=SWITCH_INTERVAL_S)
    lane(torch, card, "single", single, prompts, gold, profiled=True)
    lane(torch, card, "head world 2", head(2), prompts, gold, profiled=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
