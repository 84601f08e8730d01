#!/usr/bin/env python3
"""Int8 disaggregated streams against the prefill schedule.

    python3 scripts/disagg_schedule.py [--rounds N] [--replays M]
        [--device cuda|cpu] [--d D] [--heads H] [--num-blocks B]
        [--threads T] [--out FILE]

In an int8 paged pool a block's scale is set by the step that writes its
row 0 (kernel 1's quantize-append), and the prefill budget is shared
across slots: a prompt whose length is no multiple of the block size
leaves part of its last step's budget to the next prefilling slot in the
rotation, whose chunks leave the block grid from there on. Which slot
that is, and whether a prompt finds another's prefix in the cache,
follows from the step at which each request was attached: its arrival.
So an int8 stream depends on the arrivals, in a colocated executor as in
a prefill replica.

This script measures how far ``chip_smoke.py`` phase 19 (a)'s check (the
disaggregated int8 streams == phase 4's colocated gold, both served over
HTTP) rides on that, at phase 4's width on the card (``SERVE``) or, with
``--device cpu`` and a smaller ``--d``, on the CPU:

  1. the gold: phase 4's int8 executor served over HTTP (``serve_once``),
     its arrivals recorded;
  2. ``--rounds`` runs of phase 19 (a)'s lane (``disagg_lane``), the
     prefill replica's arrivals recorded: each round's streams against
     the gold, its arrivals and chunk layout against the gold's;
  3. every round's arrivals, then ``--replays`` random ones, forced on a
     fresh colocated executor with no HTTP (``replay_colocated``): the
     streams a schedule decodes on its own.

Prints one JSON line a round and a replay, then a summary line with the
card's name and power limit; writes every schedule and stream to
``--out``. Exits 1 if a forced replay does not reproduce its recorded
arrivals, or a round's streams differ from its own arrivals' replay.
The port only: nothing of the JAX package is imported here, and the
recording and forcing wrappers take the executor class they wrap.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def recording(cls):
    """``cls`` with its arrivals and prefill chunks recorded.

    ``arrivals``: ``[submits before the attach, slot, prompt index]`` a
    ``kv_attach``; ``chunks``: prompt index -> ``[[start, take], ...]``
    its prefill chunks in step order; ``cached``: prompt index -> the
    tokens ``kv_attach`` found cached. Prompts are told apart by their
    tokens (``prompts`` given at construction)."""

    class Recording(cls):
        def __init__(self, *args, prompts, **kw):
            self._index = {tuple(p): i for i, p in enumerate(prompts)}
            self._due = {}
            self.submits = 0
            super().__init__(*args, **kw)
            # The constructor's warm-up step is no step of a schedule.
            self.arrivals, self.chunks, self.cached = [], {}, {}
            self.submits = 0

        def kv_attach(self, slot, req):
            cached = super().kv_attach(slot, req)
            i = self._index[tuple(req.prompt_tokens)]
            self.arrivals.append([self.submits, slot, i])
            self.cached[i] = int(cached)
            return cached

        def _plan_step(self):
            before = {s: st.prefill_pos for s, st in enumerate(self._states)
                      if st is not None}
            plan = super()._plan_step()
            for s, pos in before.items():
                st = self._states[s]
                if st is not None and st.prefill_pos > pos:
                    i = self._index[tuple(st.lease.prompt)]
                    self.chunks.setdefault(i, []).append(
                        [int(pos), int(st.prefill_pos - pos)])
            return plan

        def submit(self, *args, **kw):
            handle = super().submit(*args, **kw)
            self.submits += 1
            return handle

    return Recording


def forcing(cls):
    """``recording(cls)`` that puts requests in a queue at set submits:
    ``force(arrivals, reqs, queue)`` submits ``reqs[i]`` for each
    ``[k, slot, i]`` after the executor's k-th submit (k = 0: at once),
    in the order given, so the batcher attaches it before submit k + 1,
    as the recorded run did."""

    class Forced(recording(cls)):
        def force(self, arrivals, reqs, queue):
            self._due = {}
            for k, _slot, i in arrivals:
                self._due.setdefault(int(k), []).append(reqs[i])
            self._queue = queue
            for r in self._due.pop(0, []):
                queue.submit(r)

        def submit(self, *args, **kw):
            handle = super().submit(*args, **kw)
            for r in self._due.pop(self.submits, []):
                self._queue.submit(r)
            return handle

    return Forced


def make_requests(request_cls, prompts, max_tokens):
    return [request_cls(prompt_vec=None, max_tokens=max_tokens,
                        deadline=time.monotonic() + 600,
                        prompt_tokens=list(p)) for p in prompts]


def _wait(reqs):
    for r in reqs:
        if not r.wait(300):
            raise RuntimeError(f"request {r.request_id} unanswered")
    bad = [r.error for r in reqs if r.error is not None]
    if bad:
        raise RuntimeError(f"requests failed: {bad[:3]}")
    return [list(r.tokens) for r in reqs]


def replay_colocated(ex, arrivals, prompts, max_tokens, queue_cls,
                     batcher_cls, request_cls):
    """Force ``arrivals`` on ``ex`` (a ``forcing`` executor) behind a
    pipelined batcher; returns the streams."""
    reqs = make_requests(request_cls, prompts, max_tokens)
    q = queue_cls(max_depth=len(prompts) + 4)
    ex.force(arrivals, reqs, q)
    b = batcher_cls(ex, q)
    b.start()
    try:
        return _wait(reqs)
    finally:
        b.stop()


def replay_disagg(pre, dec, arrivals, prompts, max_tokens, queue_cls,
                  pool_cls, request_cls, pool_opts, decode_pipelined=True):
    """Force ``arrivals`` on the prefill replica ``pre`` (a ``forcing``
    executor) of a ``pool_cls`` over ``pre`` and ``dec``; returns the
    streams."""
    reqs = make_requests(request_cls, prompts, max_tokens)
    q = queue_cls(max_depth=len(prompts) + 4)
    pool = pool_cls([pre], [dec], q, pool_opts=dict(pool_opts),
                    decode_pool_opts=dict(
                        pool_opts,
                        batcher_kwargs={"pipelined": decode_pipelined}))
    pre.force(arrivals, reqs, q)
    pool.start()
    try:
        return _wait(reqs)
    finally:
        pool.stop()


def off_grid(chunks, block_size):
    """Prompt index -> the first chunk start off the block grid, or
    None: where two schedules' pages of a prompt can first differ."""
    return {i: next((s for s, _ in ch if s % block_size), None)
            for i, ch in sorted(chunks.items())}


def random_arrivals(rng, n, spread):
    """Every prompt attached once, in a random order, after a random
    number of submits in [0, spread], non-decreasing, the first at once
    (an executor with nothing attached takes no step)."""
    order = rng.permutation(n)
    ks = sorted(int(k) for k in rng.randint(0, spread + 1, n))
    return [[k - ks[0], None, int(i)] for k, i in zip(ks, order)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--replays", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--d", type=int, default=None)
    ap.add_argument("--heads", type=int, default=None)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--out", default=os.path.join(
        "chiprun_out", "disagg_schedule.json"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as c
    from dpu_operator_tpu_torch.serving import (AdmissionQueue,
                                                ContinuousBatcher,
                                                GenerateRequest,
                                                PagedKVExecutor)

    if args.threads:
        torch.set_num_threads(args.threads)
    cuda = args.device != "cpu"
    if cuda:
        if not torch.cuda.is_available():
            print("disagg_schedule: no CUDA card (--device cpu for the "
                  "CPU)", file=sys.stderr)
            return 2
        from dpu_operator_tpu_torch import cuda_build

        cuda_build.build("paged_attn")
        torch.backends.cuda.matmul.allow_tf32 = False
        card = c.card_line()
    else:
        card = "cpu"
    widths = {k: v for k, v in (("d", args.d), ("heads", args.heads),
                                ("num_blocks", args.num_blocks))
              if v is not None}
    c.SERVE = dict(c.SERVE, **widths)
    kw = dict(c.SERVE, pool_dtype="int8", mode="pipelined")
    kw.update(dict(kernel="cuda", device="cuda") if cuda
              else dict(device="cpu"))
    bs = c.SERVE["block_size"]
    fails = []
    c.check = lambda cond, msg: (None if cond else fails.append(msg))
    prompts = c.serve_prompts()
    n, mt = len(prompts), c.MAX_TOKENS
    Rec, Forced = recording(PagedKVExecutor), forcing(PagedKVExecutor)

    def emit(rec):
        print(json.dumps(rec), flush=True)

    def off_gold(ex):
        """The prompts whose chunk layout or cached count differs from
        the gold's."""
        grid, g = off_grid(ex.chunks, bs), out["gold"]
        return sorted(i for i in grid if grid[i] != g["off_grid"].get(i)
                      or ex.cached[i] != g["cached"][i])

    def colocated(arrivals):
        ex = Forced(**kw, prompts=prompts)
        streams = replay_colocated(ex, arrivals, prompts, mt,
                                   AdmissionQueue, ContinuousBatcher,
                                   GenerateRequest)
        return ex, streams

    t0 = time.monotonic()
    gold_ex = Rec(**kw, prompts=prompts)
    gold, _ = c.serve_once(torch, gold_ex, prompts, card)
    gold_grid = off_grid(gold_ex.chunks, bs)
    out = {"card": card, "serve": c.SERVE, "gold": {
        "streams": gold, "arrivals": gold_ex.arrivals,
        "off_grid": gold_grid, "cached": gold_ex.cached}, "rounds": [],
        "replays": []}
    del gold_ex
    emit({"gold_arrivals": out["gold"]["arrivals"], "off_grid": gold_grid,
          "cached": out["gold"]["cached"]})
    bad_replay = 0
    for r in range(args.rounds):
        fails.clear()
        pre, dec = Rec(**kw, prompts=prompts), PagedKVExecutor(**kw)
        _, streams = c.disagg_lane(torch, card, "int8 pipelined", pre, dec,
                                   prompts, gold, pipelined=True)
        at = c.first_diff(streams, gold)
        grid = off_grid(pre.chunks, bs)
        rec = {"round": r, "arrivals": pre.arrivals,
               "same_arrivals_as_gold": [a[::2] for a in pre.arrivals]
               == [a[::2] for a in out["gold"]["arrivals"]],
               "off_grid": grid, "cached": pre.cached,
               "layout_differs_from_gold": off_gold(pre),
               "equals_gold": at is None, "first_diff": at,
               "lane_checks_failed": [f for f in fails
                                      if "kernel launches" not in f
                                      or cuda]}
        del pre, dec
        rex, rstreams = colocated(rec["arrivals"])
        rec["replay_arrivals_match"] = [a[::2] for a in rex.arrivals] == \
            [a[::2] for a in rec["arrivals"]]
        rec["replay_equals_round"] = rstreams == streams
        bad_replay += not (rec["replay_arrivals_match"]
                           and rec["replay_equals_round"])
        del rex
        out["rounds"].append(dict(rec, streams=streams))
        emit(rec)
        if cuda:
            torch.cuda.empty_cache()
    rng = np.random.RandomState(0)
    spread = max([a[0] for a in out["gold"]["arrivals"]]
                 + [a[0] for rd in out["rounds"] for a in rd["arrivals"]]
                 + [n])
    for j in range(args.replays):
        arrivals = random_arrivals(rng, n, spread)
        rex, streams = colocated(arrivals)
        at = c.first_diff(streams, gold)
        rec = {"replay": j, "arrivals": rex.arrivals,
               "replay_arrivals_match": [a[::2] for a in rex.arrivals]
               == [a[::2] for a in arrivals],
               "layout_differs_from_gold": off_gold(rex),
               "equals_gold": at is None, "first_diff": at}
        bad_replay += not rec["replay_arrivals_match"]
        del rex
        out["replays"].append(dict(rec, streams=streams))
        emit(rec)
        if cuda:
            torch.cuda.empty_cache()
    rounds, replays = out["rounds"], out["replays"]
    summary = {
        "rounds": len(rounds),
        "rounds_equal_gold": sum(r["equals_gold"] for r in rounds),
        "rounds_same_layout_as_gold": sum(
            not r["layout_differs_from_gold"] for r in rounds),
        "rounds_reproduced_by_their_replay": sum(
            r["replay_equals_round"] for r in rounds),
        "replays": len(replays),
        "replays_equal_gold": sum(r["equals_gold"] for r in replays),
        "replays_same_layout_as_gold": sum(
            not r["layout_differs_from_gold"] for r in replays),
        "replays_other_layout_equal_gold": sum(
            r["equals_gold"] and bool(r["layout_differs_from_gold"])
            for r in replays),
        "arrival_spread": spread, "seconds": round(
            time.monotonic() - t0, 1), "card": card}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(out, summary=summary), f)
    if cuda:
        print(card, flush=True)
    emit(summary)
    return 1 if bad_replay else 0


if __name__ == "__main__":
    sys.exit(main())
