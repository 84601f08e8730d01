"""The served step's timeline on the card: where the device's idle time
goes and whether the program's step clock agrees with the profiler.

    python3 scripts/served_timeline.py --workload <cell> --seed <n>
        [--seconds 51] [--trace 0|1] [--tracer on|off] [--out FILE]

It runs one benchmark cell (``benchmark/``'s own harness, on the card)
with the program's tracer on or off and prints its result line. With
``--trace 1`` it keeps every span and device operation of the profiled
slice and adds ``timeline``: the clock agreement of each step's
``step.device`` span with the profiler's operations on the executor's
stream, the order checks (device start at or after the step's
``executor.submit`` start, ``done`` at or before its ``collect.wait``
end), and the slice's device idle time split by what the batcher thread
was doing (``submit.plan``, ``submit.upload``, ``submit.launch``,
``step.host``, ``collect.wait``, ``collect.copy``), by cyclic-GC pauses
(``host.gc``, any thread), and by the off-CPU share (wall time less
``cpu_ms``) of the ``executor.submit`` and ``step.host`` spans over it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: What the batcher thread may be doing during a device gap, innermost
#: first; host.gc pauses every thread and takes precedence.
PARTS = ("submit.plan", "submit.upload", "submit.launch", "step.host",
         "collect.wait", "collect.copy")
PARENTS = ("executor.submit", "executor.collect")


def card_line() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def quantile(vals, q):
    vals = sorted(vals)
    if not vals:
        return None
    return vals[min(len(vals) - 1, max(0, int(round(q * (len(vals) - 1)))))]


# -- the traced slice ----------------------------------------------------------


def _device_ops(events, origin, t0, t1):
    """(category, stream, a, b) of each device operation on the
    monotonic clock, clipped to the slice (the harness's reduction, with
    streams and categories)."""
    cats = ("kernel", "gpu_memcpy", "gpu_memset")
    out = []
    for e in events:
        if e.get("cat") not in cats or e.get("ph") != "X":
            continue
        a = origin + float(e["ts"]) / 1e6
        b = a + float(e.get("dur", 0.0)) / 1e6
        a, b = max(a, t0), min(b, t1)
        if b > a:
            stream = (e.get("args") or {}).get("stream", e.get("tid"))
            out.append((e.get("cat"), stream, a, b))
    return out


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(a0, a1, b0, b1):
    return max(0.0, min(a1, b1) - max(a0, b0))


def analyse(events, origin, t0, t1, spans) -> dict:
    ops = _device_ops(events, origin, t0, t1)
    streams = {}
    for _, s, _, _ in ops:
        streams[s] = streams.get(s, 0) + 1
    main = max(streams, key=streams.get) if streams else None
    by = {}
    for sp in spans:
        by.setdefault(sp.name, []).append(sp)
    dev = [s for s in by.get("step.device", [])
           if t0 <= s.t0 and s.t1 <= t1]
    out = {"streams": streams, "main_stream": main,
           "steps_in_slice": len(dev)}

    # Clock agreement: each operation on the executor's stream belongs to
    # the step whose interval, widened to the middles of the gaps beside
    # it, holds the operation's middle; a step's start should come just
    # before its first operation and its done just after its last. A
    # positive error is the device waiting inside the step (the host had
    # not yet launched), a negative one an operation outside its step's
    # interval, which only a clock error explains. Measured against every
    # operation, and against kernels alone: the profiler's record of a
    # copy from pageable host memory may open before the stream reaches
    # it (the host stages the copy), so it can lead its step.
    import bisect
    steps = sorted(dev, key=lambda s: s.t0)
    cuts = [-1e18] + [(steps[k].t1 + steps[k + 1].t0) / 2
                      for k in range(len(steps) - 1)] + [1e18]

    def signed(vals):
        return {"p05": quantile(vals, 0.05), "p50": quantile(vals, 0.5),
                "p95": quantile(vals, 0.95),
                "abs_p50": quantile([abs(x) for x in vals], 0.5),
                "abs_p95": quantile([abs(x) for x in vals], 0.95),
                "negative_share": (sum(1 for x in vals if x < 0) / len(vals)
                                   if vals else None),
                "negative_p95": quantile([-x for x in vals if x < 0],
                                         0.95)}

    def agreement(mine):
        first, last, first_cat = {}, {}, {}
        for cat, a, b in mine:
            k = bisect.bisect_right(cuts, (a + b) / 2) - 1
            if 0 <= k < len(steps):
                if k not in first:
                    first[k] = a
                    first_cat[k] = cat
                last[k] = max(last.get(k, b), b)
        d_start = [(first[k] - steps[k].t0) * 1e3 for k in sorted(first)]
        d_end = [(steps[k].t1 - last[k]) * 1e3 for k in sorted(last)]
        cats = {}
        for k in first:
            cats[first_cat[k]] = cats.get(first_cat[k], 0) + 1
        return ({"steps_compared": len(d_start),
                 "steps_without_ops": len(steps) - len(first),
                 "first_op_categories": cats,
                 "start": signed(d_start), "end": signed(d_end)},
                [[round(x * 1e3) for x in d_start],
                 [round(x * 1e3) for x in d_end]])

    mine = sorted((a, b, c) for c, s, a, b in ops if s == main)
    mine = [(c, a, b) for a, b, c in mine]
    out["agreement_ms"], out["per_step_us"] = agreement(mine)
    out["agreement_kernels_ms"], _ = agreement(
        [m for m in mine if m[0] == "kernel"])

    # Order: device start vs its submit's start; done vs its wait's end.
    sub = {s.attrs.get("step"): s for s in by.get("executor.submit", [])}
    ids = {s.span_id: s for s in spans}
    wait_end = {}
    for w in by.get("collect.wait", []):
        p = ids.get(w.parent_id)
        if p is not None:
            wait_end[w.attrs.get("step")] = w.t1
    lead, lag = [], []
    for s in dev:
        st = s.attrs.get("step")
        if st in sub:
            lead.append((s.t0 - sub[st].t0) * 1e3)
        if st in wait_end:
            lag.append((wait_end[st] - s.t1) * 1e3)
    out["order_ms"] = {
        "start_minus_submit_min": min(lead, default=None),
        "start_minus_submit_p05": quantile(lead, 0.05),
        "start_before_submit_over_0.25": sum(1 for x in lead if x < -0.25),
        "wait_end_minus_done_min": min(lag, default=None),
        "wait_end_minus_done_p05": quantile(lag, 0.05),
        "done_after_wait_over_0.25": sum(1 for x in lag if x < -0.25),
        "steps": len(lead)}

    # Idle time on the device (every stream), split by the host's state.
    busy = _union([(a, b) for _, _, a, b in ops])
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle = sum(b - a for a, b in gaps)
    gcs = sorted((s.t0, s.t1) for s in by.get("host.gc", []))
    parts = {n: sorted((s.t0, s.t1) for s in by.get(n, [])) for n in PARTS}
    parents = {n: sorted((s.t0, s.t1, s.attrs.get("cpu_ms"))
                         for s in by.get(n, [])) for n in
               ("executor.submit", "step.host", "executor.collect")}
    split = {k: 0.0 for k in ("host.gc",) + PARTS
             + ("executor.collect other", "no batcher span")}
    off_cpu = 0.0

    def covered(intervals, a, b):
        return sum(_overlap(x, y, a, b) for x, y, *_ in intervals
                   if x < b and y > a)

    for a, b in gaps:
        g = covered(gcs, a, b)
        split["host.gc"] += g
        rest = (b - a) - g
        got = 0.0
        for n in PARTS:
            v = covered(parts[n], a, b)
            split[n] += v
            got += v
        coll = covered(parents["executor.collect"], a, b)
        split["executor.collect other"] += max(
            0.0, coll - covered(parts["collect.wait"], a, b)
            - covered(parts["collect.copy"], a, b))
        got += max(0.0, coll - covered(parts["collect.wait"], a, b)
                   - covered(parts["collect.copy"], a, b))
        split["no batcher span"] += max(0.0, rest - got)
        for n in ("executor.submit", "step.host"):
            for x, y, cpu in parents[n]:
                ov = _overlap(x, y, a, b)
                if ov > 0 and cpu is not None and y > x:
                    off_cpu += ov * max(0.0, 1.0 - cpu * 1e-3 / (y - x))
    out["idle"] = {"slice_s": t1 - t0, "idle_s": idle,
                   "idle_share": idle / (t1 - t0) if t1 > t0 else None,
                   "by_host_state_s": split,
                   "off_cpu_in_submit_and_host_s": off_cpu,
                   "gc_pauses": len(gcs),
                   "gc_pause_s": sum(y - x for x, y in gcs)}

    # The longest gaps, each with the spans over it.
    top = sorted(gaps, key=lambda g: g[0] - g[1])[:12]
    rows = []
    for a, b in top:
        over = []
        for s in spans:
            if s.name in PARTS + PARENTS + ("step.host", "host.gc") and \
                    _overlap(s.t0, s.t1, a, b) > 0:
                over.append({"name": s.name, "step": s.attrs.get("step"),
                             "ms": round((s.t1 - s.t0) * 1e3, 3),
                             "cpu_ms": s.attrs.get("cpu_ms"),
                             "overlap_ms": round(
                                 _overlap(s.t0, s.t1, a, b) * 1e3, 3),
                             "gen": s.attrs.get("generation")})
        rows.append({"ms": round((b - a) * 1e3, 3),
                     "at_s": round(a - t0, 4), "spans": over})
    out["longest_gaps"] = rows

    # The program's own step accounting over the slice.
    gap_ms = [s.attrs.get("gap_ms") for s in dev
              if s.attrs.get("gap_ms") is not None
              and not s.attrs.get("drained")]
    dev_ms = [(s.t1 - s.t0) * 1e3 for s in dev]
    starved = [bool(s.attrs.get("starved")) for s in dev
               if not s.attrs.get("drained")]
    out["program"] = {
        "step_gap_share_slice": (100.0 * sum(gap_ms)
                                 / (sum(gap_ms) + sum(dev_ms))
                                 if dev_ms else None),
        "starved_share_slice": (100.0 * sum(starved) / len(starved)
                                if starved else None),
        "device_ms_p50": quantile(dev_ms, 0.5),
        "gap_ms_p50": quantile(gap_ms, 0.5),
        "gap_ms_p99": quantile(gap_ms, 0.99),
        "gap_ms_max": max(gap_ms, default=None)}
    for n in ("executor.submit", "step.host", "executor.collect") + PARTS:
        ss = by.get(n, [])
        ms = [(s.t1 - s.t0) * 1e3 for s in ss]
        cpu = [s.attrs.get("cpu_ms") for s in ss
               if s.attrs.get("cpu_ms") is not None]
        out.setdefault("spans_ms", {})[n] = {
            "n": len(ms), "sum": sum(ms), "p50": quantile(ms, 0.5),
            "p99": quantile(ms, 0.99), "max": max(ms, default=None),
            "cpu_sum": sum(cpu) if cpu else None}
    return out


def traced_run(cell, seed, seconds, trace, tracer_on, t_start, **kw):
    """run_cell with the program's tracer on or off; with ``trace`` the
    result carries ``timeline``, the analysis of the profiled slice."""
    from dpu_operator_tpu_torch.obs import trace as obs_trace
    import harness.profile as profile
    from harness.core import run_cell
    obs_trace.get_tracer().enabled = tracer_on
    captured = {}
    reduce = profile.reduce

    def keep(events, origin, t0, t1, spans):
        captured.update(events=events, origin=origin, t0=t0, t1=t1,
                        spans=list(spans))
        return reduce(events, origin, t0, t1, spans)

    profile.reduce = keep
    try:
        out = run_cell(cell, seed, seconds, bool(trace), t_start=t_start,
                       **kw)
    finally:
        profile.reduce = reduce
        obs_trace.get_tracer().enabled = True
    rec = {"result": out["result"]}
    if captured:
        rec["timeline"] = analyse(captured["events"], captured["origin"],
                                  captured["t0"], captured["t1"],
                                  captured["spans"])
    return rec


def run_cell(args) -> int:
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    sys.path.insert(1, ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    t_start = time.monotonic()
    from harness.core import cache_dirs
    from harness.spec import load_cell
    cache_dirs()
    cell = load_cell(args.workload)
    got = traced_run(cell, args.seed, args.seconds, args.trace,
                     args.tracer == "on", t_start)
    result = got["result"]
    rec = {"card": card_line(), "workload": args.workload,
           "seed": args.seed, "tracer": args.tracer, "trace": args.trace,
           **got}
    text = json.dumps(rec)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    summary = {k: rec[k] for k in ("card", "workload", "seed", "tracer")}
    summary["metrics"] = {k: v["value"] for k, v in
                          result["metrics"].items()}
    summary["correct"] = result["correct"]
    if "timeline" in rec:
        tl = rec["timeline"]
        summary["agreement_ms"] = tl["agreement_ms"]
        summary["agreement_kernels_ms"] = tl["agreement_kernels_ms"]
        summary["order_ms"] = tl["order_ms"]
        summary["idle"] = tl["idle"]
        summary["program"] = tl["program"]
    print(json.dumps(summary))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--tracer", choices=("on", "off"), default="on")
    ap.add_argument("--out")
    return run_cell(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
