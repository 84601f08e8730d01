"""One run of one cell: set up, drive the window, check, report.

``run_cell`` is what ``run.py`` calls once it has found the card; the
CPU tests call it with ``device="cpu"`` and a small configuration.
"""

from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import threading
import time
from typing import Optional

from .readers import load_reader
from .spec import BENCH_DIR, ROOT, Cell
from .systems import load_system
from .traffic import Traffic
from .window import Window

#: How long the first cohort may take to answer, and the results to come
#: back once the window has closed.
OPEN_TIMEOUT_S = 900.0
RESULTS_TIMEOUT_S = 180.0
#: The profiled slice of a traced window, at most, in its middle.
SLICE_S = 5.0


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


class LoadGen:
    """The load generator's child process and a reader of its events."""

    def __init__(self, job: dict):
        self.proc = subprocess.Popen(
            [sys.executable, str(BENCH_DIR / "harness" / "loadgen.py"),
             json.dumps(job)],
            stdout=subprocess.PIPE, stdin=subprocess.DEVNULL, text=True)
        self.events: "queue.Queue[dict]" = queue.Queue()
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            try:
                self.events.put(json.loads(line))
            except ValueError:
                continue
        self.events.put({"event": "exit", "rc": self.proc.wait()})

    def wait(self, name: str, timeout: float) -> dict:
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"load generator: no {name!r} within "
                                   f"{timeout:.0f} s")
            ev = self.events.get(timeout=left)
            if ev.get("event") == name:
                return ev
            if ev.get("event") == "exit":
                raise RuntimeError(f"load generator exited (rc "
                                   f"{ev['rc']}) before {name!r}")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._t.join(timeout=5)


def _traced_slice(sysm, server, t_open: float, seconds: float):
    """Profile ``SLICE_S`` seconds in the middle of the window; returns
    the stopped profiler's slice and the batcher's spans in it, read
    once the window has closed (``_read_slice``)."""
    from .profile import Slice
    length = min(SLICE_S, seconds / 2.0)
    time.sleep(max(0.0, t_open + (seconds - length) / 2.0
                   - time.monotonic()))
    tracer = server.tracer
    tracer.clear()
    sl = Slice()
    sysm.trace_launches(True)
    sl.start()
    end = sl.t0 + length
    while time.monotonic() < end:
        # The batcher's span buffer is bounded: move it to the ring.
        tracer.drain()
        time.sleep(min(0.2, max(0.0, end - time.monotonic())))
    sl.stop()
    sysm.trace_launches(False)
    return sl, tracer.spans_snapshot()


def _read_slice(sysm, sl, spans):
    trace = sl.read(spans)
    trace.stats["spans"] = len(spans)
    trace.stats["host_spans_in_slice"] = len(trace.spans)
    log(f"trace: {trace.stats}")
    return trace, sysm.launch_bounds()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             t_start: float, device=None, kernel: Optional[str] = None,
             control: bool = False) -> dict:
    """Run ``cell`` once. Returns a dict with ``result`` (the last line's
    object, without ``device``'s card fields), ``compares`` (each number
    compared beside its limit), ``readings`` (the control's, when asked
    for) and ``window``."""
    import torch
    from dpu_operator_tpu_torch.serving.server import ServingServer

    cfg = cell.config
    device = torch.device(device or cfg.get("device", "cuda"))
    kernel = kernel or cfg.get("kernel")
    cuda = device.type == "cuda"
    System = load_system(cfg["executor"])
    sysm = System(cell, seed, device, kernel)
    traffic = Traffic(cell.traffic, cfg["serving"], seed)
    server = gen = None
    try:
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        if trace:
            # The profiler's first start imports and initialises much
            # (seconds of the interpreter's lock): pay it in set-up, not
            # in the slice.
            from .profile import Slice
            Slice().warm_up()
        t_build = time.monotonic()
        executors = sysm.build()
        server = ServingServer(executors, **sysm.server_opts()).start()
        gen = LoadGen({"host": "127.0.0.1", "port": server.port,
                       "mix": cell.traffic, "serving": cfg["serving"],
                       "seed": seed, "seconds": seconds})
        t_gen = time.monotonic()
        t_open = gen.wait("open", OPEN_TIMEOUT_S)["t"]
        log(f"set-up: {t_build - t_start:.3f} s to the executor, "
            f"{t_gen - t_build:.3f} s executor and server, "
            f"{t_open - t_gen:.3f} s connections and first cohort")
        c_open = sysm.counters(server)
        tr, bounds, sliced = None, {}, None
        if trace:
            sliced = _traced_slice(sysm, server, t_open, seconds)
        t_close = gen.wait("close", seconds + 60.0)["t"]
        c_close = sysm.counters(server)
        records = gen.wait("results", RESULTS_TIMEOUT_S)["requests"]
        gen.stop()
        if sliced is not None:
            tr, bounds = _read_slice(sysm, *sliced)
        peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
        server.stop()
        server = None
        executors = None
        sysm.free()
        if cuda:
            log(f"check: {torch.cuda.memory_allocated(device)} bytes "
                f"still allocated once the program's state is freed")
        w = Window(t_open=t_open, t_close=t_close,
                   setup_s=t_open - t_start, records=records,
                   counters={k: c_close[k] - c_open[k] for k in c_open},
                   traffic=traffic, system=sysm, trace=tr, bounds=bounds)
        answered_all = [r for r in records if r["status"] == 200]
        t_check = time.monotonic()
        compares, readings = sysm.check(traffic, answered_all,
                                        control=control)
        log(f"check: {time.monotonic() - t_check:.3f} s")
    finally:
        if gen is not None:
            gen.stop()
        if server is not None:
            server.stop()
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name, entry in names.items():
        v = load_reader(name).read(w)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": entry["unit"]}
    result = {
        "correct": all(c["ok"] for c in compares),
        "attempted": len(w.finished),
        "failed": len(w.failed),
        "metrics": metrics,
        "device": {"count": 1, "memory_peak_bytes": peak},
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["compared"] = {c["name"]: {"value": c["value"],
                                      "limit": c["limit"],
                                      "kind": c["kind"]}
                          for c in compares}
    return {"result": result, "compares": compares, "readings": readings,
            "window": w}


def cache_dirs() -> None:
    """Fixed cache directories inside the checkout, for whatever builds
    kernels at run time (the program's own nvcc builds go to its
    ``_build/``)."""
    base = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
