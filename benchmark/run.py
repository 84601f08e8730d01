"""The benchmark of ``dpu_operator_tpu_torch``: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Starts one ``ServingServer`` in this process over the cell's executor on
the card, a load generator in a child process, and drives
``POST /v1/generate`` for ``--seconds`` after set-up. Prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics with ``--trace 1``), ``device`` and, with
``--trace 1``, ``breakdown``; last of all ``compared``, each number the
run compared with the plain reference beside its limit, which also end
its standard error. Exits non-zero, printing no result, without a CUDA
card or with fewer than the cell needs, when the program cannot be
imported, or when ``jax``, ``jaxlib``, ``flax`` or the JAX package is
loaded once the window has closed.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

#: Top-level module names that must not be loaded, compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "dpu_operator_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card(chips: int):
    """(name, count) of the card, or exit without one."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the benchmark runs on the card only")
    n = torch.cuda.device_count()
    if n < chips:
        sys.exit(f"the cell needs {chips} CUDA devices, found {n}")
    return torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    from harness.core import cache_dirs, run_cell
    from harness.spec import load_cell
    cache_dirs()
    cell = load_cell(args.workload)
    name = card(cell.chips)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START)
    bad = forbidden_modules()
    if bad:
        sys.exit(f"loaded after the window: {', '.join(bad)}")
    result = out["result"]
    # Replaced in place: ``compared`` stays the last key.
    result["device"] = {"platform": "gpu", "kind": name, **result["device"]}
    for c in out["compares"]:
        sign = "<=" if c["kind"] == "at_most" else ">="
        print(f"{c['name']} {c['value']!r} {sign} limit {c['limit']!r}"
              f" {'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
