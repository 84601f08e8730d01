"""The control of ``correct``: the reference in the precision below the
configuration's, read beside the program's own numbers.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 10

For each seed, in one process, runs the cell as ``run.py`` does (the
window, then the check) and also reads the control: at each compared
position, the gap under the float32 reference of the token that the
reference computed with TF32 matmuls puts first. Prints one JSON line a
seed: the run's numbers compared beside their limits, and the control's
reading with ``control_correct``, the same comparison with the control's
tokens in the program's place, which has to read false. The benchmark's own runs never run the control. Runs on the card
only.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    from harness.core import cache_dirs, run_cell
    from harness.spec import load_cell
    from run import card
    cache_dirs()
    cell = load_cell(args.workload)
    name = card(cell.chips)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        out = run_cell(cell, seed, args.seconds, False, t_start=t0,
                       control=True)
        res = out["result"]
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "card": name, "correct": res["correct"],
                          "answered": len(out["window"].answered),
                          "compared": res["compared"],
                          "control": out["readings"],
                          "metrics": res["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
