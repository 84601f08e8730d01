"""The control on the card, at a size a test run holds: the program's
served tokens pass each configuration's limits, and the TF32 reference's
tokens, put in the program's place at the same positions, fail them.
Skips without a card; on the card:

    python -m pytest benchmark/tests/test_benchmark_control.py

At the cells' own sizes the same comparison is ``benchmark/control.py``.
"""

import copy
import time

import pytest

from conftest import SEED, load_cell, load_traffic


def paged_small():
    cell = load_cell("paged-olmo17-7b.longctx")
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(vocab_size=8192)
    cfg["serving"]["vocab"] = 8192
    cfg["executor_args"].update(max_blocks_per_req=64, num_blocks=4096)
    cell.config = cfg
    cell.traffic = dict(load_traffic("chat"),
                        max_tokens={"dist": "uniform", "lo": 64, "hi": 256},
                        prompt_len={"dist": "loguniform", "lo": 32,
                                    "hi": 512})
    return cell


def rows_small():
    cell = load_cell("rows-mixtral-8x7b.decode")
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(num_hidden_layers=2)
    cell.config = cfg
    return cell


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
@pytest.mark.parametrize("make", [paged_small, rows_small])
def test_tf32_control_fails_where_the_program_passes(card, make, seed):
    from harness.core import run_cell
    out = run_cell(make(), seed, 4.0, False, t_start=time.monotonic(),
                   control=True)
    assert out["result"]["correct"], out["result"]["compared"]
    assert out["readings"]["control_correct"] is False, out["readings"]
