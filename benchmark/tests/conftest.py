"""Small cells for the benchmark's CPU tests.

The cells are the committed ones, with the configuration cut to a size the
CPU runs in seconds and the device set to the CPU; the harness itself,
the load generator's child process and the references run unchanged.
"""

import copy
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.spec import load_cell, load_traffic  # noqa: E402

#: A seed above 32 bits, as the driver's are.
SEED = 2 ** 32 + 12345


def tiny_paged(traffic: str = "chat"):
    """The paged cell under the mix ``traffic`` (a file of
    ``benchmark/traffic/``, whether a cell runs it or not)."""
    cell = load_cell("paged-olmo17-7b.longctx")
    cell.traffic = load_traffic(traffic)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(hidden_size=64, num_attention_heads=4,
                        vocab_size=256, mlp_width=128)
    cfg["executor_args"].update(slots=4, block_size=4,
                                max_blocks_per_req=64, num_blocks=1024,
                                prefill_chunk=4, prefill_budget=16)
    cfg["serving"]["vocab"] = 256
    cfg["correct"].update(min_tokens=16, sample=4)
    cell.config = cfg
    mix = dict(cell.traffic, clients=8,
               prompt_len={"dist": "loguniform", "lo": 4, "hi": 40},
               max_tokens={"dist": "uniform", "lo": 4, "hi": 40})
    if "shared_prefix" in mix:
        mix["shared_prefix"] = {"count": 2, "len": 32}
    cell.traffic = mix
    return cell


def tiny_rows():
    cell = load_cell("rows-mixtral-8x7b.decode")
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(hidden_size=64, intermediate_size=128,
                        num_local_experts=2, num_hidden_layers=2)
    cfg["executor_args"].update(mesh={"ep": 2}, slots=4)
    cfg["correct"].update(min_tokens=8, sample=8)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, clients=8,
                        max_tokens={"dist": "uniform", "lo": 4, "hi": 24})
    return cell


def run_tiny(cell, seconds: float = 2.0, trace: bool = False,
             control: bool = False, seed: int = SEED):
    from harness.core import run_cell
    return run_cell(cell, seed, seconds, trace, t_start=time.monotonic(),
                    device="cpu", kernel="torch", control=control)


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided inside the test, never while the
    module is imported."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)
