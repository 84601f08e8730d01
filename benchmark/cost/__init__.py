"""Operations and bytes of the kernels and of the models, from shapes.

Each function is the benchmark's own copy, so that a change to the
program cannot change the yardstick. ``peaks.json`` beside this file holds
the card's peaks the shares are taken against.
"""

import json
from pathlib import Path

#: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the TF32 peak and the bytes over the HBM peak."""
    return max(flops / PEAKS["tf32_flop_per_s"],
               nbytes / PEAKS["hbm_bytes_per_s"])
