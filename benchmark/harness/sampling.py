"""The answers the reference judges: a sample drawn from the seed."""

from __future__ import annotations

from typing import Callable, List

import numpy as np


def sample_answers(answered: List[dict], seed: int, k: int,
                   size: Callable[[dict], int]) -> List[dict]:
    """The largest answer by ``size`` and ``k - 1`` others drawn from the
    seed, in the order they were sent."""
    if not answered:
        return []
    ordered = sorted(answered, key=lambda r: r["i"])
    big = max(range(len(ordered)), key=lambda j: (size(ordered[j]), -j))
    rest = [j for j in range(len(ordered)) if j != big]
    rng = np.random.default_rng([int(seed), 5])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    chosen = sorted([big] + [rest[int(j)] for j in pick])
    return [ordered[j] for j in chosen]
