"""Mesh axes of the port.

The port's copy of what its slices need from the JAX package's
``parallel/mesh.py``: the axis names and the factoring of a device count
onto them, statement for statement; ``build_mesh`` and
``ring_is_ici_adjacent``, rewritten for the port's mesh, which is a
mapping of axis names to sizes (``{"dp": 2, "sp": 2, "tp": 2}``) whose
ranks are tuples of coordinates, one per axis, all stacked on one card.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

AXES = ("dp", "sp", "tp")  # data / sequence(ring) / tensor axes


def axis_sizes(n_devices: int) -> Tuple[int, int, int]:
    """Factor n devices onto (dp, sp, tp), preferring to populate tp then
    sp so collectives exercise more than one dimension whenever possible
    (8 -> 2x2x2, 4 -> 1x2x2, 2 -> 1x1x2, 1 -> 1x1x1)."""
    tp = 2 if n_devices % 2 == 0 else 1
    rest = n_devices // tp
    sp = 2 if rest % 2 == 0 and rest >= 2 else 1
    dp = rest // sp
    assert dp * sp * tp == n_devices
    return dp, sp, tp


def build_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None) -> Dict[str, int]:
    """The (dp, sp, tp) mesh over n ranks, ``axis_sizes(n)`` under
    ``AXES``: n is ``n_devices``, else ``len(devices)``, else 1 (the one
    card). The ranks share one card, so ``devices`` is only counted: it
    must hold at least ``n_devices`` entries. A GPU has no ICI
    coordinates to order them by."""
    if devices is not None and n_devices is not None \
            and len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    if n_devices is None:
        n_devices = 1 if devices is None else len(devices)
    return dict(zip(AXES, axis_sizes(n_devices)))


def ring_is_ici_adjacent(
        mesh: Mapping[str, int], axis: str,
        coords_of: Optional[Callable[[Tuple[int, ...]],
                                     Optional[Sequence[int]]]] = None
) -> Optional[bool]:
    """Whether consecutive ranks along ``axis`` sit on physically
    adjacent chips (so a ring over the axis rides single hops). Only
    open-chain hops are checked: the closing hop of a ring is a wrap
    link, which coordinates alone cannot vouch for. ``coords_of`` maps a
    rank's mesh coordinates to its chip's physical coordinates or None.
    Returns None when ranks carry no physical coordinates, which is
    always so without ``coords_of``: ranks that share one card have
    none."""
    if coords_of is None:
        return None
    names = list(mesh)
    ax = names.index(axis)
    ranks = list(itertools.product(*(range(int(mesh[a])) for a in names)))
    if not all(coords_of(r) is not None for r in ranks):
        return None
    for r in ranks:
        if r[ax] + 1 >= int(mesh[axis]):
            continue
        nxt = r[:ax] + (r[ax] + 1,) + r[ax + 1:]
        hop = sum(abs(a - b) for a, b in zip(coords_of(r), coords_of(nxt)))
        if hop != 1:
            return False
    return True
