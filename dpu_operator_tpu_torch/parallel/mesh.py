"""Mesh axes of the port.

The port's copy of what its slices need from the JAX package's
``parallel/mesh.py``: the axis names, the factoring of a device count
onto them, the ICI raster order of devices that carry chip coordinates
(``order_by_ici``) and the hybrid mesh's per-slice factoring
(``hybrid_inner_shape``), statement for statement; ``build_mesh``,
``mesh_from_topology``, ``build_hybrid_mesh`` and
``ring_is_ici_adjacent``, rewritten for the port's mesh, which is a
mapping of axis names to sizes (``{"dp": 2, "sp": 2, "tp": 2}``) whose
ranks are tuples of coordinates, one per axis, all stacked on one card.
A GPU device carries no ICI coordinates, so the card keeps enumeration
order, as the reference does on the CPU.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

from .topology import SliceTopology

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


def order_by_ici(devices: Sequence) -> Sequence:
    """Devices in (z, y, x) raster order of their physical chip coords.

    TPU devices expose `device.coords`; sorting into grid raster order
    before factoring keeps each mesh axis contiguous along a physical
    grid dim so a collective over an axis rides one ICI dimension (a
    ring built on enumeration order may hop non-adjacent chips).
    Devices without coords (a GPU, the CPU) keep their enumeration
    order — there is no fabric to align with."""
    if all(getattr(d, "coords", None) is not None for d in devices):
        return sorted(devices, key=lambda d: tuple(reversed(d.coords)))
    return devices


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


def mesh_from_topology(topology: SliceTopology,
                       devices: Optional[Sequence] = None) -> Dict[str, int]:
    """The (dp, sp, tp) mesh laid out so that mesh coordinates track the
    ICI grid's: when the device count matches the slice and every device
    carries ``.coords``, tp runs along x, sp along y and dp along z
    (``{"dp": gz, "sp": gy, "tp": gx}``), so every axis step is one hop.
    Otherwise ``build_mesh`` over the first min(devices, chips) devices.
    ``devices`` None means the one card."""
    if devices is None:
        devices = ("cuda",)  # the one card: no chip coordinates
    devices = order_by_ici(devices)
    n = min(len(devices), topology.num_chips) or len(devices)
    if n == topology.num_chips and all(
        getattr(d, "coords", None) is not None for d in devices[:n]
    ):
        gx, gy, gz = topology.grid
        return dict(zip(AXES, (gz, gy, gx)))
    return build_mesh(n_devices=n, devices=devices)


def build_hybrid_mesh(devices: Optional[Sequence] = None,
                      slice_index_of: Optional[Callable] = None,
                      topology: Optional[SliceTopology] = None
                      ) -> Dict[str, int]:
    """The multislice hybrid mesh ``{"dcn": slices, "dp", "sp", "tp"}``,
    the DCN axis outermost: collectives over ``dcn`` cross slices, every
    inner axis stays within one. Devices are grouped by
    ``slice_index_of(device)`` (default: their ``slice_index``, else 0);
    every slice must hold the same count, or it raises the reference's
    "ragged slices" error. The inner axes are
    ``hybrid_inner_shape(per_slice, topology, have_coords)``. ``devices``
    None means the one card."""
    if devices is None:
        devices = ("cuda",)  # the one card: no slice index
    if slice_index_of is None:
        def slice_index_of(d):
            return getattr(d, "slice_index", 0) or 0

    groups: dict = {}
    for d in devices:
        groups.setdefault(slice_index_of(d), []).append(d)
    sizes = {len(v) for v in groups.values()}
    if len(sizes) != 1:
        raise ValueError(
            f"ragged slices: {sorted((k, len(v)) for k, v in groups.items())}"
        )
    per_slice = sizes.pop()
    have_coords = all(
        getattr(d, "coords", None) is not None
        for g in groups.values() for d in g
    )
    shape = hybrid_inner_shape(per_slice, topology, have_coords)
    return dict(zip(("dcn",) + AXES, (len(groups),) + tuple(shape)))


def hybrid_inner_shape(
    per_slice: int,
    topology: Optional[SliceTopology],
    have_coords: bool,
) -> Tuple[int, int, int]:
    """Per-slice (dp, sp, tp) factoring for the hybrid mesh:
    grid-aligned when the slice topology is known, matches the device
    count, and devices carry physical coords (tp along x, sp along y,
    dp along z — every inner-axis step a single ICI hop, same reasoning
    as mesh_from_topology); the generic 2x2-preferring factoring
    otherwise. On real slices wider than 2 the generic factoring strides
    non-adjacent chips, so callers with a SliceTopology should pass it."""
    if (
        topology is not None
        and per_slice == topology.num_chips
        and have_coords
    ):
        gx, gy, gz = topology.grid
        return (gz, gy, gx)
    return axis_sizes(per_slice)


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
