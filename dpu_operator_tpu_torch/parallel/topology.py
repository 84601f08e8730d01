"""SliceTopology — the ICI fabric model of a TPU slice.

Built from the TPU-VM runtime environment (TPU_ACCELERATOR_TYPE,
TPU_CHIPS_PER_HOST_BOUNDS, TPU_HOST_BOUNDS, TPU_WORKER_ID) the same way
the reference's platform layer reads DMI/PCI (internal/platform/ipu.go),
and optionally from a live JAX backend. The topology feeds three
consumers: the tpuvsp's GetDevices (chips + ICI links as allocatable
endpoints), the device-plugin NUMA/locality hints, and the JAX mesh
construction in parallel.mesh.

ICI model: chips form a grid (torus on wrap dims for pods); each chip
links to its grid neighbours. v5e: 4 chips/host in a 2x2, 400 Gbps/dir
per link; a v5litepod-8 is 2 hosts = 2x4 grid."""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

DEFAULT_LINK_GBPS = 400  # v5e ICI per-direction per-link

# Known slice shapes (chip grids), from the public accelerator docs.
# v5e: 2D mesh of 4-chip (2x2) hosts; the full 16x16 pod is a 2D torus.
# A v5litepod-16 is 4x4 — NOT 2x8 — which changes neighbour lists,
# bisection, and allocation locality.
V5E_GRIDS: Dict[int, Tuple[int, int, int]] = {
    1: (1, 1, 1),
    4: (2, 2, 1),
    8: (2, 4, 1),
    16: (4, 4, 1),
    32: (4, 8, 1),
    64: (8, 8, 1),
    128: (8, 16, 1),
    256: (16, 16, 1),
}

# v4/v5p: 3D slices of 4-chip hosts (2x2x1); the accelerator suffix counts
# TensorCores (2 per chip), so v4-128 = 64 chips = a 4x4x4 cube. Dims that
# are multiples of 4 close into a torus through the optical switches.
# Keyed by CHIP count — loookups halve the name's TensorCore suffix.
V4_GRIDS: Dict[int, Tuple[int, int, int]] = {
    4: (2, 2, 1),
    8: (2, 2, 2),
    16: (2, 2, 4),
    32: (2, 4, 4),
    64: (4, 4, 4),
    128: (4, 4, 8),
    256: (4, 8, 8),
    512: (8, 8, 8),
    1024: (8, 8, 16),
}


@dataclass(frozen=True)
class Chip:
    index: int  # global chip index within the slice
    coords: Tuple[int, int, int]
    worker: int  # host/worker id owning this chip
    numa_node: int = 0

    @property
    def coords_str(self) -> str:
        return ",".join(str(c) for c in self.coords)


@dataclass
class SliceTopology:
    accelerator_type: str
    chips: List[Chip]
    grid: Tuple[int, int, int]
    worker_id: int
    wrap: Tuple[bool, bool, bool] = (False, False, False)
    # Multislice (MEGASCALE): which DCN-connected slice this is, out of
    # how many. Single-slice deployments are (0, 1). The chips/grid
    # above always describe ONE slice — DCN peers are reached through
    # the hybrid mesh (mesh.build_hybrid_mesh), never through ICI
    # neighbor arithmetic.
    slice_id: int = 0
    num_slices: int = 1

    # -- construction --------------------------------------------------------

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "SliceTopology":
        env = dict(env if env is not None else os.environ)
        accel = env.get("TPU_ACCELERATOR_TYPE", "")
        worker = _int_env(env, "TPU_WORKER_ID", 0)
        chips_per_host = _parse_bounds(env.get("TPU_CHIPS_PER_HOST_BOUNDS"), (2, 2, 1))
        host_bounds = _parse_bounds(env.get("TPU_HOST_BOUNDS"), None)
        if host_bounds is not None:
            # Runtime-provided bounds win (they describe the actual slice).
            grid = tuple(c * h for c, h in zip(chips_per_host, host_bounds))
        else:
            grid = _grid_for_accelerator(accel)
            if grid is None:
                # Unknown family/size: stack hosts along y as a last resort.
                grid = tuple(
                    c * h
                    for c, h in zip(
                        chips_per_host, _fallback_host_bounds(accel, chips_per_host)
                    )
                )
            host_bounds = tuple(
                max(1, g // c) for g, c in zip(grid, chips_per_host)
            )
        chips = []
        idx = 0
        for z in range(grid[2]):
            for y in range(grid[1]):
                for x in range(grid[0]):
                    w = _owner_worker((x, y, z), chips_per_host, host_bounds)
                    chips.append(
                        Chip(index=idx, coords=(x, y, z), worker=w, numa_node=0)
                    )
                    idx += 1
        wrap = _wrap_for(accel, grid)
        return cls(
            accelerator_type=accel,
            chips=chips,
            grid=grid,  # type: ignore[arg-type]
            worker_id=worker,
            wrap=wrap,  # type: ignore[arg-type]
            # Multislice runtime env: the GCE metadata pair
            # (MEGASCALE_*) wins when present, else the operator's
            # Allocate grant (TPU_SLICE_ID/TPU_NUM_SLICES,
            # device_plugin.Allocate) — a pod granted chips by the
            # operator builds the right hybrid mesh from its own env,
            # no metadata scraping. The pair is picked ATOMICALLY
            # (mixing sources could yield slice_id >= num_slices);
            # absent or junk values read as the single-slice default —
            # a malformed value must not take the topology model down.
            **_slice_identity(env),
        )

    @classmethod
    def single_chip(cls, accel: str = "single") -> "SliceTopology":
        return cls(
            accelerator_type=accel,
            chips=[Chip(0, (0, 0, 0), 0)],
            grid=(1, 1, 1),
            worker_id=0,
        )

    # -- queries -------------------------------------------------------------

    @property
    def num_chips(self) -> int:
        return len(self.chips)

    def local_chips(self) -> List[Chip]:
        """Chips attached to this worker (what GetDevices advertises)."""
        return [c for c in self.chips if c.worker == self.worker_id]

    def neighbors(self, chip: Chip) -> List[Chip]:
        """ICI neighbours in the (possibly wrapped) grid."""
        by_coords = {c.coords: c for c in self.chips}
        out = []
        for dim in range(3):
            if self.grid[dim] == 1:
                continue
            for delta in (-1, 1):
                coords = list(chip.coords)
                coords[dim] += delta
                if self.wrap[dim]:
                    coords[dim] %= self.grid[dim]
                elif not (0 <= coords[dim] < self.grid[dim]):
                    continue
                n = by_coords.get(tuple(coords))
                if n is not None and n.index != chip.index:
                    out.append(n)
        return out

    def bisection_gbps(self) -> int:
        """Cross-sectional ICI bandwidth across the largest dim — the
        number the traffic-flow harness sanity-checks against."""
        dims = [d for d in range(3) if self.grid[d] > 1]
        if not dims:
            return 0
        cut_dim = max(dims, key=lambda d: self.grid[d])
        links = 1
        for d in range(3):
            if d != cut_dim:
                links *= self.grid[d]
        if self.wrap[cut_dim]:
            links *= 2
        return links * DEFAULT_LINK_GBPS

    def to_dict(self) -> dict:
        return {
            "acceleratorType": self.accelerator_type,
            "grid": list(self.grid),
            "workerId": self.worker_id,
            "numChips": self.num_chips,
            "bisectionGbps": self.bisection_gbps(),
            "sliceId": self.slice_id,
            "numSlices": self.num_slices,
        }


# -- ring-order selection (sharded serving replicas) -------------------------


def _ring_sort_key(addr: str):
    """Canonical sort key for one rendezvous address ("ip" or
    "ip:port" or "host:port"): numeric IPv4 octets when the host
    parses as dotted-quad (so 10.0.0.2 orders before 10.0.0.10 —
    lexical order would interleave hosts across racks), else the
    host string; port breaks ties for several shards on one host."""
    host, _, port = str(addr).partition(":")
    octets = host.split(".")
    if len(octets) == 4 and all(o.isdigit() and int(o) < 256
                                for o in octets):
        hkey = (0, tuple(int(o) for o in octets))
    else:
        hkey = (1, host)
    return (hkey, int(port) if port.isdigit() else 0, port)


def ring_order(addresses) -> List[str]:
    """Deterministic TOTAL order over a shard set's rendezvous
    addresses — the ring the FabricExecutor coordinator wires its
    shard workers into (each rank dials the next entry, wrapping).

    Contract (tests/test_topology.py): the result contains every
    input exactly once (total), is identical across runs
    (deterministic), and is STABLE UNDER PERMUTATION of the input —
    two coordinators (or a coordinator and the supervisor restarting
    it) that discover the same shard set in different orders must
    still agree on the ring, or the re-rendezvoused replica would
    deadlock dialing a neighbour that is dialing someone else.
    Duplicate addresses are rejected: two shards cannot share a
    rendezvous endpoint, and silently deduping would shrink the
    world size."""
    addrs = [str(a) for a in addresses]
    if len(set(addrs)) != len(addrs):
        dupes = sorted({a for a in addrs if addrs.count(a) > 1})
        raise ValueError(f"duplicate shard rendezvous addresses: "
                         f"{dupes}")
    return sorted(addrs, key=_ring_sort_key)


# -- helpers -----------------------------------------------------------------


def _int_env(env: Dict[str, str], key: str, default: int) -> int:
    try:
        return int(env.get(key) or default)
    except (TypeError, ValueError):
        return default


def _slice_identity(env: Dict[str, str]) -> Dict[str, int]:
    """One SOURCE per identity, and only a VALID one: the MEGASCALE_*
    pair (the runtime's own view) wins when it parses to a consistent
    identity, else the operator's TPU_* grant pair, else single-slice.
    Validity means 0 <= slice_id < num_slices — a junk metadata value
    must neither mask a valid operator grant nor produce the
    out-of-range identity this function exists to prevent."""
    def _parse_pair(prefix):
        raw_sid = env.get(prefix + "SLICE_ID")
        raw_n = env.get(prefix + "NUM_SLICES")
        if raw_sid is None and raw_n is None:
            return None  # source absent
        try:
            sid = int(raw_sid) if raw_sid is not None else 0
            n = int(raw_n) if raw_n is not None else 1
        except (TypeError, ValueError):
            return None  # a SET key that doesn't parse poisons the pair
        return (sid, n) if 0 <= sid < n else None

    for prefix in ("MEGASCALE_", "TPU_"):
        pair = _parse_pair(prefix)
        if pair is not None:
            return {"slice_id": pair[0], "num_slices": pair[1]}
    return {"slice_id": 0, "num_slices": 1}


def _parse_bounds(value: Optional[str], default):
    if not value:
        return default
    parts = [int(p) for p in re.split(r"[,x]", value.strip()) if p]
    while len(parts) < 3:
        parts.append(1)
    return tuple(parts[:3])


def _accel_family_and_count(accel: str) -> Tuple[str, int]:
    m = re.match(r"([a-z0-9]+?)(?:pod)?-(\d+)$", (accel or "").strip().lower())
    if not m:
        return ("", 0)
    return (m.group(1), int(m.group(2)))


def _grid_for_accelerator(accel: str) -> Optional[Tuple[int, int, int]]:
    """Known-shapes lookup. v5e names count chips; v4/v5p names count
    TensorCores (2 per chip) and use the same cube progression."""
    family, count = _accel_family_and_count(accel)
    if family in ("v5lite", "v5e", "v6e"):
        return V5E_GRIDS.get(count)
    if family in ("v4", "v5p", "v5"):
        return V4_GRIDS.get(count // 2)
    return None


def _fallback_host_bounds(accel: str, chips_per_host) -> Tuple[int, int, int]:
    """Last-resort inference for shapes outside the table: hosts stacked
    along y (correct only for 1- and 2-host slices)."""
    family, count = _accel_family_and_count(accel)
    if not count:
        return (1, 1, 1)
    if family in ("v4", "v5p", "v5"):
        count //= 2  # those names count TensorCores, not chips
    per_host = chips_per_host[0] * chips_per_host[1] * chips_per_host[2]
    hosts = max(1, count // per_host)
    return (1, hosts, 1)


def _wrap_for(accel: str, grid) -> Tuple[bool, bool, bool]:
    """Torus closure per family: v5e is a torus ONLY as the full 16x16
    pod (an 8x16 sub-pod has no wrap links even on its 16-long dim);
    v4/v5p dims that are multiples of 4 close through the optical
    switches. Unknown families get a plain mesh (no wrap) — the
    conservative answer for bandwidth claims."""
    family, _ = _accel_family_and_count(accel)
    if family in ("v5lite", "v5e", "v6e"):
        full_pod = grid[0] == 16 and grid[1] == 16
        return (full_pod, full_pod, False)
    if family in ("v4", "v5p", "v5"):
        return tuple(g >= 4 and g % 4 == 0 for g in grid)  # type: ignore[return-value]
    return (False, False, False)


def _owner_worker(coords, chips_per_host, host_bounds) -> int:
    hx = coords[0] // chips_per_host[0]
    hy = coords[1] // chips_per_host[1]
    hz = coords[2] // chips_per_host[2]
    return hz * host_bounds[0] * host_bounds[1] + hy * host_bounds[0] + hx
