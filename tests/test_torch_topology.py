"""The port's slice topology and mesh builders against the JAX package's.

``parallel/topology.py`` is a copy: the reference's ``tests/test_topology.py``
cases run here on both modules' ``SliceTopology`` and ``ring_order``
(every case but the device plugin's allocation, an operator plane the port
does not carry), and both modules build the same ``to_dict()`` for every
accelerator name the tables know. ``parallel/mesh.py``'s builders return
the port's mesh, a mapping of axis sizes: it must equal the reference's
``Mesh.shape`` over the 8-device CPU platform, with the reference's ragged
slices error (``tests/test_parallel.py``'s hybrid-mesh cases).
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from dpu_operator_tpu.parallel import mesh as ref_mesh
from dpu_operator_tpu.parallel import topology as ref_topology
from dpu_operator_tpu_torch import parallel as port_parallel
from dpu_operator_tpu_torch.parallel import mesh
from dpu_operator_tpu_torch.parallel import topology

torch.set_num_threads(1)


@pytest.fixture(params=["reference", "port"])
def topo(request):
    return ref_topology if request.param == "reference" else topology


def _env(accel, worker="0", **extra):
    env = {"TPU_ACCELERATOR_TYPE": accel, "TPU_WORKER_ID": worker}
    env.update(extra)
    return env


ACCELS = ["v5litepod-1", "v5litepod-4", "v5litepod-8", "v5litepod-16",
          "v5litepod-32", "v5litepod-64", "v5litepod-128", "v5litepod-256",
          "v4-8", "v4-16", "v4-32", "v4-64", "v4-128", "v4-512", "v5p-128",
          "v5p-4096", "v6e-8"]


@pytest.mark.parametrize("accel", ACCELS)
def test_same_topology_as_reference(accel):
    """Grid, wrap, chips, owners, neighbours and bisection: the copy's
    ``to_dict`` equals the reference's for every table entry, with the
    worker id and the multislice variables set too."""
    env = _env(accel, worker="1", MEGASCALE_SLICE_ID="1",
               MEGASCALE_NUM_SLICES="2")
    want = ref_topology.SliceTopology.from_env(dict(env))
    got = topology.SliceTopology.from_env(dict(env))
    assert got.to_dict() == want.to_dict()
    assert got.bisection_gbps() == want.bisection_gbps()
    for a, b in zip(got.chips, want.chips):
        assert [n.coords for n in got.neighbors(a)] == \
            [n.coords for n in want.neighbors(b)]


def test_package_exports_chip_and_slice_topology():
    assert port_parallel.Chip is topology.Chip
    assert port_parallel.SliceTopology is topology.SliceTopology


# -- the reference's tests/test_topology.py cases, on both modules -------------


@pytest.mark.parametrize("accel,grid", [
    ("v5litepod-4", (2, 2, 1)), ("v5litepod-8", (2, 4, 1)),
    ("v5litepod-16", (4, 4, 1)), ("v5litepod-32", (4, 8, 1)),
    ("v5litepod-64", (8, 8, 1)), ("v5litepod-256", (16, 16, 1))])
def test_v5e_known_grids(topo, accel, grid):
    t = topo.SliceTopology.from_env(_env(accel))
    assert t.grid == grid
    assert t.num_chips == grid[0] * grid[1] * grid[2]


def test_v5e_16_is_square_not_stacked(topo):
    t = topo.SliceTopology.from_env(_env("v5litepod-16"))
    assert t.grid == (4, 4, 1)
    workers = {c.worker for c in t.chips}
    assert workers == {0, 1, 2, 3}
    for w in workers:
        assert sum(1 for c in t.chips if c.worker == w) == 4


def test_wrap_sub_pods_and_full_pod(topo):
    for accel in ("v5litepod-8", "v5litepod-16", "v5litepod-32",
                  "v5litepod-64", "v5litepod-128"):
        assert topo.SliceTopology.from_env(_env(accel)).wrap == \
            (False, False, False), accel
    t = topo.SliceTopology.from_env(_env("v5litepod-256"))
    assert t.wrap == (True, True, False)
    corner = next(c for c in t.chips if c.coords == (0, 0, 0))
    assert {n.coords for n in t.neighbors(corner)} == \
        {(1, 0, 0), (15, 0, 0), (0, 1, 0), (0, 15, 0)}


def test_fallback_halves_tensorcore_names(topo):
    assert topo.SliceTopology.from_env(_env("v5p-4096")).num_chips == 2048


def test_v5e_16_corner_neighbours_mesh_semantics(topo):
    t = topo.SliceTopology.from_env(_env("v5litepod-16"))
    corner = next(c for c in t.chips if c.coords == (0, 0, 0))
    assert {n.coords for n in t.neighbors(corner)} == {(1, 0, 0), (0, 1, 0)}
    center = next(c for c in t.chips if c.coords == (1, 1, 0))
    assert len(t.neighbors(center)) == 4


@pytest.mark.parametrize("accel,grid,wrap", [
    ("v4-8", (2, 2, 1), (False, False, False)),
    ("v4-32", (2, 2, 4), (False, False, True)),
    ("v4-128", (4, 4, 4), (True, True, True)),
    ("v5p-128", (4, 4, 4), (True, True, True))])
def test_v4_family_cubes(topo, accel, grid, wrap):
    t = topo.SliceTopology.from_env(_env(accel))
    assert (t.grid, t.wrap) == (grid, wrap)
    if accel == "v4-128":
        corner = next(c for c in t.chips if c.coords == (0, 0, 0))
        assert len(t.neighbors(corner)) == 6


def test_bisection_v5e_16_vs_32(topo):
    t16 = topo.SliceTopology.from_env(_env("v5litepod-16"))
    t32 = topo.SliceTopology.from_env(_env("v5litepod-32"))
    assert t16.bisection_gbps() == 4 * 400
    assert t32.bisection_gbps() == 4 * 400
    t256 = topo.SliceTopology.from_env(_env("v5litepod-256"))
    assert t256.bisection_gbps() == 16 * 400 * 2


def test_explicit_host_bounds_override_table(topo):
    t = topo.SliceTopology.from_env(_env(
        "v5litepod-16", TPU_HOST_BOUNDS="1,4,1",
        TPU_CHIPS_PER_HOST_BOUNDS="2,2,1"))
    assert t.grid == (2, 8, 1)


def test_multislice_env_parsed(topo):
    base = {"TPU_ACCELERATOR_TYPE": "v5litepod-8",
            "TPU_CHIPS_PER_HOST_BOUNDS": "2,2,1",
            "TPU_HOST_BOUNDS": "1,2,1", "TPU_WORKER_ID": "0"}
    S = topo.SliceTopology

    def ids(**extra):
        t = S.from_env(dict(base, **extra))
        return t.slice_id, t.num_slices

    assert ids() == (0, 1)
    assert ids(MEGASCALE_SLICE_ID="2", MEGASCALE_NUM_SLICES="4") == (2, 4)
    d = S.from_env(dict(base, MEGASCALE_SLICE_ID="2",
                        MEGASCALE_NUM_SLICES="4")).to_dict()
    assert (d["sliceId"], d["numSlices"]) == (2, 4)
    assert ids(MEGASCALE_SLICE_ID="banana", MEGASCALE_NUM_SLICES="") == \
        (0, 1)
    assert ids(TPU_SLICE_ID="1", TPU_NUM_SLICES="2") == (1, 2)
    assert ids(TPU_SLICE_ID="1", TPU_NUM_SLICES="2", MEGASCALE_SLICE_ID="3",
               MEGASCALE_NUM_SLICES="4") == (3, 4)
    assert ids(TPU_SLICE_ID="1", TPU_NUM_SLICES="2",
               MEGASCALE_NUM_SLICES="banana") == (1, 2)
    assert ids(TPU_SLICE_ID="1") == (0, 1)


def test_ring_order_total_deterministic_and_stable(topo):
    addrs = ["10.0.0.3:9411", "10.0.0.1:9411", "10.0.0.2:9411"]
    order = topo.ring_order(addrs)
    assert sorted(order) == sorted(addrs)
    assert order == topo.ring_order(list(addrs))
    addrs = ["10.0.0.2:9500", "10.0.0.10:9500", "127.0.0.1:9001",
             "127.0.0.1:9002"]
    want = topo.ring_order(addrs)
    assert want == ref_topology.ring_order(addrs)
    for perm in itertools.permutations(addrs):
        assert topo.ring_order(list(perm)) == want


def test_ring_order_numeric_ip_not_lexical(topo):
    assert topo.ring_order(["10.0.0.10:1", "10.0.0.2:1"]) == [
        "10.0.0.2:1", "10.0.0.10:1"]
    assert topo.ring_order(["127.0.0.1:9002", "127.0.0.1:9001"]) == [
        "127.0.0.1:9001", "127.0.0.1:9002"]
    assert topo.ring_order(["shard-b:1", "10.9.9.9:1", "shard-a:1"]) == [
        "10.9.9.9:1", "shard-a:1", "shard-b:1"]


def test_ring_order_rejects_duplicate_addresses(topo):
    with pytest.raises(ValueError):
        topo.ring_order(["10.0.0.1:9411", "10.0.0.1:9411"])


# -- the mesh builders ------------------------------------------------------------


class _FakeDev:
    def __init__(self, i, coords=None, slice_index=None):
        self.id = i
        if coords is not None:
            self.coords = coords
        if slice_index is not None:
            self.slice_index = slice_index


def test_order_by_ici_sorts_raster():
    devs = [_FakeDev(i, c) for i, c in enumerate(
        [(1, 3, 0), (0, 0, 0), (1, 0, 0), (0, 3, 0), (0, 1, 0), (1, 1, 0),
         (0, 2, 0), (1, 2, 0)])]
    got = mesh.order_by_ici(devs)
    assert [d.coords for d in got] == [d.coords
                                       for d in ref_mesh.order_by_ici(devs)]
    assert [d.coords for d in got] == [
        (0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
        (0, 2, 0), (1, 2, 0), (0, 3, 0), (1, 3, 0)]
    plain = [_FakeDev(i) for i in (3, 1, 2)]
    assert mesh.order_by_ici(plain) is plain


@pytest.mark.parametrize("accel", ["v5litepod-1", "v5litepod-4",
                                   "v5litepod-8", "v5litepod-16"])
def test_mesh_from_topology_matches_reference(accel):
    """Over the 8 CPU devices (no coords) both fall back to
    ``build_mesh(min(devices, chips))``; with as many devices as chips
    carrying coords the port lays tp along x, sp along y, dp along z,
    the grid shape the reference reshapes its devices to."""
    t = ref_topology.SliceTopology.from_env(_env(accel))
    tp = topology.SliceTopology.from_env(_env(accel))
    devs = jax.devices()
    assert mesh.mesh_from_topology(tp, devs) == \
        dict(ref_mesh.mesh_from_topology(t, devs).shape)
    gx, gy, gz = tp.grid
    coords = [_FakeDev(c.index, c.coords) for c in reversed(tp.chips)]
    assert mesh.mesh_from_topology(tp, coords) == {"dp": gz, "sp": gy,
                                                   "tp": gx}
    assert mesh.mesh_from_topology(tp) == {"dp": 1, "sp": 1, "tp": 1}


@pytest.mark.parametrize("groups", [lambda d: d.id // 4, lambda d: d.id // 2,
                                    lambda d: d.id % 2, lambda d: 0])
def test_build_hybrid_mesh_matches_reference(groups):
    devs = jax.devices()
    assert len(devs) == 8
    want = ref_mesh.build_hybrid_mesh(devs, slice_index_of=groups)
    got = mesh.build_hybrid_mesh(devs, slice_index_of=groups)
    assert list(got) == list(want.axis_names) == ["dcn", "dp", "sp", "tp"]
    assert got == dict(want.shape)


def test_build_hybrid_mesh_ragged_error_and_defaults():
    devs = jax.devices()
    ragged = lambda d: 0 if d.id < 3 else 1  # noqa: E731
    with pytest.raises(ValueError, match="ragged") as want:
        ref_mesh.build_hybrid_mesh(devs, slice_index_of=ragged)
    with pytest.raises(ValueError, match="ragged") as got:
        mesh.build_hybrid_mesh(devs, slice_index_of=ragged)
    assert str(got.value) == str(want.value)
    # ``slice_index`` by default; the one card is one slice of one.
    fake = [_FakeDev(i, slice_index=i // 2) for i in range(8)]
    assert mesh.build_hybrid_mesh(fake) == {"dcn": 4, "dp": 1, "sp": 1,
                                            "tp": 2}
    assert mesh.build_hybrid_mesh() == {"dcn": 1, "dp": 1, "sp": 1, "tp": 1}
    # With a slice topology and coords, each slice is grid-aligned.
    t16 = topology.SliceTopology.from_env(_env("v5litepod-16"))
    grid = [_FakeDev(c.index, c.coords, slice_index=s)
            for s in range(2) for c in t16.chips]
    assert mesh.build_hybrid_mesh(grid, topology=t16) == {
        "dcn": 2, "dp": 1, "sp": 4, "tp": 4}


def test_hybrid_inner_shape_grid_aligned():
    v5e16 = topology.SliceTopology.from_env({
        "TPU_ACCELERATOR_TYPE": "v5litepod-16",
        "TPU_CHIPS_PER_HOST_BOUNDS": "2,2,1", "TPU_HOST_BOUNDS": "2,2,1"})
    ref16 = ref_topology.SliceTopology.from_env({
        "TPU_ACCELERATOR_TYPE": "v5litepod-16",
        "TPU_CHIPS_PER_HOST_BOUNDS": "2,2,1", "TPU_HOST_BOUNDS": "2,2,1"})
    for args in ((16, True), (16, False), (8, True)):
        assert mesh.hybrid_inner_shape(args[0], v5e16, args[1]) == \
            ref_mesh.hybrid_inner_shape(args[0], ref16, args[1])
    assert mesh.hybrid_inner_shape(16, v5e16, True) == (1, 4, 4)
    assert mesh.hybrid_inner_shape(16, None, True) == mesh.axis_sizes(16)
    assert mesh.hybrid_inner_shape(8, v5e16, True) == mesh.axis_sizes(8)


def test_ring_adjacency_on_a_grid_mesh():
    """The port's ``ring_is_ici_adjacent`` over the grid-aligned mesh of a
    2 x 4 slice: tp along x and sp along y are single hops; as the
    reference's test finds, dp over a 2 x 2 x 2 factoring of the same
    chips is not."""
    t8 = topology.SliceTopology.from_env(_env("v5litepod-8"))
    m = mesh.mesh_from_topology(t8, [_FakeDev(c.index, c.coords)
                                     for c in t8.chips])
    assert m == {"dp": 1, "sp": 4, "tp": 2}

    def coords_of(r):
        dp, sp, tp = r
        return (tp, sp, dp)

    assert mesh.ring_is_ici_adjacent(m, "tp", coords_of) is True
    assert mesh.ring_is_ici_adjacent(m, "sp", coords_of) is True
    raster = np.array([c.coords for c in sorted(
        t8.chips, key=lambda c: tuple(reversed(c.coords)))]).reshape(
        2, 2, 2, 3)
    m2 = {"dp": 2, "sp": 2, "tp": 2}
    assert mesh.ring_is_ici_adjacent(
        m2, "dp", lambda r: tuple(raster[r])) is False
    assert mesh.ring_is_ici_adjacent(m2, "tp") is None
