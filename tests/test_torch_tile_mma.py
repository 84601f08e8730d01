"""The tile kernel's tensor-map views (``tile_mma.tma_views``).

The tile kernel of ``csrc/tile_mma.cu`` (the burn tile and the benchmark
matmul) reads x [m, k] and w [k, n] through TMA, as the bf16 collective
matmuls read theirs. The card is the only place the maps are encoded and
read, so these tests hold the views on the CPU: their extents, strides
and boxes, the rules the encoder sets for them, and, by the box emulation
of ``test_torch_collective_matmul.py`` (a TMA box read, zero-filled past
every extent, at the coordinates ``tile::tma_box`` computes), the product
the kernel assembles from them, against ``x.float() @ w.float()``. At the
path's full sizes the emulation covers a few output tiles (the first, a
middle one and the last); at the small sizes, every tile.

The burn chain's kernel reads the same way, x and w through the tile
kernel's views and the previous step's h through one part of a two-part
scratch view (``tile_mma.chain_views``). Its step schedule
(``chain_schedule``, the kernel's rule, which ``test_torch_cuda_build.py``
finds in its source) is checked for the hazards a grid-wide barrier
between steps must cover, and a whole chain is emulated on data: each
step's output tiles are read from the buffers through the views by box
reads, in the kernel's tile order, and stored as soon as they are
computed, so that a schedule that updates a buffer another tile still
reads corrupts the result. It equals ``burn_chain_plain``.

The plain versions' agreement with the reference's Pallas kernels is
``test_torch_burn.py``'s and ``test_torch_mxu_bench.py``'s.
"""

import numpy as np
import pytest
import torch

from dpu_operator_tpu_torch.parallel import burn
from dpu_operator_tpu_torch.parallel import collective_matmul as cm
from dpu_operator_tpu_torch.parallel import tile_mma
from test_torch_burn import CHAIN_ATOL, CHAIN_DIFFER_SHARE, STEP_ULPS
from test_torch_collective_matmul import _emulated_product, _operand_tile

import chip_smoke

torch.set_num_threads(1)

# (m, k, n): the matmul at 4096^3, the burn tile at 2048^2 and 1024 x 2048,
# a product whose k = 96 (3 x 32) ends inside its second K box, and
# chip_smoke's product off the K step and off the 256-wide tile.
SHAPES = [(4096, 4096, 4096), (2048, 2048, 2048), (1024, 2048, 2048),
          (128, 96, 128), chip_smoke.TILE_ODD]
SMALL = [(128, 96, 128), chip_smoke.TILE_ODD, (256, 32, 256)]


def _role_dim(view, role):
    return view.roles.index(role)


def _bf16_exact(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_views_of_the_tile_kernel(m, k, n):
    """x as (k, m, 1): K innermost, rows along the tile axis, one part;
    w as (n, k, 1): columns innermost (read MN-major), K rows, one part.
    The boxes are the wgmma form's: 64 x 128 of x, 64 x 64 of w."""
    views = tile_mma.tma_views(m, k, n)
    assert list(views) == ["x", "w"]
    x, w = views["x"], views["w"]
    assert x == tile_mma.TmaView((k, m, 1), (2 * k, 2 * m * k),
                                 (tile_mma.WG_BK, tile_mma.WG_BM, 1),
                                 (tile_mma.K_AXIS, tile_mma.TILE_AXIS,
                                  tile_mma.PART_AXIS))
    assert w == tile_mma.TmaView((n, k, 1), (2 * n, 2 * k * n),
                                 (tile_mma.WG_PANEL, tile_mma.WG_BK, 1),
                                 (tile_mma.TILE_AXIS, tile_mma.K_AXIS,
                                  tile_mma.PART_AXIS))
    flat = list(tile_mma._views_arg(m, k, n))
    assert flat == list(x.values()) + list(w.values())
    assert len(flat) == 22


def _check_encodable(name, view, k, parts=1):
    """cuTensorMapEncodeTiled's rules for a 128-byte swizzle, and a box
    that is one K step of one of ``parts`` parts."""
    assert all(s % 16 == 0 and s > 0 for s in view.strides), name
    assert view.strides[0] >= view.dims[0] * 2, name
    assert view.strides[1] >= view.strides[0] * view.dims[1], name
    assert all(1 <= b <= 256 for b in view.box), name
    assert view.box[0] * 2 == 128, name
    assert sorted(view.roles) == [tile_mma.K_AXIS, tile_mma.TILE_AXIS,
                                  tile_mma.PART_AXIS], name
    assert view.box[_role_dim(view, tile_mma.K_AXIS)] == tile_mma.WG_BK
    assert view.dims[_role_dim(view, tile_mma.PART_AXIS)] == parts, name
    assert view.box[_role_dim(view, tile_mma.PART_AXIS)] == 1, name
    assert view.dims[_role_dim(view, tile_mma.K_AXIS)] == k, name


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_views_are_maps_the_card_takes(m, k, n):
    """cuTensorMapEncodeTiled's rules for a 128-byte swizzle: global
    strides multiples of 16 bytes, every box dimension 1..256, the inner
    box one 128-byte row; the roles name each axis once, the strides grow
    outwards, and a box is one K step of the one part."""
    for name, view in tile_mma.tma_views(m, k, n).items():
        _check_encodable(name, view, k)


def test_the_collective_matmuls_read_the_same_view_type():
    """One view type and one set of box constants for every bf16 wgmma
    kernel: the collective matmuls import them from ``tile_mma``."""
    assert cm.TmaView is tile_mma.TmaView
    assert (cm.WG_BM, cm.WG_BK, cm.WG_PANEL) == (
        tile_mma.WG_BM, tile_mma.WG_BK, tile_mma.WG_PANEL)
    assert (cm.K_AXIS, cm.TILE_AXIS, cm.PART_AXIS) == (
        tile_mma.K_AXIS, tile_mma.TILE_AXIS, tile_mma.PART_AXIS)


@pytest.mark.parametrize("m,k,n", SMALL)
def test_emulated_product_of_the_views(m, k, n):
    """Every output tile read through the views (x's tile origin: the
    row tile, w's: the panel) equals x @ w; where k is no multiple of 64
    the zero fill past k keeps the tail out."""
    rng = np.random.RandomState(m + k + n)
    x, w = _bf16_exact(rng, (m, k)), _bf16_exact(rng, (k, n))
    views = tile_mma.tma_views(m, k, n)
    got = _emulated_product(x.ravel(), views["x"], 0, 0, w.ravel(),
                            views["w"], 0, m, n, k)
    want = (torch.from_numpy(x).double() @ torch.from_numpy(w).double())
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-9)


def _emulated_tile(x, xv, w, wv, r0, c0, k):
    """One 128 x 64 output tile (rows r0 .., columns c0 ..) as the wgmma
    form assembles it from boxes, K steps of 64 to the end of k."""
    acc = np.zeros((tile_mma.WG_BM, tile_mma.WG_PANEL))
    for k0 in range(0, k, tile_mma.WG_BK):
        a = _operand_tile(x, xv, 0, 0, k0, r0)
        b = _operand_tile(w, wv, 0, 0, k0, c0)
        acc += a.astype(np.float64) @ b.T.astype(np.float64)
    return acc


@pytest.mark.parametrize("m,k,n", SHAPES[:3])
def test_emulated_tiles_at_the_paths_sizes(m, k, n):
    """At the path's full sizes: the first output tile, one in the middle
    and the last, read through the views, equal those tiles of x @ w."""
    rng = np.random.RandomState(7)
    x, w = _bf16_exact(rng, (m, k)), _bf16_exact(rng, (k, n))
    views = tile_mma.tma_views(m, k, n)
    for r0, c0 in ((0, 0), (m // 2, n // 2 + tile_mma.WG_PANEL),
                   (m - tile_mma.WG_BM, n - tile_mma.WG_PANEL)):
        got = _emulated_tile(x.ravel(), views["x"], w.ravel(), views["w"],
                             r0, c0, k)
        want = (x[r0:r0 + tile_mma.WG_BM].astype(np.float64)
                @ w[:, c0:c0 + tile_mma.WG_PANEL].astype(np.float64))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_tile_widths():
    """The tile kernel is built at two widths, and the wrappers launch one
    of them."""
    assert tile_mma.TILE_WIDTHS == (128, 256)
    assert tile_mma.TILE_WIDTH in tile_mma.TILE_WIDTHS


def test_product_of_width_refuses_an_unbuilt_width():
    x = torch.zeros((128, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="built"):
        tile_mma.product_of_width("t", x, x.t().contiguous(), False, 192)


# -- the burn chain ---------------------------------------------------------

# The health path's chain sizes: one tile, an odd number of row tiles, the
# health burn's 1024 and the largest that ``burn.chain_fits``.
CHAIN_SIZES = [128, 384, 1024, 1152]
# The chain kernel's CTA tile, 128 x CHAIN_WIDTH (``kChainWidth``).
CHAIN_WIDTH = 64
# Where a step of the chain reads or writes: x, a part of the [2, n, n]
# scratch, out.
X, OUT = "x", "out"


def chain_schedule(length):
    """``[(read, write)]`` of the chain's ``length`` steps, the kernel's
    rule: step 0 reads x, step i > 0 the part step i - 1 wrote; step i
    writes part i % 2, the last step out. A grid-wide barrier follows
    every step but the last."""
    return [(X if i == 0 else (i - 1) % 2, OUT if i == length - 1 else i % 2)
            for i in range(length)]


@pytest.mark.parametrize("n", CHAIN_SIZES)
def test_chain_views(n):
    """x and w as the tile kernel reads them; the scratch h [2, n, n] as
    x's view with a part extent of 2, its parts n * n elements apart; the
    flat array holds the three in the C entry's order, 11 values each."""
    views = tile_mma.chain_views(n)
    assert list(views) == ["x", "w", "h"]
    tile = tile_mma.tma_views(n, n, n)
    assert views["x"] == tile["x"] and views["w"] == tile["w"]
    assert views["h"] == tile_mma.TmaView(
        (n, n, 2), (2 * n, 2 * n * n), (tile_mma.WG_BK, tile_mma.WG_BM, 1),
        (tile_mma.K_AXIS, tile_mma.TILE_AXIS, tile_mma.PART_AXIS))
    for name, view in views.items():
        _check_encodable(name, view, n, parts=2 if name == "h" else 1)
    flat = list(tile_mma._chain_views_arg(n))
    assert flat == [v for view in views.values() for v in view.values()]
    assert len(flat) == 33
    assert n % CHAIN_WIDTH == 0 and n % tile_mma.WG_BM == 0


def _check_schedule(schedule, length, barriers=None):
    """The hazards of a chain schedule ``[(read, write)]`` whose steps are
    separated by grid-wide barriers after the steps in ``barriers``
    (default: every step but the last, as the kernel has them)."""
    if barriers is None:
        barriers = set(range(length - 1))
    assert len(schedule) == length
    for i, (read, write) in enumerate(schedule):
        assert read != write, f"step {i} reads the part it writes"
        assert read in (X, 0, 1) and write in (OUT, 0, 1), (i, read, write)
        assert (write == OUT) == (i == length - 1), (
            f"step {i} writes {write}: only the last step writes out")
        want = X if i == 0 else schedule[i - 1][1]
        assert read == want, f"step {i} reads {read}, not {want}"
    # Step b writing what step a < b reads, or reading what it writes,
    # needs a barrier between them: no part is written at step i + 2
    # while step i + 1 still reads it.
    for a, (read_a, write_a) in enumerate(schedule):
        for b in range(a + 1, length):
            read_b, write_b = schedule[b]
            if write_b == read_a or read_b == write_a:
                assert any(a <= j < b for j in barriers), (
                    f"steps {a} and {b} share a part with no barrier")


@pytest.mark.parametrize("length", range(1, 10))
def test_chain_schedule(length):
    """Step 0 reads x, each later step the part the step before wrote;
    the parts alternate, the last step writes out, and every hazard has a
    barrier between its steps."""
    schedule = chain_schedule(length)
    _check_schedule(schedule, length)
    assert [w for _, w in schedule[:-1]] == [i % 2 for i in range(length - 1)]


def _in_place(length):
    """A schedule that updates one buffer in place."""
    return [(X, 0)] + [(0, 0)] * (length - 2) + [(0, OUT)]


def _no_alternation(length):
    """A schedule whose writes alternate and whose reads do not follow."""
    return [(X, 0)] + [(0, i % 2) for i in range(1, length - 1)] + [(0, OUT)]


@pytest.mark.parametrize("length", [3, 4, 8, 9])
@pytest.mark.parametrize("mutation", ["in_place", "no_alternation",
                                      "a_barrier_dropped"])
def test_mutated_schedules_fail_the_check(length, mutation):
    """Reading the part a step writes, reads that no longer follow the
    writes, or a barrier left out between two steps that share a part:
    each fails the check."""
    barriers = None
    if mutation == "in_place":
        schedule = _in_place(length)
    elif mutation == "no_alternation":
        schedule = _no_alternation(length)
    else:
        schedule = chain_schedule(length)
        barriers = set(range(length - 1)) - {length // 2}
    with pytest.raises(AssertionError):
        _check_schedule(schedule, length, barriers)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _emulated_chain(x, w, schedule, check_products=True):
    """The chain as the kernel runs it, one CTA after another: each step's
    128 x CHAIN_WIDTH output tiles in the kernel's tile order, each
    assembled from box reads through ``chain_views`` (the A operand: x's
    view at step 0, else the scratch view's part the schedule names; B:
    w's 64-column panels; K steps of 64), its float64 sum rounded to f32,
    through tanh, rounded to bf16 and stored at once into the part the
    schedule names, or out. Where ``check_products``, every tile's sum is
    checked against the float64 product of the buffer as it stood at the
    step's start."""
    n = x.shape[0]
    views = tile_mma.chain_views(n)
    x_flat, w_flat = x.ravel(), w.ravel()
    scratch = np.zeros(2 * n * n, np.float32)
    out = np.zeros((n, n), np.float32)
    bm, bn, panel = tile_mma.WG_BM, CHAIN_WIDTH, tile_mma.WG_PANEL
    for read, write in schedule:
        flat, view, part = ((x_flat, views["x"], 0) if read == X
                            else (scratch, views["h"], read))
        before = flat.reshape(-1, n, n)[part].astype(np.float64)
        for t in range(n // bm * (n // bn)):
            r0, c0 = t // (n // bn) * bm, t % (n // bn) * bn
            acc = np.zeros((bm, bn))
            for k0 in range(0, n, tile_mma.WG_BK):
                a = _operand_tile(flat, view, part, 0, k0, r0)
                for p in range(0, bn, panel):
                    b = _operand_tile(w_flat, views["w"], 0, 0, k0, c0 + p)
                    acc[:, p:p + panel] += (a.astype(np.float64)
                                            @ b.T.astype(np.float64))
            if check_products:
                want = before[r0:r0 + bm] @ w[:, c0:c0 + bn].astype(
                    np.float64)
                np.testing.assert_allclose(acc, want, rtol=1e-12, atol=1e-9)
            tile = _bf16(np.tanh(acc.astype(np.float32)))
            dst = out if write == OUT else scratch.reshape(2, n, n)[write]
            dst[r0:r0 + bm, c0:c0 + bn] = tile
    return out


def _chain_inputs(n, seed):
    """The burn's inputs at n: x ~ N(0, 1), w ~ N(0, 0.05^2), bf16."""
    rng = np.random.RandomState(seed)
    return _bf16(rng.randn(n, n)), _bf16(rng.randn(n, n) * 0.05)


def _against_plain(got, x, w, length):
    """(max |err|, share differing, ulps) of an emulated chain against
    ``burn_chain_plain`` on the same inputs."""
    want = burn.burn_chain_plain(torch.from_numpy(x), torch.from_numpy(w),
                                 length)
    got = torch.from_numpy(got)
    return (float((got - want.float()).abs().max()),
            float((got != want.float()).float().mean()),
            burn.bf16_ulps(got.to(torch.bfloat16), want))


@pytest.mark.parametrize("n", [128, 384])
@pytest.mark.parametrize("length", [1, 2, 3, 8])
def test_emulated_chain_equals_plain(n, length):
    """The chain read through its views by the kernel's schedule, tile by
    tile, equals ``burn_chain_plain`` within ``test_torch_burn.py``'s
    chain bar (one step: 1 ulp)."""
    x, w = _chain_inputs(n, seed=n + length)
    got = _emulated_chain(x, w, chain_schedule(length))
    err, differ, ulps = _against_plain(got, x, w, length)
    if length == 1:
        assert ulps <= STEP_ULPS
    else:
        assert err <= CHAIN_ATOL
    assert differ <= CHAIN_DIFFER_SHARE
    assert not np.array_equal(got, x)


@pytest.mark.parametrize("length", [3, 8])
def test_emulated_chain_in_place_corrupts(length):
    """Updating one buffer in place, a tile reads rows that an earlier
    tile of the same step has already overwritten: the tile products no
    longer equal those of the step's input, and the chain misses the
    plain version's bar."""
    x, w = _chain_inputs(128, seed=length)
    with pytest.raises(AssertionError):
        _emulated_chain(x, w, _in_place(length))
    got = _emulated_chain(x, w, _in_place(length), check_products=False)
    err, _, _ = _against_plain(got, x, w, length)
    assert err > CHAIN_ATOL
