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

The plain versions' agreement with the reference's Pallas kernels is
``test_torch_burn.py``'s and ``test_torch_mxu_bench.py``'s.
"""

import numpy as np
import pytest
import torch

from dpu_operator_tpu_torch.parallel import collective_matmul as cm
from dpu_operator_tpu_torch.parallel import tile_mma
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


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_views_are_maps_the_card_takes(m, k, n):
    """cuTensorMapEncodeTiled's rules for a 128-byte swizzle: global
    strides multiples of 16 bytes, every box dimension 1..256, the inner
    box one 128-byte row; the roles name each axis once, the strides grow
    outwards, and a box is one K step of the one part."""
    for name, view in tile_mma.tma_views(m, k, n).items():
        assert all(s % 16 == 0 and s > 0 for s in view.strides), name
        assert view.strides[0] >= view.dims[0] * 2, name
        assert view.strides[1] >= view.strides[0] * view.dims[1], name
        assert all(1 <= b <= 256 for b in view.box), name
        assert view.box[0] * 2 == 128, name
        assert sorted(view.roles) == [tile_mma.K_AXIS, tile_mma.TILE_AXIS,
                                      tile_mma.PART_AXIS], name
        assert view.box[_role_dim(view, tile_mma.K_AXIS)] == tile_mma.WG_BK
        assert view.dims[_role_dim(view, tile_mma.PART_AXIS)] == 1, name
        assert view.box[_role_dim(view, tile_mma.PART_AXIS)] == 1, name
        assert view.dims[_role_dim(view, tile_mma.K_AXIS)] == k, name


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
