"""Bindings of ``csrc/tile_mma.cu``: the bf16 tensor-core tile products
behind the health burn (``burn.py``) and the benchmark matmul
(``mxu_bench.py``), and the tensor-map views that the TMA-fed wgmma form
of ``csrc/tile_product.cuh`` reads its operands through (shared with the
bf16 collective matmuls, ``collective_matmul.py``).

The kernels take row-major contiguous bf16 operands ``x [m, k]`` and
``w [k, n]`` on one CUDA device, with m and n multiples of 128 (the CTA
tile's rows) and k a multiple of 32. ``operands`` checks that and raises
on anything else; the C entry points trust it. ``product`` launches the
tile kernel (``tile_kernel``, TMA + wgmma, in 128 x ``TILE_WIDTH`` tiles),
``launch`` any entry point.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

CTA_TILE = 128
K_STEP = 32

#: The bf16 wgmma product's TMA boxes (``csrc/tile_product.cuh``,
#: ``tile_product_wgmma``): A tiles of WG_BM rows, K steps of WG_BK (one
#: 128-byte swizzled row), B loaded WG_PANEL columns a box.
WG_BM, WG_BK, WG_PANEL = 128, 64, 64
#: What each coordinate of a view runs along: the contraction, the tile's
#: rows (A) or columns (B), the parts (shards, slots, ranks).
K_AXIS, TILE_AXIS, PART_AXIS = 0, 1, 2

#: The tile kernel's CTA tile widths (128 x width; both are built) and the
#: one the wrappers launch, the faster of the two at the path's shapes on
#: an H100 (``PERF.md`` section 6).
TILE_WIDTHS = (128, 256)
TILE_WIDTH = 256


class TmaView(NamedTuple):
    """One bf16 operand as a 3-D tensor map reads it, innermost first:
    ``dims`` in elements, ``strides`` of dimensions 1 and 2 in bytes,
    ``box`` the elements one load brings, ``roles`` the axis each
    coordinate runs along. A box past a dimension's extent is
    zero-filled."""
    dims: Tuple[int, int, int]
    strides: Tuple[int, int]
    box: Tuple[int, int, int]
    roles: Tuple[int, int, int]

    def values(self) -> Tuple[int, ...]:
        """The 11 values ``tile::encode_view`` reads."""
        return self.dims + self.strides + self.box + self.roles


def tma_views(m: int, k: int, n: int, item: int = 2) -> Dict[str, TmaView]:
    """The tensor maps of the tile kernel, in the order its C entry point
    takes them: x [m, k] as (k, m, 1), one 64 x 128 box a K step of a row
    tile; w [k, n] as (n, k, 1), 64 x 64 boxes, read MN-major (the
    descriptor's transpose bit) as the collective matmuls read their w.
    The part extent is 1. Pure: shapes in, views out."""
    return {
        "x": TmaView((k, m, 1), (k * item, m * k * item), (WG_BK, WG_BM, 1),
                     (K_AXIS, TILE_AXIS, PART_AXIS)),
        "w": TmaView((n, k, 1), (n * item, k * n * item),
                     (WG_PANEL, WG_BK, 1), (TILE_AXIS, K_AXIS, PART_AXIS)),
    }


@functools.lru_cache(maxsize=64)
def _views_arg(m: int, k: int, n: int):
    """``tma_views`` as the C entry point takes them: one flat array of
    long long (read, never written, by the callee)."""
    flat = [v for view in tma_views(m, k, n).values() for v in view.values()]
    return (ctypes.c_longlong * len(flat))(*flat)


def operands(where: str, x: torch.Tensor, w: torch.Tensor
             ) -> Tuple[int, int, int]:
    """``(m, k, n)`` of a product the kernels take; raises ValueError
    otherwise."""
    if x.device.type != "cuda":
        raise ValueError(f"{where}: no kernel for device {x.device}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{where}: want x [m, k] @ w [k, n], got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if m % CTA_TILE or n % CTA_TILE or k % K_STEP:
        raise ValueError(f"{where}: the kernel takes m and n multiples of "
                         f"{CTA_TILE} and k a multiple of {K_STEP}, got "
                         f"m={m} k={k} n={n}")
    for name, t in (("x", x), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{where}: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{where}: {name} must be bfloat16, got "
                             f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{where}: {name} must be contiguous and "
                             f"16-byte aligned")
    return m, k, n


def product(where: str, x: torch.Tensor, w: torch.Tensor,
            apply_tanh: bool) -> torch.Tensor:
    """``bf16(x @ w)``, through tanh in f32 if ``apply_tanh``, in one
    launch of the tile kernel."""
    return product_of_width(where, x, w, apply_tanh, TILE_WIDTH)


def product_of_width(where: str, x: torch.Tensor, w: torch.Tensor,
                     apply_tanh: bool, width: int) -> torch.Tensor:
    """``product`` in CTA tiles of 128 x ``width`` (one of
    ``TILE_WIDTHS``), to time the widths against each other."""
    if width not in TILE_WIDTHS:
        raise ValueError(f"{where}: the tile kernel is built {TILE_WIDTHS} "
                         f"wide, not {width}")
    m, k, n = operands(where, x, w)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tile_mma_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  _views_arg(m, k, n), m, k, n,
                                  int(apply_tanh), width, stream)
    if err:
        raise RuntimeError(f"tile_mma_launch failed: CUDA error {err}")
    return out


def _library():
    from ..cuda_build import load

    lib = load("tile_mma")
    if lib.tile_mma_launch.argtypes is None:
        lib.tile_mma_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.tile_mma_launch.restype = ctypes.c_int
    return lib


def launch(entry: str, device: torch.device, tensors, ints) -> None:
    """Call the C entry point ``entry`` of ``csrc/tile_mma.cu`` that takes
    only tensors and ints (the chain's) on ``device``'s current stream with
    the tensors' data pointers and the ints; raise if the launch failed."""
    fn = getattr(_library(), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                       + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), *ints, stream)
    if err:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
