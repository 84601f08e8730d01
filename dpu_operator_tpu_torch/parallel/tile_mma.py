"""Bindings of ``csrc/tile_mma.cu``: the bf16 tensor-core tile product
behind the health burn (``burn.py``) and the benchmark matmul
(``mxu_bench.py``).

The kernels take row-major contiguous bf16 operands ``x [m, k]`` and
``w [k, n]`` on one CUDA device, with m and n multiples of 128 (the CTA
tile) and k a multiple of 32 (the K step). ``operands`` checks that and
raises on anything else; the C entry points trust it. ``product``
launches the tile kernel, ``launch`` any entry point.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

CTA_TILE = 128
K_STEP = 32


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
    m, k, n = operands(where, x, w)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    launch("tile_mma_launch", x.device, (x, w, out),
           (m, k, n, int(apply_tanh)))
    return out


def launch(entry: str, device: torch.device, tensors, ints) -> None:
    """Call the C entry point ``entry`` of ``csrc/tile_mma.cu`` on
    ``device``'s current stream with the tensors' data pointers and the
    ints; raise if the launch failed."""
    from ..cuda_build import load

    fn = getattr(load("tile_mma"), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                       + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), *ints, stream)
    if err:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
