"""The MXU/tensor-core health burn: hand-written kernels and their plain
versions.

Counterpart of the JAX package's ``parallel/pallas_burn.py``. The burn is
eight chained ``h = bf16(tanh(f32(h @ w)))`` from ``h = x``, reduced to
the f32 health signature ``sum(h**2)``:

  * ``burn_chain`` runs the whole chain in ONE launch
    (``csrc/tile_mma.cu``, ``chain_kernel``), h kept in L2 between steps;
  * ``burn_tile`` runs one step per launch (``tile_kernel`` with the tanh
    epilogue);
  * ``burn_step_kernel`` picks between them by the reference's own rule
    (``chain_fits``): square and small enough for the TPU's on-chip
    budget take the chain, everything else eight tile launches, so the
    same shapes take the same kernel on both cards.

``burn_chain_plain`` and ``burn_tile_plain`` compute the same function
with the kernels' rounding: f32 products summed in f32, f32 tanh, one
rounding to bf16 per step. A wrapper given tensors on the CPU runs its
plain version; on a CUDA tensor it launches its kernel or raises. Each
wrapper counts its launches in ``.launches``.

``best_burn_step(device)`` is the reference's backend pick made explicit:
the kernels on the card (the default, which needs a CUDA device), the
plain ``fabric_probe.burn_step`` where the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..device import resolve_device
from . import tile_mma
from .fabric_probe import burn_step

TILE = 128
# bf16 bytes of (x + w + h scratch + out) that fit the TPU's VMEM for the
# single-call chain kernel (the reference's budget, kept so that the same
# shapes take the same kernel).
_CHAIN_BUDGET = 12 * 1024 * 1024


def chain_fits(m: int, n: int) -> bool:
    return 4 * m * n * 2 <= _CHAIN_BUDGET


def burn_tile_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One burn step, ``bf16(tanh(f32(x @ w)))``."""
    return torch.tanh(x.float() @ w.float()).to(torch.bfloat16)


def burn_chain_plain(x: torch.Tensor, w: torch.Tensor, length: int = 8
                     ) -> torch.Tensor:
    """``length`` chained burn steps from ``h = x``."""
    h = x.to(torch.bfloat16)
    w = w.to(torch.bfloat16)
    for _ in range(length):
        h = burn_tile_plain(h, w)
    return h


def burn_tile(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One burn step (``burn_tile_plain``'s function) in one launch of
    the tile kernel."""
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if x.device.type == "cpu":
        return burn_tile_plain(x, w)
    out = tile_mma.product("burn_tile", x, w, apply_tanh=True)
    burn_tile.launches += 1
    return out


def burn_chain(x: torch.Tensor, w: torch.Tensor, length: int = 8
               ) -> torch.Tensor:
    """``length`` chained burn steps (``burn_chain_plain``'s function) in
    one cooperative launch of the chain kernel; raises where the card
    refuses that launch."""
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    m, k = x.shape
    if not m == k == w.shape[0] == w.shape[1]:
        raise ValueError(f"burn_chain: the chain needs square h @ w, got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if length < 1:
        raise ValueError(f"burn_chain: length must be >= 1, got {length}")
    if x.device.type == "cpu":
        return burn_chain_plain(x, w, length)
    _, _, n = tile_mma.operands("burn_chain", x, w)
    h0, h1, out = (torch.empty_like(x) for _ in range(3))
    tile_mma.launch("burn_chain_launch", x.device, (x, w, h0, h1, out),
                    (n, length))
    burn_chain.launches += 1
    return out


#: Kernel launches so far (CPU calls of the wrappers do not count).
burn_tile.launches = 0
burn_chain.launches = 0


def burn_step_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Eight chained burn steps and their f32 signature ``sum(h**2)``;
    the contract of ``fabric_probe.burn_step``. Shapes that satisfy
    ``chain_fits`` and are square run as one chain launch, the rest as
    eight tile launches."""
    m, k = x.shape
    k2, n = w.shape
    if not (k == k2 and m % TILE == 0 and n % TILE == 0):
        raise ValueError(f"burn_step_kernel: tile-aligned shapes only, got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if m == n and chain_fits(m, n):
        h = burn_chain(x, w, length=8)
    else:
        h = x.to(torch.bfloat16)
        for _ in range(8):
            h = burn_tile(h, w)
    return torch.sum(h.float() ** 2)


def best_burn_step(device=None) -> Callable:
    """The burn for ``device``: the kernels (``burn_step_kernel``) on a
    CUDA device, the default, which raises without one; the plain
    ``fabric_probe.burn_step`` where the caller asks for the CPU."""
    device = resolve_device(device, "best_burn_step")
    if device.type == "cuda":
        return burn_step_kernel
    if device.type == "cpu":
        return burn_step
    raise ValueError(f"best_burn_step: no burn for device {device}")


def bf16_ulps(got: torch.Tensor, want: torch.Tensor,
              floor: float = 2.0 ** -5) -> float:
    """Largest distance between two bf16 tensors, in units of the bf16
    ulp at the larger of the two magnitudes, or at ``floor`` where both
    lie below it. Below the floor, the absolute rounding of f32 sums
    taken in another order can exceed the value's own ulp, so it is
    measured against the ulp at the floor (``2**-12`` at the default)."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got - want).abs() / ulp).max())

