"""Fabric-probe workloads, single-chip part: the health burn the operator
runs on the cards it manages.

Counterpart of the JAX package's ``parallel/fabric_probe.py``.
``burn_step`` is the plain PyTorch burn (the reference's jnp version,
left to the library); ``burn.best_burn_step`` picks it or the
hand-written kernels. The multi-chip probe model (``probe_train_step``
and its helpers) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device

# Probe-model dimensions (the multi-chip probe's; kept with the burn's).
BLOCK_BATCH = 4
BLOCK_SEQ = 8
DIM = 128
HIDDEN = 256
BURN_DIM = 1024
LR = 1e-2


def burn_step(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Eight chained bf16 matmuls + nonlinearity; returns an f32 scalar
    health signature (finite <=> datapath healthy). Rounds to bf16 after
    each matmul and again after each tanh, as the reference's jnp burn
    does."""
    h = x.to(torch.bfloat16)
    w = w.to(torch.bfloat16)
    for _ in range(8):
        h = torch.tanh(h @ w).to(torch.bfloat16)
    return torch.sum(h.float() ** 2)


def burn_example_args(device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x, w`` bf16 ``[BURN_DIM, BURN_DIM]``, drawn from a generator
    seeded 0 on ``device`` (the CUDA card unless the caller asks for the
    CPU). The numbers differ from the reference's ``PRNGKey(0)`` draw;
    the signature they give is only ever checked for being finite."""
    device = resolve_device(device, "burn_example_args")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    shape = (BURN_DIM, BURN_DIM)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16)
    w = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.bfloat16) * 0.05
    return x, w


def burn_args_from_numpy(x: np.ndarray, w: np.ndarray, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Burn operands from float32 numpy arrays (how the reference's bf16
    arrays cross over: exactly, since every bf16 value is a float32), as
    bf16 on ``device``."""
    device = resolve_device(device, "burn_args_from_numpy")
    return tuple(torch.from_numpy(np.array(a, np.float32)).to(
        device=device, dtype=torch.bfloat16) for a in (x, w))
