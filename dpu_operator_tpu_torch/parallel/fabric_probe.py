"""Fabric-probe workloads: the compute the operator runs on the cards it
manages.

Counterpart of the JAX package's ``parallel/fabric_probe.py``, in two
tiers:

* ``burn_step``, the single-card health burn: the plain PyTorch burn (the
  reference's jnp version, left to the library); ``burn.best_burn_step``
  picks it or the hand-written kernels.

* ``make_probe_train_step``, the multi-rank fabric validation step: a
  probe model trained over a (dp, sp, tp) mesh (``mesh.build_mesh``) so
  that every axis carries its own collective pattern: tp the sum of the
  column-parallel partials (the reference's ``psum``), sp a ring hand-off
  of the sequence blocks (its ``ppermute``), dp and sp the mean of the
  loss and of the gradient (its ``pmean``). A hand-off that drops or
  corrupts data shows as a non-finite or drifting probe loss;
  ``run_probe`` is what the multi-chip dry run runs.

As on every multi-rank path of the port, the ranks are stacked on one
card: rank (i, j)'s batch block, the reference's ``P("dp", "sp", None)``,
is ``blocks[i, j]`` of ``[dp, sp, B/dp, S/sp, DIM]``
(``shard_probe_batch``); ``w1`` is cut on its columns and ``w2`` on its
rows into tp shards, as views of one tensor (``PARAM_SPEC``); the sp
hand-off is a roll of the blocks along the sp index. The numerics are the
reference's: bf16 operands and outputs for both products, each tp
partial cast to f32 and the partials summed in rank order. No hand-off
goes through a ring kernel: the reference's probe reaches none (XLA's
collectives, no ``pallas_call``).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .mesh import AXES

# Probe-model dimensions. Per-shard block sizes are fixed; the global
# batch/seq dims scale with the mesh (see probe_shapes) so any (dp, sp)
# factoring divides evenly.
BLOCK_BATCH = 4
BLOCK_SEQ = 8
DIM = 128
HIDDEN = 256
BURN_DIM = 1024
LR = 1e-2

# Which mesh axis cuts each dimension of each weight (the reference's
# PartitionSpecs, as tuples): w1 on its columns, w2 on its rows, over tp.
PARAM_SPEC = {"w1": (None, "tp"), "w2": ("tp", None)}


def probe_shapes(mesh: Mapping[str, int]) -> Tuple[int, int]:
    """Global (batch, seq) for ``mesh``: per-shard block × axis size."""
    return (
        BLOCK_BATCH * mesh["dp"],
        BLOCK_SEQ * mesh["sp"],
    )


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


# -- multi-rank probe model ----------------------------------------------------


def init_probe_params(seed: int = 1, device=None) -> Dict[str, torch.Tensor]:
    """``w1 [DIM, HIDDEN]`` and ``w2 [HIDDEN, DIM]`` f32 ~ N(0, 1/DIM),
    drawn in that order from a generator seeded ``seed`` on ``device``
    (None means the CUDA card). The numbers differ from the reference's
    ``jax.random`` draw: hold the two packages on weights carried across
    (``probe_params_from_numpy``)."""
    device = resolve_device(device, "init_probe_params")
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = 1.0 / math.sqrt(DIM)
    return {name: torch.randn(shape, generator=gen, device=device) * scale
            for name, shape in (("w1", (DIM, HIDDEN)), ("w2", (HIDDEN, DIM)))}


def probe_params_from_numpy(params, device=None) -> Dict[str, torch.Tensor]:
    """The reference's probe parameters as numpy arrays (``np.asarray`` of
    each entry of its ``init_probe_params``) -> f32 tensors on ``device``
    (None means the CUDA card)."""
    device = resolve_device(device, "probe_params_from_numpy")
    return {k: torch.from_numpy(np.array(params[k], np.float32)).to(device)
            for k in PARAM_SPEC}


def probe_example_batch(seed: int, mesh: Mapping[str, int], device=None
                        ) -> torch.Tensor:
    """The global ``[batch, seq, DIM]`` f32 batch of ``probe_shapes(mesh)``
    ~ N(0, 1), from a generator seeded ``seed`` on ``device`` (None means
    the CUDA card)."""
    device = resolve_device(device, "probe_example_batch")
    gen = torch.Generator(device=device).manual_seed(seed)
    batch, seq = probe_shapes(mesh)
    return torch.randn((batch, seq, DIM), generator=gen, device=device)


def _probe_axes(mesh: Mapping[str, int]) -> Tuple[int, int, int]:
    missing = [a for a in AXES if a not in mesh]
    if missing:
        raise ValueError(f"mesh {dict(mesh)} lacks the axes {missing}: the "
                         f"probe's mesh names all of {AXES}")
    return tuple(int(mesh[a]) for a in AXES)


def shard_probe_batch(batch, mesh: Mapping[str, int]) -> torch.Tensor:
    """A global ``[B, S, DIM]`` batch (a tensor or an array) laid out as the
    stacked ranks hold it: ``[dp, sp, B/dp, S/sp, DIM]``, rank (i, j)'s
    block of the reference's ``P("dp", "sp", None)`` at ``[i, j]``."""
    dp, sp, _ = _probe_axes(mesh)
    batch = torch.as_tensor(batch, dtype=torch.float32)
    B, S, D = batch.shape
    if B % dp or S % sp:
        raise ValueError(f"batch {tuple(batch.shape)} does not shard over "
                         f"dp={dp} (batch) and sp={sp} (sequence)")
    return (batch.reshape(dp, B // dp, sp, S // sp, D)
            .permute(0, 2, 1, 3, 4).contiguous())


def _probe_loss(params, blocks: torch.Tensor, tp: int) -> torch.Tensor:
    """The mean over the dp·sp ranks of each rank's loss, blocks ``[dp, sp,
    b, s, DIM]``: ``y`` the sum over tp shards in rank order of ``relu(x @
    w1_t) @ w2_t`` (bf16 operands and outputs, each partial cast to f32),
    ``mean((y - x)**2)`` plus ``0.0 *`` the sp ring term, each of sp
    iterations adding ``mean(blk * y)`` and then handing every block one
    rank along sp (the reference's ppermute (j, j + 1 mod sp)). The ring
    term moves no gradient; it is how a non-finite hand-off reaches the
    loss."""
    dp, sp = blocks.shape[:2]
    xb = blocks.reshape(dp, sp, -1, blocks.shape[4]).to(torch.bfloat16)
    w1s, w2s = (params[k].split(HIDDEN // tp, dim=PARAM_SPEC[k].index("tp"))
                for k in ("w1", "w2"))
    y = None
    for w1, w2 in zip(w1s, w2s):
        # Each rank's own bf16 copy of the shard, as each device holds
        # one: a weight's gradient is then rounded to bf16 rank by rank
        # and the ranks' gradients summed in f32, as the reference's
        # pmean sums its devices' gradients.
        h = torch.relu(xb @ w1.expand(dp, sp, *w1.shape).to(torch.bfloat16))
        part = (h @ w2.expand(dp, sp, *w2.shape).to(torch.bfloat16)).float()
        y = part if y is None else y + part  # the tp partials in rank order
    y = y.view(blocks.shape)
    rank_dims = (2, 3, 4)
    ring_acc = blocks.new_zeros((dp, sp))
    blk = blocks
    for _ in range(sp):
        ring_acc = ring_acc + (blk * y).mean(dim=rank_dims)
        blk = blk.roll(1, dims=1)  # rank j's block to rank j + 1
    recon = ((y - blocks) ** 2).mean(dim=rank_dims)
    return (recon + 0.0 * ring_acc).mean()


def make_probe_train_step(mesh: Mapping[str, int], device=None):
    """``step(params, blocks) -> (new_params, loss)``: the full fabric
    validation step over ``mesh`` on ``device`` (None means the CUDA
    card). ``params`` are ``init_probe_params``' f32 weights on ``device``;
    ``blocks`` the batch laid out by ``shard_probe_batch``. ``loss`` is the
    reference's ``pmean`` over (dp, sp) of each rank's loss, a 0-d f32
    tensor, and ``new = p - LR * tp * grad``, ``grad`` the gradient of
    that loss."""
    dp, sp, tp = _probe_axes(mesh)
    device = resolve_device(device, "make_probe_train_step")
    if HIDDEN % tp:
        raise ValueError(f"the hidden width {HIDDEN} (w1's columns, w2's "
                         f"rows) does not shard over tp={tp}")

    def step(params, blocks):
        if set(params) != set(PARAM_SPEC):
            raise ValueError(f"params carry {sorted(params)}; the probe "
                             f"takes {sorted(PARAM_SPEC)}")
        want = {"w1": (DIM, HIDDEN), "w2": (HIDDEN, DIM)}
        for name, t in params.items():
            if t.device != device or tuple(t.shape) != want[name]:
                raise ValueError(f"{name} {tuple(t.shape)} on {t.device}; "
                                 f"the step takes {want[name]} on {device}")
        if (blocks.device != device or blocks.dim() != 5
                or tuple(blocks.shape[:2]) != (dp, sp)
                or blocks.shape[4] != DIM):
            raise ValueError(f"blocks {tuple(blocks.shape)} on "
                             f"{blocks.device}: the step takes [{dp}, {sp}, "
                             f"b, s, {DIM}] on {device} (shard_probe_batch)")
        leaves = {k: params[k].detach().requires_grad_() for k in PARAM_SPEC}
        with torch.enable_grad():
            loss = _probe_loss(leaves, blocks, tp)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        # The reference's update is tp x its loss's gradient: under
        # shard_map(check_vma=False) the transpose of the tp psum of y is
        # another psum, so each tp rank's cotangent of y arrives summed
        # over the tp ranks. The factor is kept: the port computes what
        # the reference computes.
        new = {k: params[k].detach() - LR * (tp * g)
               for k, g in zip(leaves, grads)}
        return new, loss.detach()

    return step


def run_probe(mesh: Mapping[str, int], steps: int = 1, device=None) -> float:
    """Initialise, lay out, and run ``steps`` probe-train steps on
    ``mesh`` on ``device`` (None means the CUDA card); returns the final
    loss (finite <=> every exercised hand-off healthy)."""
    device = resolve_device(device, "run_probe")
    params = init_probe_params(1, device)
    blocks = shard_probe_batch(probe_example_batch(2, mesh, device), mesh)
    step = make_probe_train_step(mesh, device)
    loss = None
    for _ in range(steps):
        params, loss = step(params, blocks)
    return float(loss)
