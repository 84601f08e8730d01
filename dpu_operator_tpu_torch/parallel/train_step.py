"""The five-axis model's forward stage: the part of the training step that
the serving plane runs.

Counterpart of the forward half of the JAX package's
``parallel/train_step.py``: the axis names, the stage-stacked parameters
(a dense pair sharded over ``tp``, a router, and ``ep`` experts a stage),
which axis shards each weight, and ``_stage_fn``, one stage's arithmetic:
``relu(x @ w1) @ w2``, ``tanh``, then a Switch MoE over ``ep``
(``moe.switch_moe_local``), plus the residual.

Ranks are stacked on one card, as every multi-rank path of the port runs
them: a stage's activations are ``[E, rows_local, d]``, one row block a
``ep`` rank, and its experts are stacked ``[E, d, h]`` / ``[E, h, d]``.
With ``tp = 1`` the reference's ``psum`` over ``tp`` is the identity. The
dense products are plain float32 matmuls, as the reference leaves them to
XLA (hold the two with TF32 off).

Still to port: the attention branch (``attention=True``: the stage opens
with causal ring attention over the token axes), the training steps
(``make_train_step``, ``make_train_step_1f1b``), ``dense_loss_reference``
and the 1F1B interleaving of the stage stack (``interleave_params``,
``uninterleave_params``); all wait for the training stack (queue 1 #8).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from ..device import resolve_device
from .moe import Exchange, _local_chunk, all_to_all_plain, switch_moe_local

AXES = ("dp", "pp", "sp", "tp", "ep")

_ATTENTION_LATER = (
    "the stage's attention branch (wq/wk/wv) is not ported yet: it comes "
    "with the training and sequence-parallel stack (queue 1 #8)")


def init_params(S: int, d: int, h: int, E: int, seed: int = 0,
                attention: bool = False, device=None) -> Dict:
    """Stage-stacked params: dense tp pair + router + ep experts a stage,
    leading dim S (sharded over pp in the reference). Drawn from a seeded
    ``torch.Generator`` on ``device`` (None means the CUDA card), in the
    reference's order and scales; the reference's ``jax.random`` draws
    are not reproduced, so hold the two packages on weights carried
    across (``params_from_numpy``)."""
    if attention:
        raise NotImplementedError(_ATTENTION_LATER)
    device = resolve_device(device, "init_params")
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, fan_in):
        t = torch.randn(shape, generator=g, device=device)
        return t.div_(math.sqrt(fan_in))

    return {
        "w1": normal((S, d, h), d),
        "w2": normal((S, h, d), h),
        "router": normal((S, d, E), d),
        "moe_w1": normal((S, E, d, h), d),
        "moe_w2": normal((S, E, h, d), h),
    }


def param_specs(attention: bool = False) -> Dict:
    """Which mesh axis shards each dimension of each weight (the
    reference's ``PartitionSpec``s, as tuples)."""
    specs = {
        "w1": ("pp", None, "tp"),
        "w2": ("pp", "tp", None),
        "router": ("pp", None, None),
        "moe_w1": ("pp", "ep", None, None),
        "moe_w2": ("pp", "ep", None, None),
    }
    if attention:
        specs.update({name: ("pp", None, None)
                      for name in ("wq", "wk", "wv")})
    return specs


def params_from_numpy(params: Dict[str, np.ndarray], device
                      ) -> Dict[str, torch.Tensor]:
    """The reference's parameters as numpy arrays (``np.asarray`` of each
    entry of its ``init_params``) -> float32 tensors on ``device``."""
    if "wq" in params:
        raise NotImplementedError(_ATTENTION_LATER)
    return {k: torch.from_numpy(np.array(params[k], np.float32))
            .to(device) for k in param_specs()}


def shard_params(params: Dict, mesh: Mapping[str, int], device=None
                 ) -> Dict[str, torch.Tensor]:
    """Check the weights' shapes against a serving mesh (every dimension
    a spec shards divides by its axis size, the router is ``ep`` wide)
    and place them on ``device`` (None means the CUDA card) as float32.
    A float32 tensor already there is kept, not copied, so executors
    built from one dict share one set of weights."""
    if "wq" in params:
        raise NotImplementedError(_ATTENTION_LATER)
    device = resolve_device(device, "shard_params")
    specs = param_specs()
    out = {}
    for name, spec in specs.items():
        t = params[name]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t, np.float32))
        if t.dim() != len(spec):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; its spec "
                             f"{spec} wants {len(spec)} dimensions")
        for size, axis in zip(t.shape, spec):
            if axis is not None and size % int(mesh[axis]):
                raise ValueError(
                    f"{name} dimension {size} does not shard over "
                    f"{axis}={mesh[axis]}")
        out[name] = t.to(device=device, dtype=torch.float32)
    if out["router"].shape[2] != int(mesh["ep"]):
        raise ValueError(
            f"router width {out['router'].shape[2]} != ep axis size "
            f"{mesh['ep']}")
    return out


def _stage_fn(p, x, *, E: int, tp_axis: str, ep_axis: str,
              capacity_factor: float, seq_shape=None, attn_axes=None,
              attn_ring: int = 1, row_mask=None,
              exchange: Exchange = all_to_all_plain):
    """One stage over the E ``ep`` ranks stacked on one device: the
    Megatron-paired dense block (tp = 1, so its closing psum is the
    identity), then a Switch MoE over the ranks (moe.switch_moe_local,
    the one copy of the bucketing math), plus the residual. x: [E,
    rows_local, d]; p: one stage's weights, experts stacked [E, d, h];
    ``exchange`` is the MoE's all-to-all (``moe.pick_exchange``).
    ``tp_axis``, ``ep_axis``, ``seq_shape``, ``attn_axes`` and
    ``attn_ring`` keep the reference's signature; a ``p`` that carries
    the attention branch raises."""
    experts = p["moe_w1"].shape[0]
    if experts != E or p["moe_w2"].shape[0] != E:
        raise ValueError(
            f"expert count must equal the ep axis size {E}: each device "
            f"hosts one expert, got a local chunk of "
            f"{_local_chunk(experts, E)}")
    if p["router"].shape[1] != E:
        raise ValueError(
            f"router width {p['router'].shape[1]} != {E} experts — "
            f"tokens routed past the mesh would silently drop")
    if "wq" in p:
        raise NotImplementedError(_ATTENTION_LATER)
    h = torch.relu(x @ p["w1"])             # [E, rows, h]
    y = torch.tanh(h @ p["w2"])
    moe_out = switch_moe_local(
        y, p["router"], p["moe_w1"], p["moe_w2"],
        capacity_factor=capacity_factor, row_mask=row_mask,
        exchange=exchange)
    return y + moe_out  # residual keeps gradients flowing past drops
