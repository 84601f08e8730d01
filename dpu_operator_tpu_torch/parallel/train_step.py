"""The five-axis training step: dp × pp × sp × tp × ep in one program.

Counterpart of the JAX package's ``parallel/train_step.py``: the axis
names, the stage-stacked parameters (a dense pair sharded over ``tp``, a
router, ``ep`` experts a stage and, with ``attention=True``, single-head
q/k/v projections), which axis shards each weight, ``_stage_fn`` (one
stage: causal ring attention over the token ranks when the weights carry
it, ``relu(x @ w1) @ w2`` closed by the tp sum, ``tanh``, a Switch MoE
over ``ep`` (``moe.switch_moe_local``), the residual), the GPipe training
step (``make_train_step``: the pipelined forward, the loss, its gradient,
one SGD update), the hand-scheduled 1F1B step (``make_train_step_1f1b``,
its stages stacked in ``interleave_params`` order) and their
single-device twin, ``dense_loss_reference``. The serving plane runs
``_stage_fn`` forward (``serving/infer.py``).

The ranks of every axis are stacked on one card, as every multi-rank path
of the port runs them:

  pp  GPipe runs the S stages in its tick order (``pipeline.run_gpipe``),
      the reference's ``ppermute`` along the line a shift along the stage
      index; 1F1B runs ``pipeline_1f1b.run_schedule`` over the
      reference's instruction tables, pp devices of v chunks each;
  tp  w1 is cut on its columns and w2 on its rows into tp shards; each
      shard's partial ``relu(x @ w1_t) @ w2_t`` is computed and the
      partials are summed in rank order (the reference's ``psum``). The
      tp replicas of the rest of the stage are computed once;
  dp, sp  further row groups: a stage's activations are ``[G, E, rows,
      d]`` for the G = dp·sp groups of E ``ep`` ranks, each group routing
      its own tokens through its own MoE buckets. The groups fold into the
      expert exchanges' width, so each stays one all-to-all (``moe.py``).
      With the attention branch, the token ranks' rows regroup into whole
      sequences (sp-major, then ep) for the causal ring
      (``ring_attention.ring_attention_batched``) and cut back after it;
  ep  rank r's tokens at ``[:, r]`` and its expert at index r of the
      stacked ``[E, d, h]`` / ``[E, h, d]``; each stage's two exchanges
      launch the CUDA all-to-all on the card, forward and backward.

The dp/sp gradient sync that the reference gets from ``shard_map``'s
transpose (a replicated input's cotangent is the sum over the axes its
spec omits) is autograd summing the uses of one shared weight; the 1F1B
step's explicit per-leaf ``psum`` and its ``1/replicas`` cotangent scale
undo replication that the stacked ranks do not have, so neither is
carried across. The dense products are plain float32 matmuls, as the
reference leaves them to XLA (hold the two with TF32 off).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..device import pick_kernel, resolve_device
from .moe import (Exchange, _local_chunk, all_to_all_plain, pick_exchange,
                  switch_moe_local)
from .pipeline import run_gpipe
from .pipeline_1f1b import (_take, build_schedule, interleave_order,
                            run_schedule, uninterleave)
from .ring_attention import ring_attention_batched

AXES = ("dp", "pp", "sp", "tp", "ep")

def init_params(S: int, d: int, h: int, E: int, seed: int = 0,
                attention: bool = False, device=None) -> Dict:
    """Stage-stacked params: dense tp pair + router + ep experts a stage,
    leading dim S (sharded over pp in the reference); ``attention=True``
    adds single-head q/k/v projections ``[S, d, d]`` a stage, drawn after
    the other five. Drawn from a seeded ``torch.Generator`` on ``device``
    (None means the CUDA card), in the reference's order and scales; the
    reference's ``jax.random`` draws are not reproduced, so hold the two
    packages on weights carried across (``params_from_numpy``)."""
    device = resolve_device(device, "init_params")
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, fan_in):
        t = torch.randn(shape, generator=g, device=device)
        return t.div_(math.sqrt(fan_in))

    params = {
        "w1": normal((S, d, h), d),
        "w2": normal((S, h, d), h),
        "router": normal((S, d, E), d),
        "moe_w1": normal((S, E, d, h), d),
        "moe_w2": normal((S, E, h, d), h),
    }
    if attention:
        for name in ("wq", "wk", "wv"):
            params[name] = normal((S, d, d), d)
    return params


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
    return {k: torch.from_numpy(np.array(params[k], np.float32))
            .to(device) for k in param_specs("wq" in params)}


def shard_params(params: Dict, mesh: Mapping[str, int], device=None
                 ) -> Dict[str, torch.Tensor]:
    """Check the weights' shapes against the five-axis mesh (every
    dimension a spec shards divides by its axis size, the router is
    ``ep`` wide) and place them on ``device`` (None means the CUDA card)
    as float32. A float32 tensor already there is kept, not copied, so
    executors built from one dict share one set of weights."""
    _mesh_sizes(mesh)
    device = resolve_device(device, "shard_params")
    specs = param_specs("wq" in params)
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


def _mesh_sizes(mesh: Mapping[str, int]) -> Dict[str, int]:
    """The five axis sizes of ``mesh``; an axis missing raises."""
    missing = [a for a in AXES if a not in mesh]
    if missing:
        raise ValueError(f"mesh {dict(mesh)} lacks the axes {missing}: the "
                         f"step's mesh names all of {AXES}")
    return {a: int(mesh[a]) for a in AXES}


def _stage_fn(p, x, *, E: int, tp_axis: str, ep_axis: str,
              capacity_factor: float, seq_shape=None, attn_axes=None,
              attn_ring: int = 1, row_mask=None,
              exchange: Exchange = all_to_all_plain, tp: int = 1):
    """One stage over the ranks stacked on one device: when ``p`` carries
    wq/wk/wv, causal ring attention over the token ranks plus its residual
    (``_attend``); then the Megatron-paired dense block (w1 cut on its
    columns and w2 on its rows into ``tp`` shards, the shards' partials
    summed in rank order: the reference's psum; tp = 1 is one product),
    then a Switch MoE over the E ``ep`` ranks (moe.switch_moe_local, the
    one copy of the bucketing math), plus the residual. x: [E, rows_local,
    d], or [G, E, rows_local, d] for G row groups (the training step's dp
    and sp ranks); p: one stage's weights, experts stacked [E, d, h];
    ``exchange`` is the MoE's all-to-all (``moe.pick_exchange``).
    ``seq_shape`` = (mb_loc, seq_loc) says how a rank's rows cut into
    sequences, ``attn_axes`` names the ring's axes (``("sp", "ep")`` or
    ``"sp"``) and ``attn_ring`` its size, as in the reference; ``tp_axis``
    and ``ep_axis`` keep its signature."""
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
        if seq_shape is None:
            raise ValueError(
                "attention params present but no seq_shape — the stage "
                "cannot know where batch elements begin and end")
        x = _attend(p, x, seq_shape, attn_axes, attn_ring)
    width = p["w1"].shape[1]
    if width % tp:
        raise ValueError(f"w1 width {width} does not shard over "
                         f"{tp_axis}={tp}")
    dense = None
    for w1, w2 in zip(p["w1"].split(width // tp, dim=1),
                      p["w2"].split(width // tp, dim=0)):
        part = torch.relu(x @ w1) @ w2      # this tp rank's partial
        dense = part if dense is None else dense + part
    y = torch.tanh(dense)
    moe_out = switch_moe_local(
        y, p["router"], p["moe_w1"], p["moe_w2"],
        capacity_factor=capacity_factor, row_mask=row_mask,
        exchange=exchange)
    return y + moe_out  # residual keeps gradients flowing past drops


def _attend(p, x, seq_shape, attn_axes, attn_ring: int) -> torch.Tensor:
    """x plus single-head causal ring attention over the token ranks. x:
    [G, E, rows, d] (or [E, rows, d], one group), group g = dp_rank·sp +
    sp_rank, a rank's rows ``seq_shape`` = (mb_loc, piece): mb_loc
    sequences of ``piece`` tokens. The ring is ``attn_ring`` ranks over
    ``attn_axes``: sp and ep, sp-major (token-sharded ep), or sp alone,
    where the ep ranks hold the same tokens, so rank 0's are attended once
    and the result added to every rank's rows. The ranks' rows regroup
    into whole sequences in ring order, go through
    ``ring_attention_batched`` and are cut back."""
    axes = (attn_axes,) if isinstance(attn_axes, str) else tuple(
        attn_axes or ())
    if not axes or set(axes) - {"sp", "ep"}:
        raise ValueError(f"attention over the token axes wants attn_axes "
                         f"('sp', 'ep') or 'sp', got {attn_axes!r}")
    groups = x if x.dim() == 4 else x[None]
    G, E, rows, d = groups.shape
    ring_ep = E if "ep" in axes else 1
    sp = attn_ring // ring_ep
    mb_loc, piece = seq_shape
    if sp * ring_ep != attn_ring or G % sp or mb_loc * piece != rows:
        raise ValueError(
            f"a ring of {attn_ring} over {axes} does not cut x "
            f"{tuple(x.shape)} into sequences of {seq_shape}")
    dp = G // sp
    seqs = groups[:, :ring_ep].reshape(
        dp, sp, ring_ep, mb_loc, piece, d).permute(0, 3, 1, 2, 4, 5).reshape(
        dp * mb_loc, attn_ring * piece, d)
    attn = ring_attention_batched(seqs @ p["wq"], seqs @ p["wk"],
                                  seqs @ p["wv"], attn_ring, True)
    attn = attn.reshape(dp, mb_loc, sp, ring_ep, piece, d).permute(
        0, 2, 3, 1, 4, 5).reshape(G, ring_ep, rows, d)
    return (groups + attn).reshape(x.shape)  # pre-norm-style residual


def _token_groups(t: torch.Tensor, sizes: Mapping[str, int],
                  token_shard_ep: bool) -> torch.Tensor:
    """x or target [M, mb, seq, d] as the stacked ranks hold it: [M, G, E,
    rows, d]. mb splits over dp and seq over ("sp", "ep"), sp-major (over
    sp alone, each ep rank holding its sp shard whole, when not
    ``token_shard_ep``); group g = dp_rank·sp + sp_rank; a rank's rows are
    its microbatch rows, each its sequence piece in order (the
    reference's ``x_loc.reshape(M, rows, d)``)."""
    M, mb, seq, d = t.shape
    dp, sp, E = sizes["dp"], sizes["sp"], sizes["ep"]
    cuts = sp * (E if token_shard_ep else 1)
    if mb % dp or seq % cuts:
        raise ValueError(
            f"x {tuple(t.shape)}: mb {mb} must split over dp={dp} and seq "
            f"{seq} over {cuts} token shards")
    g = t.reshape(M, dp, mb // dp, cuts, seq // cuts, d)
    g = g.permute(0, 1, 3, 2, 4, 5).reshape(
        M, dp * sp, cuts // sp, (mb // dp) * (seq // cuts), d)
    if not token_shard_ep:  # every ep rank routes all its sp shard's tokens
        g = g.expand(M, dp * sp, E, *g.shape[3:])
    return g


def value_and_grad(loss_fn: Callable, params: Mapping[str, torch.Tensor],
                   x, tgt):
    """``(loss, grads)`` of ``loss_fn(params, x, tgt)``, the gradient by
    ``torch.autograd.grad``: ``jax.value_and_grad`` over the params."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves, x, tgt)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def make_train_step(mesh: Mapping[str, int], capacity_factor: float = 4.0,
                    lr: float = 0.05, token_shard_ep: bool = True,
                    attention: bool = False, *,
                    kernel: Optional[str] = None, device=None):
    """Returns (train_step, loss_fn) on ``device``.

    ``loss_fn(params, x, tgt)`` runs the GPipe forward over the pp stages
    and returns ``sum((out - tgt)²) / n_global / d`` (n_global = M·mb·seq
    rows) summed over ("pp", "dp", "sp", "ep"), or ("pp", "dp", "sp") when
    not ``token_shard_ep``: the tp replicas are counted once. x and target
    are [M, mb, seq, d] microbatches, mb split over dp and seq over ("sp",
    "ep"), so every ep rank routes distinct tokens; ``token_shard_ep=False``
    keeps the reference's replicated-ep program, where each ep rank routes
    every token of its sp shard. ``train_step(params, x, tgt)`` returns
    ``(loss, new_params)``: the gradient by autograd (every expert
    exchange differentiated as the same exchange) and ``new = p − lr·g``.

    Params are the stage-stacked ``init_params`` layout on ``device``
    (``shard_params``) with S == mesh["pp"] stages, carrying wq/wk/wv
    exactly when ``attention``: each stage then opens with causal ring
    attention over the token ranks (sp and ep, or sp alone when not
    ``token_shard_ep``). ``mesh`` maps all five axis names to sizes.
    ``kernel`` is ``"cuda"`` (the default on a CUDA device: the expert
    exchanges launch the all-to-all kernel, forward and backward, at ep >
    1) or ``"torch"`` (the default on the CPU: its plain version);
    ``device`` None means the CUDA card, and raises without one."""
    sizes = _mesh_sizes(mesh)
    device = resolve_device(device, "make_train_step")
    kernel = pick_kernel(kernel, device)
    loss_fn = _make_loss(sizes, capacity_factor, token_shard_ep,
                         pick_exchange(kernel, sizes["ep"]), device,
                         attention)

    def train_step(params, x, tgt):
        return _sgd(params, *value_and_grad(loss_fn, params, x, tgt), lr)

    return train_step, loss_fn


def _sgd(params, loss, grads, lr: float):
    """``(loss, new)``, ``new = p − lr·g`` written over g's own storage
    (lr·g rounded, then the difference, as the reference computes it): the
    update needs no memory beyond the weights and their gradients."""
    new = {k: torch.sub(params[k].detach(), g.mul_(lr), out=g)
           for k, g in grads.items()}
    return loss, new


def _attention_ring(sizes: Mapping[str, int], token_shard_ep: bool):
    """The attention ring's axes and size: sp and ep, sp-major, when the
    tokens shard over ep; sp alone otherwise (the reference's)."""
    if token_shard_ep:
        return ("sp", "ep"), sizes["sp"] * sizes["ep"]
    return "sp", sizes["sp"]


def _step_inputs(params, x, tgt, sizes, token_shard_ep: bool,
                 attention: bool, device: torch.device, stages: int,
                 what: str):
    """Check the params (on ``device``, the names of
    ``param_specs(attention)``, ``stages`` deep) and put x and target as the
    stacked ranks hold them: ``(x_g, t_g, seq_shape, n_global)``, x_g and
    t_g [M, G, E, rows, d] (``_token_groups``), seq_shape = (mb_loc,
    seq_loc), n_global = M·mb·seq the rows of the global batch."""
    want = set(param_specs(attention))
    if set(params) != want:
        raise ValueError(f"params carry {sorted(params)}; the step with "
                         f"attention={attention} takes {sorted(want)}")
    for name, t in params.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}; this step runs "
                             f"on {device}")
        if t.shape[0] != stages:
            raise ValueError(f"{name} stacks {t.shape[0]} stages; {what}")
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    tgt = torch.as_tensor(tgt, dtype=torch.float32, device=device)
    M, mb, seq, _ = x.shape
    x_g = _token_groups(x, sizes, token_shard_ep)
    t_g = _token_groups(tgt, sizes, token_shard_ep)
    cuts = sizes["sp"] * (sizes["ep"] if token_shard_ep else 1)
    return x_g, t_g, (mb // sizes["dp"], seq // cuts), M * mb * seq


def _make_loss(sizes: Mapping[str, int], capacity_factor: float,
               token_shard_ep: bool, exchange: Exchange,
               device: torch.device, attention: bool = False):
    """``make_train_step``'s loss_fn with its expert exchange given."""
    S, E, tp = sizes["pp"], sizes["ep"], sizes["tp"]
    attn_axes, attn_ring = _attention_ring(sizes, token_shard_ep)

    def loss_fn(params, x, tgt):
        x_g, t_g, seq_shape, n_global = _step_inputs(
            params, x, tgt, sizes, token_shard_ep, attention, device, S,
            f"the GPipe step runs one a pp rank, pp={S}")
        # Each stage's weights cut from the stacks once: the M uses of a
        # stage then sum their gradients at the stage's size, and one
        # stack a weight makes the stacked gradient.
        stages = [dict(zip(params, vals)) for vals in
                  zip(*(v.unbind(0) for v in params.values()))]

        def stage(s, h):
            return _stage_fn(stages[s], h, E=E, tp_axis="tp", ep_axis="ep",
                             capacity_factor=capacity_factor,
                             seq_shape=seq_shape, attn_axes=attn_axes,
                             attn_ring=attn_ring, exchange=exchange, tp=tp)

        out = torch.stack(run_gpipe(stage, list(x_g), S))
        if not token_shard_ep:  # the ep replicas are counted once
            out, t_g = out[:, :, :1], t_g[:, :, :1]
        # Each (group, rank)'s sum over its rows, then the sum of those:
        # the reference's per-device local loss and its psum.
        d = out.shape[-1]
        local = ((out - t_g) ** 2).sum(dim=(0, 3, 4)) / n_global / d
        return local.sum()

    return loss_fn


def interleave_params(params: Mapping, pp: int, v: int) -> Dict:
    """Reorder the stage-stacked leading dim (S = pp·v) into
    ``pipeline_1f1b.interleave_order``: the pp devices' v chunks each,
    device d's at d·v .. d·v + v - 1, global chunk s·pp + d in its slot s
    (the round-robin placement the interleaved schedule runs). Tensors or
    arrays; v = 1 is the natural order."""
    order = interleave_order(pp, v)
    return {k: _take(a, order) for k, a in params.items()}


def uninterleave_params(params: Mapping, pp: int, v: int) -> Dict:
    """The inverse of ``interleave_params``: back to the natural order."""
    return uninterleave(params, pp, v)


def make_train_step_1f1b(mesh: Mapping[str, int],
                         capacity_factor: float = 4.0, lr: float = 0.05,
                         M: Optional[int] = None, v: int = 1,
                         token_shard_ep: bool = True,
                         attention: bool = False, *,
                         kernel: Optional[str] = None, device=None):
    """The five-axis training step with a hand-scheduled 1F1B pipeline in
    place of GPipe and autograd over it: the same stage (``_stage_fn``,
    its tp sum, its expert exchanges), the same loss and gradients as
    ``make_train_step`` and the dense twin, but the pp dimension runs
    ``pipeline_1f1b.build_schedule(pp, M, v)``'s tables: the activations
    in flight are bounded by the warmup depth, not by M, and v > 1
    interleaves chunks to shrink the bubble.

    Returns ``train_step(params, x, tgt) -> (loss, new_params)`` on
    ``device``, with ``.schedule`` and ``.loss_and_grads(params, x, tgt)
    -> (loss, grads)``, the step before its SGD update (``new = p − lr·g``
    written over g's storage). Params: stage-stacked, leading dim S = pp·v
    in ``interleave_params`` order, with wq/wk/wv exactly when
    ``attention``. x and target: [M, mb, seq, d] as in
    ``make_train_step``. ``kernel`` and ``device`` as there.

    The reference's explicit gradient sync (a ``psum`` of each leaf over
    the axes its spec omits) and its ``1/(tp·ep replicas)`` cotangent
    scale are not carried across: the tp replicas are computed once here
    and the dp/sp/ep sums are autograd's over one shared weight. When not
    ``token_shard_ep``, the loss and its cotangent count ep rank 0's rows
    alone, as ``make_train_step``'s loss does."""
    sizes = _mesh_sizes(mesh)
    if M is None:
        raise ValueError("M (microbatch count) is static — pass it")
    device = resolve_device(device, "make_train_step_1f1b")
    kernel = pick_kernel(kernel, device)
    pp, E, tp = sizes["pp"], sizes["ep"], sizes["tp"]
    sched = build_schedule(pp, M, v)
    exchange = pick_exchange(kernel, E)
    attn_axes, attn_ring = _attention_ring(sizes, token_shard_ep)
    counted = None if token_shard_ep else (slice(None), slice(0, 1))

    def loss_and_grads(params, x, tgt):
        x_g, t_g, seq_shape, n_global = _step_inputs(
            params, x, tgt, sizes, token_shard_ep, attention, device,
            pp * v, f"each device must hold v={v} pipeline chunks "
            f"(stacked leading dim {pp * v} over a {pp}-way pp axis)")

        def stage(p, h):
            return _stage_fn(p, h, E=E, tp_axis="tp", ep_axis="ep",
                             capacity_factor=capacity_factor,
                             seq_shape=seq_shape, attn_axes=attn_axes,
                             attn_ring=attn_ring, exchange=exchange, tp=tp)

        # The mean over the global batch and the feature dim, as the GPipe
        # step's loss.
        grads, loss = run_schedule(sched, stage, params, x_g, t_g,
                                   norm=float(n_global * x_g.shape[-1]),
                                   counted=counted)
        return loss, grads

    def train_step(params, x, tgt):
        return _sgd(params, *loss_and_grads(params, x, tgt), lr)

    train_step.schedule = sched
    train_step.loss_and_grads = loss_and_grads
    return train_step


def _dense_causal_attention(h, wq, wk, wv):
    """Full-sequence single-head causal attention, per batch element: the
    dense twin of the stage's ring attention. h: [mb, seq, d]."""
    q, k, v = h @ wq, h @ wk, h @ wv
    s = torch.einsum("bqd,bkd->bqk", q, k) / math.sqrt(q.shape[2])
    mask = torch.tril(torch.ones((h.shape[1], h.shape[1]), dtype=torch.bool,
                                 device=h.device))
    s = torch.where(mask[None], s, torch.full((), -1e30, dtype=s.dtype,
                                              device=s.device))
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, dim=-1), v)


def _dense_moe_piece(h, p, E: int, C: int):
    """Dense (non-distributed) twin of one seq piece's Megatron block +
    Switch MoE with per-source capacity C. h: [..., rows, d], each leading
    index a piece of its own."""
    dense = torch.tanh(torch.relu(h @ p["w1"]) @ p["w2"])
    gate = torch.softmax(dense @ p["router"], dim=-1)
    expert = gate.argmax(dim=-1)          # the first maximum, as jnp's
    gval = gate.max(dim=-1).values
    onehot = torch.nn.functional.one_hot(expert, E).to(dense.dtype)
    pos = torch.cumsum(onehot, dim=-2) - onehot
    pos_tok = (pos * onehot).sum(dim=-1).to(torch.int32)
    keep = (pos_tok < C).to(dense.dtype)
    eo = torch.stack([
        torch.relu(dense @ p["moe_w1"][e]) @ p["moe_w2"][e]
        for e in range(E)])               # [E, ..., rows, d]
    moe = torch.take_along_dim(eo, expert[None, ..., None], dim=0)[0]
    return dense + moe * (gval * keep)[..., None]


def dense_loss_reference(params: Dict, x, tgt,
                         capacity_factor: float = 4.0,
                         shards: Optional[Dict[str, int]] = None,
                         token_shard_ep: bool = True):
    """Single-device ground truth of the same math, shard-faithfully: the
    per-shard MoE capacity and per-source bucketing are reproduced, so the
    comparison is exact, not merely approximate. With ``token_shard_ep``
    the sequence dim splits over sp·ep pieces, sp-major; otherwise over sp.
    Every piece of a stage (each dp shard, microbatch and sequence piece)
    goes through ``_dense_moe_piece`` at once, each with its own routing,
    so a stage's weights are read once. Params carrying wq/wk/wv open every
    stage with full-sequence causal attention over each sequence
    (``_dense_causal_attention``, the twin of the ring over the token
    ranks); only the MoE then runs by piece. x and tgt: [M, mb, seq, d]
    tensors on the params' device."""
    S, E = params["router"].shape[0], params["router"].shape[2]
    dp = (shards or {}).get("dp", 1)
    sp = (shards or {}).get("sp", 1)
    seq_cuts = sp * ((shards or {}).get("ep", 1) if token_shard_ep else 1)
    M, mb, seq, d = x.shape
    mb_loc = mb // dp
    piece = seq // seq_cuts
    rows = mb_loc * piece
    C = int(math.ceil(rows / E * capacity_factor))

    def pieces(t):  # [M, dp, seq_cuts, rows, d]
        return t.reshape(M, dp, mb_loc, seq_cuts, piece, d).permute(
            0, 1, 3, 2, 4, 5).reshape(M, dp, seq_cuts, rows, d)

    def sequences(h):  # pieces -> [M·dp·mb_loc, seq, d], and back
        return h.reshape(M, dp, seq_cuts, mb_loc, piece, d).permute(
            0, 1, 3, 2, 4, 5).reshape(M * dp * mb_loc, seq, d)

    hm = pieces(x)
    for s in range(S):
        p = {k: v[s] for k, v in params.items()}
        if "wq" in p:
            h = sequences(hm)
            h = h + _dense_causal_attention(h, p["wq"], p["wk"], p["wv"])
            hm = pieces(h.reshape(M, dp * mb_loc, seq, d))
        hm = _dense_moe_piece(hm, p, E, C)
    n_global = M * mb * seq
    return ((hm - pieces(tgt)) ** 2).sum() / n_global / d
