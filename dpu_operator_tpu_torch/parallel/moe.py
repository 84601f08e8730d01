"""Expert parallelism: the ``ep`` mesh axis, as a Switch mixture of experts.

Counterpart of the JAX package's ``parallel/moe.py``. Each of the E ranks
on the ``ep`` axis hosts ONE expert FFN; tokens are routed by a learned
router, packed into fixed-capacity buckets, exchanged with an all-to-all,
processed by their expert, and exchanged back. Assignments over capacity
drop to zero output (the Switch contract).

Here the E ranks are stacked on one card, as every multi-rank path of the
port runs them: ``y`` is ``[E, rows_local, d]`` (rank r's tokens at
``y[r]``) and the experts are ``[E, d, h]`` / ``[E, h, d]`` (rank r's at
index r). The ranks' ``[E, C, d]`` dispatch buckets, stacked, are one
``[E·E·C, d]`` tensor: rank s's shard its ``[E·C, d]``, cut into E blocks
of C rows, block r for expert r. That is exactly the all-to-all's input,
so each of the two exchanges is one call over all ranks:
``ring_probe.all_to_all_cuda`` (one launch of ``csrc/all_to_all.cu``, the
counterpart of the reference's ``lax.all_to_all(disp, "ep", 0, 0,
tiled=True)``) or ``all_to_all_plain``, each with ``n = E``.

The routing is the reference's, step for step: the capacity ``C =
ceil(top_k·rows/E·cf)`` a source rank; one priority-ordered assignment
stream (every rank-0 assignment of a token before any rank-1); positions
by a cumsum of one-hot rows in ``y``'s dtype; ``keep``, clipped slots, a
scatter-add into the buckets, the expert FFN, the gather and the combine.
``top_k`` ties break toward the lower expert index, as ``lax.top_k``'s do.

Every bucket cell receives at most one live value (kept positions are
unique within an expert's bucket) plus exact zeros, so the scatter-add is
bitwise the same in any order. The combine sums a token's k ranks in rank
order, so repeats are bitwise equal on the card for every ``top_k``.

The expert and router products are plain float32 matmuls, as the
reference leaves them to XLA: they are no kernel of the reference and
none here. Hold the port against it with TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional

import torch

from ..device import resolve_device
from .ring_probe import (MAX_RANKS, _ring_setup, all_to_all_cuda,
                         all_to_all_plain)

Exchange = Callable[[torch.Tensor, int], torch.Tensor]


def pick_exchange(kernel: str, E: int) -> Exchange:
    """The expert exchange of ``kernel``: ``"cuda"`` launches kernel 10
    (``all_to_all_cuda``, which takes the plain version itself for a CPU
    tensor: ``device.pick_kernel`` is what keeps ``"cuda"`` off the CPU),
    ``"torch"`` runs its plain version. The kernel holds at most
    ``ring_probe.MAX_RANKS`` ranks: more raise here, at build time."""
    if kernel == "cuda":
        if E > MAX_RANKS:
            raise ValueError(
                f"ep={E}: the all-to-all kernel holds at most "
                f"{MAX_RANKS} ranks in one launch")
        return all_to_all_cuda
    return all_to_all_plain


def top_k_experts(gate: torch.Tensor, top_k: int):
    """``lax.top_k`` over the last axis: the k largest gates and their
    indices, ties toward the lower index (a stable descending sort; with
    k = 1 the first maximum)."""
    if top_k == 1:
        experts = gate.argmax(dim=-1, keepdim=True)
        return gate.gather(-1, experts), experts
    vals, idx = torch.sort(gate, dim=-1, descending=True, stable=True)
    return vals[..., :top_k], idx[..., :top_k]


def route(y: torch.Tensor, router_w: torch.Tensor, *,
          capacity_factor: float, top_k: int = 1, row_mask=None) -> dict:
    """The routing of ``switch_moe_local`` for ranks stacked as y [E, rows,
    d]: ``C``; the priority-ordered stream's ``expert`` [E, k·rows]
    (rank r of token i at ``r·rows + i``), ``gate`` (raw for k = 1,
    renormalized over the chosen k otherwise), ``pos`` (int32 position in
    the expert's bucket), ``keep`` (y's dtype) and ``slot`` (``pos``
    clipped to C - 1)."""
    E = router_w.shape[1]
    rows = y.shape[1]
    C = int(math.ceil(top_k * rows / E * capacity_factor))
    gate = torch.softmax(y @ router_w, dim=-1)               # [E, rows, E]
    gvals, experts = top_k_experts(gate, top_k)              # [E, rows, k]
    if top_k > 1:
        gvals = gvals / gvals.sum(dim=-1, keepdim=True)
    expert_all = experts.transpose(1, 2).reshape(y.shape[0], -1)
    gate_all = gvals.transpose(1, 2).reshape(y.shape[0], -1)
    onehot = (expert_all[..., None] == torch.arange(
        E, device=y.device)).to(y.dtype)                     # [E, k·rows, E]
    mask_all = None
    if row_mask is not None:
        # Masked rows take no position (consume no capacity) and, with
        # keep zeroed below, leave dispatch and combine.
        mask_all = row_mask.to(y.dtype).repeat(1, top_k)
        onehot = onehot * mask_all[..., None]
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos_a = (pos * onehot).sum(dim=-1).to(torch.int32)
    keep = (pos_a < C).to(y.dtype)
    if mask_all is not None:
        keep = keep * mask_all
    return {"C": C, "expert": expert_all, "gate": gate_all, "pos": pos_a,
            "keep": keep, "slot": pos_a.clamp(0, C - 1)}


def switch_moe_local(y: torch.Tensor, router_w: torch.Tensor,
                     w1: torch.Tensor, w2: torch.Tensor, *,
                     capacity_factor: float, top_k: int = 1,
                     row_mask: Optional[torch.Tensor] = None,
                     exchange: Exchange = all_to_all_plain) -> torch.Tensor:
    """The MoE block of E ranks stacked on one device: y [E, rows, d] (rank
    r's local tokens at ``y[r]``), router_w [d, E], w1 [E, d, h] and w2
    [E, h, d] (rank r's expert at index r); returns [E, rows, d].
    ``row_mask`` ([E, rows] 0/1, optional) drops rows from routing
    entirely: no bucket position, zero output. ``exchange(x, n)`` is the
    all-to-all of n ranks on x [n·rows, W] (``pick_exchange``)."""
    R, rows, d = y.shape
    E = router_w.shape[1]
    rt = route(y, router_w, capacity_factor=capacity_factor, top_k=top_k,
               row_mask=row_mask)
    C = rt["C"]
    tok_all = torch.arange(rows, device=y.device).repeat(top_k)
    # Linear bucket cell of each assignment in the stacked [R, E, C]
    # buckets of every source rank.
    base = torch.arange(R, device=y.device)[:, None] * (E * C)
    cell = (base + rt["expert"] * C + rt["slot"]).reshape(-1)
    sent = (y[:, tok_all] * rt["keep"][..., None]).reshape(-1, d)
    disp = y.new_zeros((R * E * C, d)).index_add_(0, cell, sent)
    recv = exchange(disp, E)            # rank r: [E sources, C, d]
    hid = torch.relu(torch.bmm(recv.view(R, E * C, d), w1))
    out = torch.bmm(hid, w2).reshape(R * E * C, d)
    back = exchange(out, E)             # rank r: [E experts, C, d]
    contrib = (back.index_select(0, cell).view(R, top_k * rows, d)
               * (rt["gate"] * rt["keep"])[..., None])
    moe = torch.zeros_like(y)
    for r in range(top_k):  # ranks summed in order: repeats are bitwise
        moe = moe + contrib[:, r * rows:(r + 1) * rows]
    return moe


def _check_experts(E: int, axis: str, w1: torch.Tensor, w2: torch.Tensor,
                   router_w: torch.Tensor) -> None:
    """The reference's per-device checks, on experts stacked over E
    ranks: each rank hosts exactly one expert and the router is E wide."""
    if w1.shape[0] != E or w2.shape[0] != E:
        raise ValueError(
            f"expert count must equal mesh.shape[{axis!r}]={E}: each "
            f"device hosts exactly one expert, got a local chunk of "
            f"{_local_chunk(w1.shape[0], E)}")
    if router_w.shape[1] != E:
        raise ValueError(
            f"router width {router_w.shape[1]} != {E} experts — "
            f"tokens routed past the mesh would silently drop")


def _local_chunk(experts: int, E: int):
    """Experts a rank holds when ``experts`` are split over E ranks."""
    return experts // E if experts % E == 0 else experts / E


def make_moe(mesh: Mapping[str, int], axis: str = "ep",
             capacity_factor: float = 2.0, top_k: int = 1, *,
             kernel: Optional[str] = None, device=None):
    """Returns moe(x, router_w, w1_stacked, w2_stacked) on ``device``:
      x          [tokens, d], sharded over the ``axis`` ranks (rank r
                  routes rows ``r·tokens/E ..``); tokens divide by E.
      router_w   [d, E]
      w1_stacked [E, d, h], w2_stacked [E, h, d] (rank r's expert at r)
    Output [tokens, d], sharded like x. top_k=1 (Switch): raw gate × the
    argmax expert; top_k>1: the renormalized-gate sum over the token's k
    best experts, rank-0 assignments winning bucket slots first. Capacity
    is per source rank and scales with k; dropped assignments contribute
    zero. ``mesh`` maps axis names to sizes; ``kernel`` ``"cuda"`` (the
    default on a CUDA device: the all-to-all kernel) or ``"torch"`` (the
    default on the CPU: its plain version); ``device`` None means the
    CUDA card, and raises without one."""
    E, device, kernel = _ring_setup(mesh, axis, kernel, device, "make_moe")
    if not 1 <= top_k <= E:
        raise ValueError(
            f"top_k={top_k} must be in [1, {E}] (the {axis!r} axis size): "
            f"a token cannot be routed to more experts than exist")
    exchange = pick_exchange(kernel, E)

    def moe(x, router_w, w1_stacked, w2_stacked):
        for name, t in (("x", x), ("router_w", router_w),
                        ("w1_stacked", w1_stacked),
                        ("w2_stacked", w2_stacked)):
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}; this MoE runs "
                                 f"on {device}")
        _check_experts(E, axis, w1_stacked, w2_stacked, router_w)
        if x.shape[0] % E:
            raise ValueError(f"{x.shape[0]} tokens do not shard over "
                             f"{axis}={E}")
        y = switch_moe_local(
            x.reshape(E, x.shape[0] // E, x.shape[1]), router_w,
            w1_stacked, w2_stacked, capacity_factor=capacity_factor,
            top_k=top_k, exchange=exchange)
        return y.reshape(x.shape)

    return moe


def dense_reference(x, router_w, w1_stacked, w2_stacked, top_k: int = 1):
    """Ground truth with capacity = ∞ and every expert computed densely:
    y[i] = Σ_{e in top-k} renorm_gate[i,e] * FFN_e(x[i])."""
    gate = torch.softmax(x @ router_w, dim=-1)
    gvals, experts = top_k_experts(gate, top_k)              # [t, k]
    if top_k > 1:
        gvals = gvals / gvals.sum(dim=-1, keepdim=True)
    h = torch.relu(torch.einsum("td,edh->eth", x, w1_stacked))
    all_out = torch.einsum("eth,ehd->etd", h, w2_stacked)    # [E, t, d]
    y = torch.zeros_like(x)
    for r in range(top_k):
        yr = torch.take_along_dim(
            all_out, experts[None, :, r, None], dim=0)[0]    # [t, d]
        y = y + yr * gvals[:, r, None]
    return y


def shard_expert_params(w_stacked: torch.Tensor, mesh: Mapping[str, int],
                        axis: str = "ep") -> torch.Tensor:
    """The reference places rank r's expert on device r; with the ranks
    stacked on one card the stacked tensor already is that placement."""
    if w_stacked.shape[0] % int(mesh[axis]):
        raise ValueError(f"{w_stacked.shape[0]} experts do not shard over "
                         f"{axis}={mesh[axis]}")
    return w_stacked


def demo_moe_params(E: int, d: int, h: int, seed: int = 0, device=None):
    """(router_w [d, E], w1 [E, d, h], w2 [E, h, d]) drawn from a seeded
    ``torch.Generator`` on ``device`` (None means the CUDA card). The
    reference's ``jax.random`` draws are not reproduced: hold the two
    packages against each other on weights carried across."""
    device = resolve_device(device, "demo_moe_params")
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    return (normal(d, E) / math.sqrt(d), normal(E, d, h) / math.sqrt(d),
            normal(E, h, d) / math.sqrt(h))
