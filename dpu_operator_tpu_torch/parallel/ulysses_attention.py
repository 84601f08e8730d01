"""Ulysses-style sequence parallelism: the all-to-all twin of ring
attention.

Counterpart of the JAX package's ``parallel/ulysses_attention.py``. Q, K
and V arrive sequence-sharded, ``[S/n, H, D]`` a rank; the first
all-to-alls trade the sequence sharding for head sharding, so each rank
holds the whole sequence for H/n heads and runs plain exact attention
locally (softmax over the whole sequence; causal masking is ordinary
tril, global by construction); one more all-to-all trades back. Three
exchanges in, one out, each moving S·H·D/n² per pair of ranks.

The exchanges are ``ring_probe``'s all-to-all: ``kernel_exchange`` (one
launch of ``csrc/all_to_all.cu`` that holds every rank, and one more in
the backward: the adjoint of the all-to-all is the same all-to-all) or
``all_to_all_plain``, which autograd differentiates directly. So Ulysses
is differentiable on either route, as ``jax.grad`` runs through the
reference: a call with a gradient makes 4 exchanges forward and 4
backward. With the n ranks' ``_heads_to_rows`` blocks stacked,
one ``[n·H, S/n·D]`` tensor is exactly the all-to-all's input (rank r's
shard its ``[H, S/n·D]``, blocks of H/n rows), so each exchange is one
call over all ranks.

The local attention (``_full_attention``) is plain PyTorch in f32 whatever
the input type, as the reference leaves it to XLA: it is no kernel of the
reference and none here. It runs one rank at a time (``[H/n, S, S]`` f32
scores each), as each device's program does. Softmax and products stay
f32, and the output is cast to q's type before the inverse exchange, so
Ulysses and ring attention are interchangeable on the same inputs.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch

from .ring_probe import _ring_setup, all_to_all_plain, kernel_exchange


def _heads_to_rows(x):
    """[S_loc, H, D] -> [H, S_loc·D]: head-major rows, the 2D block
    layout the all-to-all exchanges (row block i = head group i)."""
    s, h, d = x.shape
    return x.permute(1, 0, 2).reshape(h, s * d)


def _seq_to_head_shard(x2, n, s_loc, d):
    """Post-exchange reshape: row block j arrived from rank j and carries
    this rank's head group's rows of rank j's sequence shard; stacking the
    source shards in rank order rebuilds the whole sequence.
    [H, S_loc·D] -> [H/n, n·S_loc, D]."""
    h = x2.shape[0]
    return (x2.reshape(n, h // n, s_loc, d)
            .permute(1, 0, 2, 3)
            .reshape(h // n, n * s_loc, d))


def _full_attention(qh, kh, vh, causal: bool):
    """Exact per-head attention over the whole sequence, f32 softmax.
    qh/kh: [h_loc, S, Dk], vh: [h_loc, S, Dv] -> [h_loc, S, Dv] f32."""
    S = qh.shape[1]
    scale = 1.0 / math.sqrt(qh.shape[2])
    s = torch.einsum("hqd,hkd->hqk", qh.float(), kh.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=s.device))
        s = torch.where(mask[None], s,
                        torch.full((), -1e30, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    del s
    return torch.einsum("hqk,hkd->hqd", p, vh.float())


def _ulysses_body(q, k, v, *, a2a, n: int, causal: bool):
    """Every rank's program at once, on whole [S, H, D*] tensors whose
    rank r shard is rows ``r * S/n ..``: exchange -> attend, one rank at a
    time -> exchange back. ``a2a`` is the all-to-all of n ranks on the
    stacked ``[n·H, S/n·D]`` blocks."""
    S, H, dk = q.shape
    dv = v.shape[2]
    if H % n != 0:
        raise ValueError(
            f"Ulysses needs heads to split over the axis: H={H} "
            f"not divisible by {n} (use ring attention below {n} heads)")
    if k.shape != q.shape:
        raise ValueError(f"k shape {k.shape} != q shape {q.shape}")
    if v.shape[:2] != q.shape[:2]:
        raise ValueError(
            f"v leading dims {v.shape[:2]} != q's {q.shape[:2]}")
    if S == 0 or S % n:
        raise ValueError(f"sequence {S} does not cut into {n} equal shards")
    s_loc = S // n
    h_loc = H // n

    def exchange(x):
        """Every rank's [S_loc, H, d] -> its [h_loc, S, d] head shard."""
        d = x.shape[2]
        y = a2a(torch.cat([_heads_to_rows(shard) for shard in x.split(s_loc)]))
        return [_seq_to_head_shard(y[r * H:(r + 1) * H], n, s_loc, d)
                for r in range(n)]

    qh, kh, vh = exchange(q), exchange(k), exchange(v)
    back = []
    for r in range(n):
        out = _full_attention(qh[r], kh[r], vh[r], causal)  # [h_loc, S, dv]
        # Inverse exchange: sequence block j of this rank's head group goes
        # to rank j; rank j receives its sequence block of every head
        # group, which stacks (group-major) back into the original H order.
        back.append(out.to(q.dtype)
                    .reshape(h_loc, n, s_loc, dv)
                    .permute(1, 0, 2, 3)
                    .reshape(H, s_loc * dv))
        del out
    y = a2a(torch.cat(back))
    return (y.reshape(n, n, h_loc, s_loc, dv)
            .permute(0, 3, 1, 2, 4)
            .reshape(S, H, dv))


def make_ulysses_attention(mesh: Mapping[str, int], axis: str = "sp",
                           causal: bool = False, *,
                           kernel: Optional[str] = None, device=None):
    """``fn(q, k, v)``: q, k [S, H, dk] and v [S, H, dv] on ``device``,
    each cut into ``mesh[axis]`` row shards, one per rank (the reference's
    ``P(axis, None, None)``) -> exact multi-head attention [S, H, dv] in
    q's dtype, sharded the same way. Needs H and S to divide by the axis
    size (the head split is the parallelism). ``causal=True`` masks by
    global position, trivially, since each rank sees the whole sequence
    after the exchange. The four exchanges are all-to-alls over the axis:
    ``kernel`` ``"cuda"`` (the default on a CUDA device: one launch of the
    all-to-all kernel each, and one more each in the backward) or
    ``"torch"`` (the default on the CPU: the plain version). Both routes
    are differentiable. ``device`` None means the CUDA card, and raises
    without one."""
    n, device, kernel = _ring_setup(mesh, axis, kernel, device,
                                    "make_ulysses_attention")
    impl = kernel_exchange if kernel == "cuda" else all_to_all_plain

    def a2a(x2):
        return impl(x2, n)

    def fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}; this Ulysses "
                                 f"attention runs on {device}")
            if t.dim() != 3:
                raise ValueError(f"{name} must be [S, H, D], got "
                                 f"{tuple(t.shape)}")
        return _ulysses_body(q, k, v, a2a=a2a, n=n, causal=causal)

    return fn


def dense_attention_reference(q, k, v, causal: bool = False):
    """Single-device ground truth: plain multi-head attention on the whole
    [S, H, D] tensors, f32 softmax -- what both sequence-parallel
    decompositions (ring and Ulysses) must reproduce."""
    out = _full_attention(q.permute(1, 0, 2), k.permute(1, 0, 2),
                          v.permute(1, 0, 2), causal)
    return out.permute(1, 0, 2).to(q.dtype)


def concat_head_partials(parts):
    """Merge per-shard head-sharded attention outputs back into the
    full-head layout: each part is one shard's ``o_r [..., Hr, dh]`` for
    its contiguous head slice, the result is ``[..., H, dh]``: the return
    all-to-all of ``_ulysses_body`` collapsed to a host-side concat, which
    is what it degenerates to when each shard's heads never leave it.
    Per-head attention is independent, so the concat is the exact full
    attention output."""
    import numpy as np

    if not parts:
        raise ValueError("concat_head_partials needs >= 1 partial")
    return np.concatenate([np.asarray(p, np.float32) for p in parts],
                          axis=-2)
