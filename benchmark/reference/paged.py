"""Plain float32 reference of the paged model, with its int8 KV rule.

The model: token embedding plus a learned absolute position (clamped to
the table), one attention block of ``heads`` heads over K/V kept as int8
codes with one scale a block of ``block_size`` positions, the output
projection and a residual, a residual ReLU MLP, and untied logits.

The int8 rule, as the configuration states it: a block's scale is set once,
by the step that writes the block's first position: the largest absolute
K (or V) element over the rows that step writes into the block, times
``margin / 127`` (float32), or 1.0 where that is 0. Every row of the block
is stored as ``round(row / scale)`` clipped to ±127 and read back as
``code * scale``; each position attends over positions up to its own,
itself included, all read back through the codes. A prompt is written in
steps of ``chunk`` positions from its start; each generated token is one
step of one position.

``logits`` runs the whole prompt and the served tokens through in one
pass; only the positions that yield a generated token go on past K/V.
Matmuls run in float32 with TF32 off, unless ``tf32`` asks for the
control's precision.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def write_groups(length: int, prompt_len: int, chunk: int) -> torch.Tensor:
    """The step each position is written by: prompt positions in steps of
    ``chunk`` from 0, then one step a position."""
    pos = torch.arange(length)
    return torch.where(pos < prompt_len, pos // chunk,
                       (prompt_len + chunk - 1) // chunk + pos - prompt_len)


def int8_kv(vals: torch.Tensor, groups: torch.Tensor, block_size: int,
            scale_c: float) -> torch.Tensor:
    """``vals`` [L, H, dh] read back through the int8 codes of the rule."""
    L = vals.shape[0]
    dev = vals.device
    pos = torch.arange(L, device=dev)
    blk = pos // block_size
    groups = groups.to(dev)
    first = groups[blk * block_size]              # the block's first writer
    amax = vals.abs().amax(dim=(1, 2))
    amax = torch.where(groups == first, amax, torch.zeros_like(amax))
    nb = int(blk[-1]) + 1
    bmax = torch.zeros(nb, device=dev).scatter_reduce_(
        0, blk, amax * scale_c, "amax", include_self=True)
    scale = torch.where(bmax > 0, bmax, torch.ones_like(bmax))[blk]
    codes = torch.round(vals / scale[:, None, None]).clamp_(-127, 127)
    return codes * scale[:, None, None]


def logits(W: Dict[str, torch.Tensor], tokens: Sequence[int],
           prompt_len: int, n_out: int, cfg: dict, tf32: bool = False
           ) -> torch.Tensor:
    """[n_out, vocab] float32: the logits at positions ``prompt_len - 1``
    to ``prompt_len + n_out - 2`` of ``tokens`` (the prompt and the served
    tokens but the last)."""
    H, bs, chunk = cfg["heads"], cfg["block_size"], cfg["chunk"]
    T, scale_c = cfg["max_context"], cfg["scale_c"]
    dev = W["embed"].device
    toks = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    L = toks.shape[0]
    d = W["embed"].shape[1]
    dh = d // H
    with matmul_precision(tf32):
        pos = torch.arange(L, device=dev)
        x = W["embed"][toks] + W["wpos"][pos.clamp(0, T - 1)]
        groups = write_groups(L, prompt_len, chunk)
        k = int8_kv((x @ W["wk"]).view(L, H, dh), groups, bs, scale_c)
        v = int8_kv((x @ W["wv"]).view(L, H, dh), groups, bs, scale_c)
        qpos = torch.arange(prompt_len - 1, prompt_len - 1 + n_out,
                            device=dev)
        xq = x[qpos]
        q = (xq @ W["wq"]).view(n_out, H, dh)
        scores = torch.einsum("nhd,lhd->hnl", q, k) / math.sqrt(dh)
        scores = scores.masked_fill(pos[None, None, :] > qpos[None, :, None],
                                    float("-inf"))
        o = torch.einsum("hnl,lhd->nhd", torch.softmax(scores, dim=-1), v)
        y = xq + o.reshape(n_out, d) @ W["wo"]
        y = y + torch.relu(y @ W["w1"]) @ W["w2"]
        return y @ W["wout"]


def gaps(ref: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the best, in units of that
    position's spread of logits (their standard deviation)."""
    best = ref.max(dim=1).values
    got = ref.gather(1, toks.long()[:, None])[:, 0]
    return (best - got) / ref.std(dim=1)


def judge(W, prompt: List[int], served: List[int], cfg: dict,
          control: bool = False) -> dict:
    """The widest gap of the served tokens under the float32 reference;
    with ``control``, also the widest gap of the tokens the TF32 reference
    puts first at the same positions."""
    n = len(served)
    toks = list(prompt) + list(served[:-1])
    ref = logits(W, toks, len(prompt), n, cfg)
    dev = ref.device
    out = {"served": float(gaps(ref, torch.as_tensor(served, device=dev)
                                ).max()), "tokens": n}
    if control:
        low = logits(W, toks, len(prompt), n, cfg, tf32=True)
        out["control"] = float(gaps(ref, low.argmax(dim=1)).max())
    return out
