"""Device-resident paged-attention decode step, in PyTorch.

Counterpart of the JAX package's ``serving/kvcache/paged.py`` (the chain
step). K/V live in flat ``[num_blocks, block_size, heads, d_head]`` pools
that never leave the device, indexed through per-slot block tables from
the host allocator. One step, per ``[slots, chunk]`` token window:

  * token + absolute-position embedding, q/k/v projections;
  * the per-block int8 scale update (set once, by the step that writes
    the block's row 0), run in PyTorch for both kernels so both quantize
    with bit-identical scales;
  * the fused quantize-append + page gather + per-row causal attention:
    ``kernel="cuda"`` launches the hand-written Hopper kernel
    (``parallel/paged_attn.py``), ``kernel="torch"`` runs its plain
    version;
  * output projection, a residual ReLU MLP, untied-head logits and the
    argmax of the last written row: the ``[slots]`` int32 token ids.

``per_pos=True`` (speculative verify) takes the argmax of EVERY chunk
row instead, ``[slots, chunk]`` int32: ``out[s, j]`` is the target's
next token after consuming input ``j``. The fused call is the same; a
chain verify window is exactly the per-row causal attention the kernel
computes over the ``n_new`` appended rows. ``take_prev`` picks the row
the next pipelined window chains on.

``tree=True`` (needs ``per_pos``) adds ``tree_step`` for token-tree
verify windows: sibling rows share a position and must not see each
other's branch, a mask that is not monotone in the row, which the fused
kernel (one per-row softmax over the pool) cannot express. So
``tree_step`` is the reference's composition written in PyTorch, under
every kernel setting, and a tree-armed executor routes every step
through it; it launches no paged-attention kernel.

A context-parallel replica (``sharded.py``) splits the step: each rank's
``PagedRankStep`` embeds and projects the window at full width, keeps
the scale rule, and appends and attends over its slice of the pools (a
head slice through the same fused call, or a block range in the plain
composition, returning flash partials); the coordinator's
``PagedFinishStep`` runs the tail over the merged attention. All three
share ``_PagedModel``'s weights and arithmetic.

Unlike the reference, whose jitted step returns new (donated) arrays,
this step updates the pools and scales IN PLACE and returns the same
tensors. Callers order other pool reads and writes on the step's stream
(see ``PagedKVExecutor``).

Matmul precision: the reference runs float32 matmuls in full precision.
Hold the port against it (or the kernel against its plain version) with
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``: TF32 would move logits by far
more than the kernel's reassociation does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...device import pick_kernel, resolve_device
from ...parallel.paged_attn import (NEG, _quantize_rows,
                                    _scatter_rows_drop,
                                    paged_attn_step_cuda,
                                    paged_attn_step_plain)
from ...parallel.quantize import int8_block_decode, int8_block_decode_np

#: One weight set per (seed, vocab, d, max_context, hidden) identity, as
#: numpy arrays, shared by every step built from it.
_PARAM_CACHE: dict = {}

PARAM_NAMES = ("embed", "wpos", "wq", "wk", "wv", "wo", "w1", "w2", "wout")


def build_paged_params(seed: int, vocab: int, d: int, max_context: int,
                       hidden: Optional[int] = None
                       ) -> Dict[str, np.ndarray]:
    """The paged model's weights as float32 numpy arrays, in the
    reference's draw order (embed, wpos, wq, wk, wv, wo, w1, w2, wout).
    Each float32 draw is divided by ``sqrt(rows)`` in float64 and then
    rounded to float32 — what the reference's numpy-2 division followed
    by ``jnp.asarray`` does — spelled out so the result does not depend
    on the numpy version. Cached per identity."""
    hidden = int(hidden or 2 * d)
    key = (int(seed), int(vocab), int(d), int(max_context), hidden)
    got = _PARAM_CACHE.get(key)
    if got is not None:
        return got
    rng = np.random.RandomState(seed)

    def w(*shape):
        x = rng.randn(*shape).astype(np.float32).astype(np.float64)
        return (x / np.sqrt(float(shape[0]))).astype(np.float32)

    params = dict(
        embed=w(vocab, d), wpos=w(max_context, d),
        wq=w(d, d), wk=w(d, d), wv=w(d, d), wo=w(d, d),
        w1=w(d, hidden), w2=w(hidden, d), wout=w(d, vocab))
    _PARAM_CACHE[key] = params
    return params


def params_from_numpy(params: Dict[str, np.ndarray], device
                      ) -> Dict[str, torch.Tensor]:
    """The reference's parameters as numpy arrays (``np.asarray`` of each
    entry of its ``build_paged_params``) -> float32 tensors on
    ``device``."""
    return {k: torch.from_numpy(np.array(params[k], np.float32))
            .to(device) for k in PARAM_NAMES}


def kv_bytes_per_slot(max_blocks_per_req: int, block_size: int,
                      heads: int, d_head: int,
                      pool_dtype: str = "int8") -> int:
    """Resident KV bytes one slot's worst-case reservation pins:
    ``max_blocks_per_req`` blocks of K and V rows plus their per-block
    scale floats."""
    elems = block_size * heads * d_head
    itemsize = 1 if pool_dtype == "int8" else 4
    return max_blocks_per_req * 2 * (elems * itemsize + 4)


def paged_kv_error_bound(scale: float, amax: float) -> float:
    """Per-element absolute error bound of one resident int8 KV element
    against its fp32 truth: ``scale / 2`` of rounding plus whatever a row
    exceeds the block's first-write range by (it clips at
    ``127 * scale``)."""
    return scale / 2.0 + max(0.0, amax - 127.0 * scale)


class _PagedModel(nn.Module):
    """What every step over the paged model shares: its nine weights as
    buffers, the window's embedding and projections, the set-once
    per-block scale rule and the tail after attention (output
    projection, residual MLP, logits, argmax). ``PagedDecodeStep`` runs
    all of it; a context-parallel replica splits it between its ranks'
    ``PagedRankStep`` (embedding, projections, scales, attention over
    the rank's slice) and the coordinator's ``PagedFinishStep`` (the
    tail over the merged attention), so each piece of arithmetic has
    one copy.

    ``params`` is a dict of the nine weights (numpy arrays or tensors);
    without it the weights are drawn from ``seed``. A float32 tensor
    already on ``device`` becomes the buffer itself, not a copy, so
    steps built from one dict share one set of weights."""

    def __init__(self, slots: int, vocab: int, d: int, heads: int,
                 block_size: int, max_blocks_per_req: int, chunk: int,
                 hidden: Optional[int], seed: int,
                 params: Optional[dict], device: torch.device,
                 per_pos: bool, scale_margin: float = 1.5):
        super().__init__()
        self.device = device
        self.per_pos = bool(per_pos)
        self.scale_margin = float(scale_margin)
        self.slots = int(slots)
        self.vocab = int(vocab)
        self.d = int(d)
        self.heads = int(heads)
        self.d_head = d // heads
        self.block_size = int(block_size)
        self.max_blocks_per_req = int(max_blocks_per_req)
        self.chunk = int(chunk)
        # The reference multiplies by np.float32(margin / 127.0): the
        # quotient is taken in float64, then rounded once to float32.
        self._scale_c = float(np.float32(self.scale_margin / 127.0))
        if params is None:
            params = build_paged_params(seed, vocab, d,
                                        max_blocks_per_req * block_size,
                                        hidden)
        for name in PARAM_NAMES:
            w = params[name]
            if not isinstance(w, torch.Tensor):
                w = torch.from_numpy(np.array(w, np.float32))
            self.register_buffer(name, w.to(device=device,
                                            dtype=torch.float32))
        S, C, B = self.slots, self.chunk, self.max_blocks_per_req
        self.register_buffer("_rows", torch.arange(C, device=device))
        # fp32 pools carry no scales: the fused call gets all-ones.
        self.register_buffer("_ones_rows",
                             torch.ones((S, C), device=device))
        self.register_buffer("_ones_tbl", torch.ones((S, B), device=device))

    @property
    def draft_params(self):
        """(embed, wpos, wout): the weights the truncated-stage draft
        (spec.TruncatedDraft) reuses, so draft and target share one
        token space by construction."""
        return self.embed, self.wpos, self.wout

    def _embed(self, prev_tok, host_tok, use_host, pos):
        """Token + absolute-position embedding of the window, [S, C, d].
        Row 0 of the window is the only row the device recurrence can
        feed; the others come from the host."""
        T = self.max_blocks_per_req * self.block_size
        tok0 = torch.where(use_host, host_tok[:, 0], prev_tok)
        toks = torch.cat([tok0[:, None], host_tok[:, 1:]], dim=1).long()
        return self.embed[toks] + self.wpos[torch.clamp(pos, 0, T - 1)]

    def _project(self, prev_tok, host_tok, use_host, pos):
        """The window's embedding and its FULL-head q/k/v projections."""
        S, C, H, dh = self.slots, self.chunk, self.heads, self.d_head
        x = self._embed(prev_tok, host_tok, use_host, pos)
        q = (x @ self.wq).reshape(S, C, H, dh)
        k = (x @ self.wk).reshape(S, C, H, dh)
        v = (x @ self.wv).reshape(S, C, H, dh)
        return x, q, k, v

    def _update_scales(self, scales, vals, blk, pos, valid, ctx) -> None:
        """Per-block scale, set once by the step that writes the block's
        row 0 (``bstart >= ctx``): reset the touched blocks, then
        scatter-max the group amax. ``blk`` indexes ``scales``; rows
        that are idle, or aim at ``len(scales)`` (a block this pool does
        not hold), go to a sink entry past the end (the reference drops
        them). ``vals`` is the full-head k or v, so every pool that
        holds a block stores the single pool's scale for it. The
        all-zero group gets scale 1.0. In place."""
        N, bs = scales.shape[0], self.block_size
        bstart = (pos // bs) * bs
        reset = valid & (bstart >= ctx[:, None])
        amax = vals.abs().amax(dim=(2, 3))                     # [S, C]
        tgt = torch.where(reset, blk, N).reshape(-1)
        ext = torch.cat([scales, scales.new_zeros(1)])
        ext.index_fill_(0, tgt, 0.0)
        ext.scatter_reduce_(0, tgt, (amax * self._scale_c).reshape(-1),
                            "amax", include_self=True)
        new = ext[:N]
        scales.copy_(torch.where(new > 0, new, torch.ones_like(new)))

    def _tail(self, x, o, n_new) -> torch.Tensor:
        """Output projection, residual ReLU MLP, untied-head logits and
        argmax over the attention output ``o [S, C, d]``: [S] int32 of
        the last written row, or [S, C] int32 of every row with
        ``per_pos`` (speculative verify; rows past n_new are garbage
        the collect path never reads)."""
        S, C = self.slots, self.chunk
        y = x + o @ self.wo
        y = y + torch.relu(y @ self.w1) @ self.w2
        if self.per_pos:
            return self._argmax_rows(y)
        last = torch.clamp(n_new.long() - 1, 0, C - 1)
        yl = torch.gather(y, 1, last[:, None, None].expand(S, 1, self.d)
                          )[:, 0]                              # [S, d]
        return torch.argmax(yl @ self.wout, dim=1).to(torch.int32)

    def _argmax_rows(self, y) -> torch.Tensor:
        """[S, C] int32: the argmax of ``y @ wout`` for every row."""
        return torch.argmax(y @ self.wout, dim=2).to(torch.int32)


class PagedDecodeStep(_PagedModel):
    """The fused chunk step over the paged KV pools, weights held as
    buffers. ``params`` is a dict of the nine weights (numpy arrays or
    tensors); without it the weights are drawn from ``seed``.

    ``device=None`` means the CUDA card (see ``resolve_device``).
    ``kernel=None`` means the hand-written kernel (``"cuda"``) on a CUDA
    device and its plain version (``"torch"``) on the CPU;
    ``kernel="cuda"`` on the CPU raises. ``per_pos`` and ``tree`` are
    fixed at construction (see the module docstring)."""

    def __init__(self, slots: int, vocab: int, d: int, heads: int,
                 block_size: int, num_blocks: int,
                 max_blocks_per_req: int, chunk: int,
                 hidden: Optional[int] = None, seed: int = 0,
                 params: Optional[dict] = None,
                 kernel: Optional[str] = None,
                 pool_dtype: str = "int8",
                 scale_margin: float = 1.5, device=None,
                 per_pos: bool = False, tree: bool = False):
        if d % heads:
            raise ValueError(f"d={d} must divide by heads={heads}")
        if tree and not per_pos:
            raise ValueError("tree verify windows need per_pos=True "
                             "(per-position argmax is the verify "
                             "contract)")
        device = resolve_device(device, "PagedDecodeStep")
        kernel = pick_kernel(kernel, device)
        if pool_dtype not in ("int8", "fp32"):
            raise ValueError(f"pool_dtype must be int8|fp32, got "
                             f"{pool_dtype!r}")
        super().__init__(slots, vocab, d, heads, block_size,
                         max_blocks_per_req, chunk, hidden, seed, params,
                         device, per_pos, scale_margin)
        self.kernel = kernel
        self.pool_dtype = pool_dtype
        self.tree = bool(tree)
        self.num_blocks = int(num_blocks)

    def init_pools(self):
        """Fresh zeroed (kpool, kscale, vpool, vscale): int8 codes +
        per-block scales, or fp32 rows + all-ones scales."""
        shape = (self.num_blocks, self.block_size, self.heads, self.d_head)
        dtype = torch.int8 if self.pool_dtype == "int8" else torch.float32
        return (torch.zeros(shape, dtype=dtype, device=self.device),
                torch.ones((self.num_blocks,), device=self.device),
                torch.zeros(shape, dtype=dtype, device=self.device),
                torch.ones((self.num_blocks,), device=self.device))

    def init_prev(self) -> torch.Tensor:
        """Zeroed [slots] int32 token recurrence."""
        return torch.zeros((self.slots,), dtype=torch.int32,
                           device=self.device)

    def kv_bytes_per_slot(self) -> int:
        """Resident KV bytes one slot's worst-case reservation pins: the
        module-level ``kv_bytes_per_slot`` on this step's layout."""
        return kv_bytes_per_slot(self.max_blocks_per_req, self.block_size,
                                 self.heads, self.d_head, self.pool_dtype)

    def dequantized_pools(self, kpool, kscale, vpool, vscale):
        """Host-side fp32 view of resident pools (numpy)."""
        k, v = kpool.cpu().numpy(), vpool.cpu().numpy()
        if self.pool_dtype != "int8":
            return k, v
        return (int8_block_decode_np(k, kscale.cpu().numpy()),
                int8_block_decode_np(v, vscale.cpu().numpy()))

    def forward(self, kpool, kscale, vpool, vscale, prev_tok, host_tok,
                use_host, ctx, n_new, tables):
        """(kpool, kscale, vpool, vscale, out_tokens): the pools and
        scales are the arguments, updated in place; ``out_tokens`` is
        [slots] int32 ([slots, chunk] with ``per_pos``), still in flight
        on the device."""
        S, C = self.slots, self.chunk
        B, bs = self.max_blocks_per_req, self.block_size
        H, dh = self.heads, self.d_head
        int8 = self.pool_dtype == "int8"
        ctx_l = ctx.long()
        pos = ctx_l[:, None] + self._rows[None, :]             # [S, C]
        x, q, k, v = self._project(prev_tok, host_tok, use_host, pos)
        valid = self._rows[None, :] < n_new.long()[:, None]
        blk_all = torch.gather(tables.long(), 1,
                               torch.clamp(pos // bs, 0, B - 1))
        if int8:
            self._update_scales(kscale, k, blk_all, pos, valid, ctx_l)
            self._update_scales(vscale, v, blk_all, pos, valid, ctx_l)
            ksc_rows, vsc_rows = kscale[blk_all], vscale[blk_all]
            tl = tables.long()
            ksc_tbl, vsc_tbl = kscale[tl], vscale[tl]
        else:
            ksc_rows = vsc_rows = self._ones_rows
            ksc_tbl = vsc_tbl = self._ones_tbl
        fused = (paged_attn_step_cuda if self.kernel == "cuda"
                 else paged_attn_step_plain)
        o = fused(tables, ctx, n_new, q, k, v, ksc_rows, vsc_rows,
                  ksc_tbl, vsc_tbl, kpool, vpool).reshape(S, C, H * dh)
        return kpool, kscale, vpool, vscale, self._tail(x, o, n_new)

    def tree_step(self, kpool, kscale, vpool, vscale, prev_tok, host_tok,
                  use_host, ctx, n_new, tables, roff, n_app, plim, win):
        """Token-tree verify step (``tree=True``): rows carry an explicit
        position offset (siblings share the first trunk position), only
        the first ``n_app`` rows APPEND (score-only sibling rows write
        nothing), pool attention is bounded per row by ``plim`` and the
        in-window mask ``win`` wires row-to-row attention over the
        step's FRESH K/V, the only path a score-only row has to its own
        key and value. One softmax runs over the pool and in-window
        columns together. Pools and scales are updated in place; the
        output is the [S, C] int32 per-row argmax."""
        if not self.tree:
            raise RuntimeError("tree_step needs a step built with "
                               "tree=True")
        S, C = self.slots, self.chunk
        B, bs = self.max_blocks_per_req, self.block_size
        H, dh = self.heads, self.d_head
        T = B * bs
        int8 = self.pool_dtype == "int8"
        ctx_l = ctx.long()
        pos = ctx_l[:, None] + roff.long()                     # [S, C]
        x, q, k, v = self._project(prev_tok, host_tok, use_host, pos)
        app = self._rows[None, :] < n_app.long()[:, None]
        tl = tables.long()
        blk_all = torch.gather(tl, 1, torch.clamp(pos // bs, 0, B - 1))
        off = pos % bs
        if int8:
            self._update_scales(kscale, k, blk_all, pos, app, ctx_l)
            self._update_scales(vscale, v, blk_all, pos, app, ctx_l)
            ksc_rows, vsc_rows = kscale[blk_all], vscale[blk_all]
            _scatter_rows_drop(kpool, blk_all, off, app,
                               _quantize_rows(k, ksc_rows))
            _scatter_rows_drop(vpool, blk_all, off, app,
                               _quantize_rows(v, vsc_rows))
            keys = int8_block_decode(kpool[tl], kscale[tl])
            vals = int8_block_decode(vpool[tl], vscale[tl])
        else:
            _scatter_rows_drop(kpool, blk_all, off, app, k)
            _scatter_rows_drop(vpool, blk_all, off, app, v)
            keys, vals = kpool[tl], vpool[tl]
        keys = keys.reshape(S, T, H, dh)
        vals = vals.reshape(S, T, H, dh)
        limit = ctx_l + n_app.long()
        tpos = torch.arange(T, device=pos.device)
        t_ok = (tpos[None, :] < limit[:, None])[:, :, None, None]
        zero = torch.zeros((), dtype=keys.dtype, device=pos.device)
        keys = torch.where(t_ok, keys, zero)
        vals = torch.where(t_ok, vals, zero)
        neg = torch.full((), NEG, dtype=keys.dtype, device=pos.device)
        scores = torch.einsum("schd,sthd->shct", q, keys) / math.sqrt(dh)
        causal = tpos[None, None, :] < plim.long()[:, :, None]
        scores = torch.where(causal[:, None, :, :], scores, neg)
        swin = torch.einsum("schd,swhd->shcw", q, k) / math.sqrt(dh)
        swin = torch.where(win[:, None, :, :], swin, neg)
        # One softmax over pool + in-window columns: masked columns
        # underflow to exact 0.0 weight, and a fully masked (invalid)
        # row degrades to a uniform distribution over garbage the
        # collect path never reads.
        attn = torch.softmax(torch.cat([scores, swin], dim=-1), dim=-1)
        vfull = torch.cat([vals, v], dim=1)
        o = torch.einsum("shct,sthd->schd", attn, vfull).reshape(
            S, C, H * dh)
        return kpool, kscale, vpool, vscale, self._tail(x, o, n_app)

    def take_prev(self, out, n_app, prev) -> torch.Tensor:
        """The pipelined-speculation chain gather: the NEXT verify
        window's base row chains on the trunk LEAF's output (the
        window's bonus under full acceptance), row ``n_app - 1`` of the
        per-position argmax. Rows that planned nothing keep their
        previous chain value."""
        if not self.per_pos:
            raise RuntimeError("take_prev needs per_pos=True")
        n = n_app.long()
        idx = torch.clamp(n - 1, 0, self.chunk - 1)
        leaf = torch.gather(out, 1, idx[:, None])[:, 0]
        return torch.where(n > 0, leaf, prev).to(torch.int32)


class PagedRankStep(_PagedModel):
    """ONE rank's half of the fused paged step in a context-parallel
    replica: append into this rank's pool slice, attend over this rank's
    residency, return un-finished attention. The embedding and the
    q/k/v projections are REPLICATED on every rank (O(chunk * d) a
    step); the pools, the appends and the attention gather (the
    O(context) parts) are sharded, so resident context a replica holds
    grows with its world size.

    The slice bounds come IN from the replica's ``KVSpec``
    (``rank_heads`` / ``rank_blocks``) and are never derived here:

    ``shard_axis="head"``
        pool ``[num_blocks, bs, Hr, dh]``: every block id, a contiguous
        head slice of each. A head's attention is complete on its rank,
        so the rank returns ``o_r [S, C, Hr, dh]``, the exact output of
        its heads: the fused call at ``H = Hr``, the hand-written kernel
        on the card.
    ``shard_axis="page"``
        pool ``[Nr, bs, H, dh]``: every head of the global block-id
        range ``block_bounds``. The rank attends its own pages only, in
        the reference's plain composition with block ownership folded
        into the valid-block guard, and returns un-normalized flash
        partials ``(m [S, H, C], l [S, H, C], o [S, H, C, dh])``; a rank
        that owns nothing for a row returns the fold identity ``(-1e30,
        0, 0)``. The coordinator folds them in rank order
        (``merge_partial_softmax``). The fused kernel normalizes its
        softmax, so ``kernel="cuda"`` raises on this axis.

    int8 pools: the per-block scale rule reads the FULL-head k and v, so
    every rank's scale for a block equals the single pool's, and a head
    slice quantized under it is that slice of the single pool's codes.

    ``kernel=None`` means ``"cuda"`` for a head rank on a CUDA device and
    ``"torch"`` otherwise; ``kernel="cuda"`` on the CPU raises. Pools and
    scales are updated in place, as ``PagedDecodeStep`` does."""

    def __init__(self, slots: int, vocab: int, d: int, heads: int,
                 block_size: int, num_blocks: int,
                 max_blocks_per_req: int, chunk: int, *,
                 shard_axis: str, head_bounds: Tuple[int, int],
                 block_bounds: Tuple[int, int],
                 hidden: Optional[int] = None, seed: int = 0,
                 params: Optional[dict] = None,
                 kernel: Optional[str] = None,
                 pool_dtype: str = "int8",
                 scale_margin: float = 1.5, device=None):
        if shard_axis not in ("head", "page"):
            raise ValueError(f"shard_axis must be head|page, got "
                             f"{shard_axis!r}")
        if pool_dtype not in ("int8", "fp32"):
            raise ValueError(f"pool_dtype must be int8|fp32, got "
                             f"{pool_dtype!r}")
        if d % heads:
            raise ValueError(f"d={d} must divide by heads={heads}")
        device = resolve_device(device, "PagedRankStep")
        if kernel is None:
            kernel = ("cuda" if device.type == "cuda"
                      and shard_axis == "head" else "torch")
        if kernel == "cuda" and shard_axis == "page":
            raise ValueError(
                "the fused cuda kernel normalizes its softmax; "
                "page-sharded ranks return flash partials (kernel="
                "'torch')")
        kernel = pick_kernel(kernel, device)
        super().__init__(slots, vocab, d, heads, block_size,
                         max_blocks_per_req, chunk, hidden, seed, params,
                         device, False, scale_margin)
        self.kernel = kernel
        self.shard_axis = shard_axis
        self.pool_dtype = pool_dtype
        self.num_blocks = int(num_blocks)
        h_lo, h_hi = int(head_bounds[0]), int(head_bounds[1])
        b_lo, b_hi = int(block_bounds[0]), int(block_bounds[1])
        self.head_bounds = (h_lo, h_hi)
        self.block_bounds = (b_lo, b_hi)
        #: Local pool geometry, all of it from the bounds the KVSpec
        #: derived.
        self.pool_heads = (h_hi - h_lo if shard_axis == "head"
                           else self.heads)
        self.pool_blocks = (b_hi - b_lo if shard_axis == "page"
                            else self.num_blocks)

    def init_pools(self):
        """Fresh zeroed per-rank (kpool, kscale, vpool, vscale)."""
        shape = (self.pool_blocks, self.block_size, self.pool_heads,
                 self.d_head)
        dtype = torch.int8 if self.pool_dtype == "int8" else torch.float32
        return (torch.zeros(shape, dtype=dtype, device=self.device),
                torch.ones((self.pool_blocks,), device=self.device),
                torch.zeros(shape, dtype=dtype, device=self.device),
                torch.ones((self.pool_blocks,), device=self.device))

    def forward(self, kpool, kscale, vpool, vscale, prev_tok, host_tok,
                use_host, ctx, n_new, tables):
        """head axis: ``(pools..., o_r [S, C, Hr, dh])``; page axis:
        ``(pools..., m [S, H, C], l [S, H, C], o [S, H, C, dh])``. The
        pools and scales are the arguments, updated in place."""
        B, bs = self.max_blocks_per_req, self.block_size
        Nr = self.pool_blocks
        int8 = self.pool_dtype == "int8"
        head = self.shard_axis == "head"
        ctx_l = ctx.long()
        pos = ctx_l[:, None] + self._rows[None, :]             # [S, C]
        # FULL-head projections: the scale rule needs the whole row's
        # amax, and decode's one token makes this the O(d) part.
        _, q, k, v = self._project(prev_tok, host_tok, use_host, pos)
        valid = self._rows[None, :] < n_new.long()[:, None]
        tl = tables.long()
        blk_all = torch.gather(tl, 1, torch.clamp(pos // bs, 0, B - 1))
        if head:
            # Every block id is local; local id == global id.
            lblk_all, ltab, owned_tab = blk_all, tl, None
        else:
            b_lo, b_hi = self.block_bounds
            owned = (blk_all >= b_lo) & (blk_all < b_hi)
            lblk_all = torch.where(owned, blk_all - b_lo, Nr)
            owned_tab = (tl >= b_lo) & (tl < b_hi)
            ltab = torch.where(owned_tab, tl - b_lo, 0)
        # In range for every row; only owned valid rows write there.
        lblk = torch.clamp(lblk_all, 0, Nr - 1)
        if int8:
            self._update_scales(kscale, k, lblk_all, pos, valid, ctx_l)
            self._update_scales(vscale, v, lblk_all, pos, valid, ctx_l)
            ksc_rows, vsc_rows = kscale[lblk], vscale[lblk]
            ksc_tbl, vsc_tbl = kscale[ltab], vscale[ltab]
        else:
            ksc_rows = vsc_rows = self._ones_rows
            ksc_tbl = vsc_tbl = self._ones_tbl
        if head:
            h_lo, h_hi = self.head_bounds
            # The kernel takes contiguous tensors only.
            qw, kw, vw = (t[:, :, h_lo:h_hi].contiguous()
                          for t in (q, k, v))
            fused = (paged_attn_step_cuda if self.kernel == "cuda"
                     else paged_attn_step_plain)
            o = fused(tables, ctx, n_new, qw, kw, vw, ksc_rows, vsc_rows,
                      ksc_tbl, vsc_tbl, kpool, vpool)
            return kpool, kscale, vpool, vscale, o
        # Page axis: the reference's plain composition over the rank's
        # own pages. Rows this rank does not own, or that are idle,
        # append nothing.
        S, C, H, dh = q.shape
        T = B * bs
        mine = valid & owned
        off = pos % bs
        if int8:
            _scatter_rows_drop(kpool, lblk, off, mine,
                               _quantize_rows(k, ksc_rows))
            _scatter_rows_drop(vpool, lblk, off, mine,
                               _quantize_rows(v, vsc_rows))
            keys = int8_block_decode(kpool[ltab], ksc_tbl)
            vals = int8_block_decode(vpool[ltab], vsc_tbl)
        else:
            _scatter_rows_drop(kpool, lblk, off, mine, k)
            _scatter_rows_drop(vpool, lblk, off, mine, v)
            keys, vals = kpool[ltab], vpool[ltab]
        keys = keys.reshape(S, T, H, dh)
        vals = vals.reshape(S, T, H, dh)
        # The single-worker valid-block guard, with block OWNERSHIP
        # folded in: positions outside this rank's pages contribute
        # nothing on either the score or the value path.
        limit = ctx_l + n_new.long()
        tpos = torch.arange(T, device=pos.device)
        owned_pos = owned_tab.repeat_interleave(bs, dim=1)      # [S, T]
        t_ok = (tpos[None, :] < limit[:, None]) & owned_pos
        zero = torch.zeros((), dtype=keys.dtype, device=pos.device)
        keys = torch.where(t_ok[:, :, None, None], keys, zero)
        vals = torch.where(t_ok[:, :, None, None], vals, zero)
        scores = torch.einsum("schd,sthd->shct", q, keys) / math.sqrt(dh)
        causal = ((tpos[None, None, :] <= pos[:, :, None])
                  & (tpos[None, None, :] < limit[:, None, None])
                  & valid[:, :, None]
                  & owned_pos[:, None, :])                      # [S, C, T]
        scores = torch.where(causal[:, None, :, :], scores,
                             torch.full((), NEG, device=pos.device))
        # A rank that owns NOTHING for a row keeps (m=-1e30, l=0, o=0),
        # which the coordinator's fold treats as the identity.
        m = scores.amax(dim=-1)                                 # [S, H, C]
        p = torch.where(scores > -1e29, torch.exp(scores - m[..., None]),
                        zero)
        l = p.sum(dim=-1)                                       # [S, H, C]
        o = torch.einsum("shct,sthd->shcd", p, vals)
        return kpool, kscale, vpool, vscale, m, l, o


class PagedFinishStep(_PagedModel):
    """The coordinator's tail of a context-parallel replica's step:
    residual + MLP + untied-head logits + argmax over the MERGED
    attention output, the same ``_tail`` as ``PagedDecodeStep``'s on the
    same weights, so a bit-identical merged ``o`` yields a bit-identical
    token stream. ``per_pos`` widens the logits to every row, as the
    single-worker step does for speculative verify windows. ``device``
    and ``params`` as ``PagedDecodeStep``'s."""

    def __init__(self, slots: int, vocab: int, d: int, block_size: int,
                 max_blocks_per_req: int, chunk: int,
                 hidden: Optional[int] = None, seed: int = 0,
                 per_pos: bool = False, params: Optional[dict] = None,
                 device=None):
        device = resolve_device(device, "PagedFinishStep")
        # One head: the finish step projects no q/k/v.
        super().__init__(slots, vocab, d, 1, block_size,
                         max_blocks_per_req, chunk, hidden, seed, params,
                         device, per_pos)

    def forward(self, prev_tok, host_tok, use_host, ctx, n_new, o):
        """[slots] int32 tokens ([slots, chunk] with ``per_pos``) from
        the merged attention output ``o [slots, chunk, d]``."""
        pos = ctx.long()[:, None] + self._rows[None, :]
        x = self._embed(prev_tok, host_tok, use_host, pos)
        return self._tail(x, o, n_new)
