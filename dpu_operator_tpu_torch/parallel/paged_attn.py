"""Fused paged-attention decode step: the CUDA kernel and its plain version.

Counterpart of ``make_paged_attn_step`` in the JAX package's
``parallel/pallas_paged_attn.py``. One call per decode step

  * quantizes the step's new K/V rows with their row scales (int8 pools;
    fp32 pools store the rows as they are) and appends them in place at
    ``pool[tables[s, pos // bs], pos % bs]`` for rows ``c < n_new[s]``;
  * gathers each slot's pages through its block table;
  * attends per row, causally: row ``j`` sees positions ``<= ctx + j``
    that are also ``< ctx + n_new`` (the valid-block guard zeroes K/V at
    and past that limit before any arithmetic), scaled by ``1/sqrt(dh)``.

Both versions take the reference ``step(...)``'s argument list
(``tables, ctx, n_new, q, k_new, v_new, kscale_rows, vscale_rows,
kscale_tbl, vscale_tbl, kpool, vpool``), update the pools in place and
return ``o [S, C, H, dh]`` f32. They compute the same function on every
row, padding rows and idle slots included (an idle slot with no context
gives 0), so the kernel is held against the plain version row for row.

``paged_attn_step_cuda`` launches the hand-written kernel
(``csrc/paged_attn.cu``, built for ``sm_90a`` at first use) on PyTorch's
current stream; given tensors on the CPU it runs the plain version
instead, and on any other device it raises. ``paged_attn_step_plain`` is
the reference's XLA composition (``serving/kvcache/paged.py``: drop
scatter, full table gather, masked softmax, einsum) in PyTorch; the CPU
path and the tests use it.

The kernel splits each slot's context across CTAs, ``CHUNK_BLOCKS``
block-table entries a CTA, and combines the chunks' partial softmax
states in chunk order (flash-decoding's split-K). ``paged_attn_split_plain``
writes that arithmetic out in PyTorch -- each chunk's appends, its
running max ``m``, normalizer ``l`` and unnormalized output ``acc``, and
the combine -- for the tests and for holding the kernel on the card; no
path runs it.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Tuple

import torch

from .quantize import int8_block_decode

NEG = -1e30

#: Block-table entries one CTA of the kernel owns (``kChunkBlocks`` of
#: ``csrc/paged_attn.cu``; the wrapper checks the library's).
CHUNK_BLOCKS = 32
#: The largest chunk width C and head width dh the kernel takes.
MAX_CHUNK_ROWS = 64
MAX_HEAD_DIM = 256


def _quantize_rows(vals: torch.Tensor, row_scales: torch.Tensor
                   ) -> torch.Tensor:
    q = torch.round(vals / row_scales[:, :, None, None])
    return q.clamp(-127, 127).to(torch.int8)


def _scatter_rows_drop(pool: torch.Tensor, blk: torch.Tensor,
                      off: torch.Tensor, valid: torch.Tensor,
                      rows: torch.Tensor) -> None:
    """``pool[blk, off] = rows`` where ``valid``; invalid rows write
    nothing (the reference's ``mode="drop"`` scatter), with no host sync.

    An invalid row may aim at a valid row's target: a padding table entry
    names block 0, which may be another slot's. So every row writes what
    its target's valid writer writes, or the target's old contents where
    no valid row writes it. Rows aimed at one target then all carry one
    value and the unordered ``index_put_`` is exact. Valid targets are
    distinct (slots own disjoint blocks), and this is a selection, never
    arithmetic, so NaN contents survive untouched."""
    N, bs = pool.shape[0], pool.shape[1]
    flat = pool.view(N * bs, *pool.shape[2:])
    idx = (blk * bs + off).reshape(-1)
    ok = valid.reshape(-1)
    new = rows.reshape(idx.shape[0], *pool.shape[2:]).to(pool.dtype)
    same = (idx[:, None] == idx[None, :]) & ok[None, :]
    writer = same.to(torch.int32).argmax(dim=1)
    written = same.any(dim=1).reshape(-1, *([1] * (new.dim() - 1)))
    flat.index_put_((idx,), torch.where(written, new[writer], flat[idx]))


def paged_attn_step_plain(tables, ctx, n_new, q, k_new, v_new,
                          kscale_rows, vscale_rows, kscale_tbl,
                          vscale_tbl, kpool, vpool) -> torch.Tensor:
    """The plain PyTorch version (see the module docstring)."""
    S, C, H, dh = q.shape
    bs = kpool.shape[1]
    B = tables.shape[1]
    T = B * bs
    dev = q.device
    tables = tables.long()
    ctx = ctx.long()
    n_new = n_new.long()
    rows = torch.arange(C, device=dev)
    pos = ctx[:, None] + rows[None, :]                       # [S, C]
    valid = rows[None, :] < n_new[:, None]
    blk = torch.gather(tables, 1, torch.clamp(pos // bs, 0, B - 1))
    off = pos % bs
    k_rows, v_rows = _quantized_rows(k_new, v_new, kscale_rows,
                                     vscale_rows, kpool.dtype)
    _scatter_rows_drop(kpool, blk, off, valid, k_rows)
    _scatter_rows_drop(vpool, blk, off, valid, v_rows)
    keys = int8_block_decode(kpool[tables], kscale_tbl).reshape(S, T, H, dh)
    vals = int8_block_decode(vpool[tables], vscale_tbl).reshape(S, T, H, dh)
    limit = ctx + n_new
    tpos = torch.arange(T, device=dev)
    # The valid-block guard: zero K/V at and past the limit BEFORE any
    # arithmetic (a softmax weight of 0 times a NaN row is still NaN).
    t_ok = (tpos[None, :] < limit[:, None])[:, :, None, None]
    zero = torch.zeros((), dtype=keys.dtype, device=dev)
    keys = torch.where(t_ok, keys, zero)
    vals = torch.where(t_ok, vals, zero)
    scores = torch.einsum("schd,sthd->shct", q, keys) / math.sqrt(dh)
    causal = ((tpos[None, None, :] <= pos[:, :, None])
              & (tpos[None, None, :] < limit[:, None, None]))  # [S, C, T]
    scores = torch.where(causal[:, None, :, :], scores,
                         torch.full((), NEG, dtype=scores.dtype, device=dev))
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("shct,sthd->schd", attn, vals).contiguous()


def _quantized_rows(k_new, v_new, kscale_rows, vscale_rows, pool_dtype):
    if pool_dtype == torch.int8:
        return (_quantize_rows(k_new, kscale_rows),
                _quantize_rows(v_new, vscale_rows))
    return k_new, v_new


def paged_attn_split_plain(tables, ctx, n_new, q, k_new, v_new,
                           kscale_rows, vscale_rows, kscale_tbl, vscale_tbl,
                           kpool, vpool, chunk_blocks: int = CHUNK_BLOCKS
                           ) -> torch.Tensor:
    """The kernel's split of the context, in plain PyTorch: the same
    function as ``paged_attn_step_plain``, computed as the kernel orders
    it. Chunk z owns block-table entries ``[z * chunk_blocks, (z + 1) *
    chunk_blocks)``; in chunk order it appends the new rows whose clipped
    block index ``min(pos // bs, B - 1)`` it owns, then attends its own
    positions: per row the running max ``m`` (``NEG`` where the row may
    see none of them), ``l = sum exp(s - m)`` and ``acc = sum exp(s - m)
    v``, with the valid-block guard and the per-row causal mask. The
    chunks combine in chunk order, ``M = max m``, ``l = sum l_z exp(m_z -
    M)``, ``acc = sum acc_z exp(m_z - M)``, and ``o = acc / l`` (0 where
    l is 0: an idle slot)."""
    S, C, H, dh = q.shape
    bs = kpool.shape[1]
    B = tables.shape[1]
    K = int(chunk_blocks)
    if K < 1:
        raise ValueError(f"chunk_blocks must be >= 1, got {chunk_blocks}")
    dev = q.device
    tables = tables.long()
    ctx = ctx.long()
    n_new = n_new.long()
    rows = torch.arange(C, device=dev)
    pos = ctx[:, None] + rows[None, :]                       # [S, C]
    valid = rows[None, :] < n_new[:, None]
    clipped = torch.clamp(pos // bs, 0, B - 1)
    blk = torch.gather(tables, 1, clipped)
    off = pos % bs
    k_rows, v_rows = _quantized_rows(k_new, v_new, kscale_rows,
                                     vscale_rows, kpool.dtype)
    limit = ctx + n_new
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    parts = []
    for z in range(-(-B // K)):
        mine = valid & (clipped // K == z)
        _scatter_rows_drop(kpool, blk, off, mine, k_rows)
        _scatter_rows_drop(vpool, blk, off, mine, v_rows)
        lo, hi = z * K, min((z + 1) * K, B)
        tb = tables[:, lo:hi]
        n = (hi - lo) * bs
        keys = int8_block_decode(kpool[tb], kscale_tbl[:, lo:hi]
                                 ).reshape(S, n, H, dh)
        vals = int8_block_decode(vpool[tb], vscale_tbl[:, lo:hi]
                                 ).reshape(S, n, H, dh)
        tpos = torch.arange(lo * bs, hi * bs, device=dev)
        t_ok = tpos[None, :] < limit[:, None]                 # [S, n]
        keys = torch.where(t_ok[:, :, None, None], keys, zero)
        vals = torch.where(t_ok[:, :, None, None], vals, zero)
        scores = torch.einsum("schd,sthd->shct", q, keys) / math.sqrt(dh)
        allowed = ((tpos[None, None, :] <= pos[:, :, None])
                   & t_ok[:, None, :])[:, None]               # [S, 1, C, n]
        scores = torch.where(allowed, scores,
                             torch.full((), NEG, device=dev))
        m = scores.amax(dim=-1)                               # [S, H, C]
        p = torch.where(allowed, torch.exp(scores - m[..., None]), zero)
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("shct,sthd->shcd", p, vals)))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(top)
    acc = torch.zeros((S, H, C, dh), dtype=torch.float32, device=dev)
    for m, lz, accz in parts:                                 # chunk order
        w = torch.exp(m - top)
        l = l + lz * w
        acc = acc + accz * w[..., None]
    o = torch.where(l[..., None] > 0, acc / l[..., None], zero)
    return o.permute(0, 2, 1, 3).contiguous()


def _check(tables, ctx, n_new, q, k_new, v_new, kscale_rows, vscale_rows,
           kscale_tbl, vscale_tbl, kpool, vpool) -> None:
    S, C, H, dh = q.shape
    B = tables.shape[1]
    want = {
        "tables": (tables, (S, B), torch.int32),
        "ctx": (ctx, (S,), torch.int32),
        "n_new": (n_new, (S,), torch.int32),
        "q": (q, (S, C, H, dh), torch.float32),
        "k_new": (k_new, (S, C, H, dh), torch.float32),
        "v_new": (v_new, (S, C, H, dh), torch.float32),
        "kscale_rows": (kscale_rows, (S, C), torch.float32),
        "vscale_rows": (vscale_rows, (S, C), torch.float32),
        "kscale_tbl": (kscale_tbl, (S, B), torch.float32),
        "vscale_tbl": (vscale_tbl, (S, B), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, pool in (("kpool", kpool), ("vpool", vpool)):
        if pool.dim() != 4 or tuple(pool.shape[2:]) != (H, dh) \
                or pool.dtype not in (torch.int8, torch.float32):
            raise ValueError(f"{name}: want int8|f32 [N, bs, {H}, {dh}], "
                             f"got {pool.dtype} {tuple(pool.shape)}")
    if kpool.shape != vpool.shape or kpool.dtype != vpool.dtype:
        raise ValueError("kpool and vpool must match in shape and dtype")
    if dh % 4 or dh > MAX_HEAD_DIM:
        raise ValueError(f"d_head={dh} must be a multiple of 4 and at "
                         f"most {MAX_HEAD_DIM}")
    if C > MAX_CHUNK_ROWS:
        raise ValueError(f"chunk width {C} is over the kernel's "
                         f"{MAX_CHUNK_ROWS}")
    tensors = {name: t for name, (t, _, _) in want.items()}
    tensors.update(kpool=kpool, vpool=vpool)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")


def _launcher():
    from ..cuda_build import load

    lib = load("paged_attn")
    fn = lib.paged_attn_step_launch
    if fn.argtypes is None:
        lib.paged_attn_chunk_blocks.argtypes = []
        lib.paged_attn_chunk_blocks.restype = ctypes.c_int
        blocks = lib.paged_attn_chunk_blocks()
        if blocks != CHUNK_BLOCKS:
            raise RuntimeError(f"paged_attn.cu's CTAs own {blocks} block-"
                               f"table entries; the wrapper sizes its "
                               f"scratch for {CHUNK_BLOCKS}")
        fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


#: Scratch of the kernel's combine by (device, stream, shape): the
#: partials [S, H, Z, C, dh] and [S, H, Z, C, 2] f32 and the arrival
#: words [S, H] (zeroed here once; each launch's last arriver resets its
#: words to 0). Launches on one stream run in order, so they share it.
_scratch: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
_scratch_lock = threading.Lock()
#: Scratch sets kept at once; the oldest goes first.
SCRATCH_KEEP = 8


def _scratch_for(device: torch.device, stream: int, S: int, H: int,
                 C: int, dh: int, B: int):
    """The combine's scratch for (device, stream, shape), allocated at the
    first call and reused after (on the stream current at allocation, so
    a set dropped from the cache is reused only in that stream's
    order)."""
    Z = -(-B // CHUNK_BLOCKS)
    key = (device.type, device.index, stream, S, H, Z, C, dh)
    with _scratch_lock:
        got = _scratch.get(key)
        if got is None:
            got = (torch.empty((S, H, Z, C, dh), dtype=torch.float32,
                               device=device),
                   torch.empty((S, H, Z, C, 2), dtype=torch.float32,
                               device=device),
                   torch.zeros((S, H), dtype=torch.int32, device=device))
            _scratch[key] = got
            while len(_scratch) > SCRATCH_KEEP:
                _scratch.pop(next(iter(_scratch)))
        return got


def paged_attn_step_cuda(tables, ctx, n_new, q, k_new, v_new, kscale_rows,
                         vscale_rows, kscale_tbl, vscale_tbl, kpool, vpool
                         ) -> torch.Tensor:
    """Launch the hand-written kernel (see the module docstring)."""
    if q.device.type == "cpu":
        return paged_attn_step_plain(tables, ctx, n_new, q, k_new, v_new,
                                     kscale_rows, vscale_rows, kscale_tbl,
                                     vscale_tbl, kpool, vpool)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attn_step_cuda: no kernel for device "
                         f"{q.device}")
    args = (tables, ctx, n_new, q, k_new, v_new, kscale_rows, vscale_rows,
            kscale_tbl, vscale_tbl, kpool, vpool)
    _check(*args)
    S, C, H, dh = q.shape
    B = tables.shape[1]
    bs = kpool.shape[1]
    o = torch.empty_like(q)
    launch = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        scratch = _scratch_for(q.device, stream, S, H, C, dh, B)
        err = launch(*(t.data_ptr() for t in args), o.data_ptr(),
                     *(t.data_ptr() for t in scratch),
                     S, C, B, bs, H, dh, int(kpool.dtype == torch.int8),
                     1.0 / math.sqrt(dh), stream)
    if err:
        raise RuntimeError(f"paged_attn kernel launch failed: CUDA error "
                           f"{err}")
    with _launches_lock:
        paged_attn_step_cuda.launches += 1
    return o


#: Kernel launches so far (CPU calls of the wrapper do not count). The
#: ranks of a context-parallel replica launch from threads of their
#: own, so the count is raised under a lock.
paged_attn_step_cuda.launches = 0
_launches_lock = threading.Lock()
