"""Ring attention: sequence-parallel exact attention over a ring of ranks.

Counterpart of the JAX package's ``parallel/ring_attention.py``. Q, K and
V are cut along the sequence into n row shards, one per rank of the ring
axis. Each rank keeps its Q shard and streams the K/V shards around the
ring, packed as one ``[S/n, dk + dv]`` block, folding every block into an
f32 online softmax (the flash-attention recurrence) as it passes. Memory
per rank stays O(S/n) while attention stays exact over the whole
sequence. ``causal=True`` masks by GLOBAL position (query row
``my_id * sq + r`` against key ``idx * sk + c``), so causality holds
across shards. The accumulators are f32 whatever the input type.

Two versions of the same function:

  * ``ring_attention_plain`` — the counterpart of the reference's
    ``_xla_ring_attention``: a loop over ring steps and ranks in which
    ``ppermute`` becomes a rotation of the per-rank list of packed
    blocks, with the reference's fold order;
  * ``ring_attention_cuda`` — the counterpart of
    ``_pallas_ring_attention``: one cooperative launch of
    ``csrc/ring_attn.cu`` (built for ``sm_90a`` at first use) that holds
    every rank of the ring on one card, the ring protocol of
    ``csrc/ring_stream.cuh`` carrying the blocks from rank to rank, both
    products on the TF32 tensor cores with an f32-accurate split. Given
    tensors on the CPU it runs the plain version; on a CUDA tensor it
    launches the kernel or raises. It counts its launches in
    ``.launches``.

``tf32_split``, ``split_matmul`` and ``ring_attention_split`` write the
kernel's arithmetic out in plain PyTorch (its TF32 rounding, its pass
rule, its key tiles), so that tests can hold the scheme against the
reference where there is no card.

``make_ring_attention`` is the entry point: ``fn(q, k, v)`` on whole
``[S, D*]`` tensors, cut into ``mesh[axis]`` shards, giving ``[S, dv]``.

``ring_attention_batched`` is the counterpart of the reference's
``xla_ring_attention_batched``: the same exact attention over ``[B, S,
D*]`` sequences, each sequence's scores in one softmax (the ring moves no
data when its ranks share one card), differentiated by autograd. The
training stage's causal attention over the token ranks
(``train_step._stage_fn``) runs it, as the reference's stage runs its XLA
ring: single-head at the model's width, which is past the kernel's
``MAX_DIM``.

``merge_partial_softmax`` (numpy, a copy of the reference's) folds the
same recurrence's partials on the host: the coordinator of a
page-sharded paged-KV replica (``serving/kvcache/sharded.py``) merges
its ranks' attention with it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from .ring_probe import MAX_RANKS, _launch, _ring_setup

_NEG_INF = -1e30  # not -inf: (-inf) - (-inf) would NaN the rescale

#: The kernel's largest head width (its largest ring is ``MAX_RANKS``).
MAX_DIM = 256
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _online_update(s, m, l, o, v_blk, mm=torch.matmul):
    """One flash-attention fold: scores s [sq, sk] join running
    (max m [sq, 1], denom l [sq, 1], accum o [sq, dv]); all f32."""
    m_new = torch.maximum(m, torch.amax(s, dim=1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + torch.sum(p, dim=1, keepdim=True)
    o_new = o * alpha + mm(p, v_blk)
    return m_new, l_new, o_new


def _scores(q, k_blk, scale, causal, my_id, idx, sq, sk, first=0,
            mm=torch.matmul):
    """Scaled q @ k^T with the cross-shard causal mask by GLOBAL
    position: query row r is global my_id*sq + r, key column c of a
    block's keys ``first ..`` is idx*sk + first + c."""
    s = mm(q, k_blk.T) * scale
    if causal:
        dev = q.device
        q_pos = my_id * sq + torch.arange(sq, device=dev)[:, None]
        k_pos = (idx * sk + first
                 + torch.arange(k_blk.shape[0], device=dev)[None, :])
        s = torch.where(k_pos <= q_pos, s,
                        torch.full((), _NEG_INF, dtype=s.dtype, device=dev))
    return s


def _check_qkv(q, k, v) -> None:
    """Loud shape/dtype contract: a k width that differs from q would
    slice the packed KV block at the wrong boundary and return garbage
    that still type-checks."""
    if k.shape[1] != q.shape[1]:
        raise ValueError(
            f"k feature dim {k.shape[1]} != q feature dim {q.shape[1]}")
    if k.shape[0] != v.shape[0]:
        raise ValueError(
            f"k rows {k.shape[0]} != v rows {v.shape[0]} (same shard)")


def _pack_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """K and V circulate as one block; promote to the WIDER dtype so a
    mixed-precision cache (bf16 k, f32 v) is never silently quantized."""
    dtype = torch.promote_types(k.dtype, v.dtype)
    return torch.cat([k.to(dtype), v.to(dtype)], dim=1)


def _shards(q, k, v, n: int) -> Tuple[int, int]:
    """``(sq, sk)``, the rows of one rank's shards; raises where the
    sequence does not cut into n equal shards."""
    if q.dim() != 2 or k.dim() != 2 or v.dim() != 2:
        raise ValueError(f"q, k, v must be [S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _check_qkv(q, k, v)
    if n < 1:
        raise ValueError(f"ring of {n} ranks")
    for name, t in (("q", q), ("k", k)):
        if t.shape[0] == 0 or t.shape[0] % n:
            raise ValueError(f"{name} rows {t.shape[0]} do not cut into "
                             f"{n} equal shards")
    return q.shape[0] // n, k.shape[0] // n


def _ring_fold(q, k, v, n, causal, key_tile, q_mm, v_mm):
    """The ring's fold: rank r folds the block of rank ``(r - step) mod
    n`` at each step, ``key_tile`` keys at a time (the scores by ``q_mm``,
    p . v by ``v_mm``), then divides once. Returns [S, dv] in q's
    dtype."""
    sq, sk = _shards(q, k, v, n)
    d_k = q.shape[1]
    d_v = v.shape[1]
    scale = 1.0 / math.sqrt(d_k)
    dev = q.device
    qf = q.float()
    kv = list(_pack_kv(k, v).split(sk))
    state = [(torch.full((sq, 1), _NEG_INF, dtype=torch.float32, device=dev),
              torch.zeros((sq, 1), dtype=torch.float32, device=dev),
              torch.zeros((sq, d_v), dtype=torch.float32, device=dev))
             for _ in range(n)]
    for step in range(n):
        for my_id in range(n):
            idx = (my_id - step + n) % n
            q_r = qf[my_id * sq:(my_id + 1) * sq]
            for first in range(0, sk, key_tile):
                tile = kv[my_id][first:first + key_tile]
                s = _scores(q_r, tile[:, :d_k].float(), scale, causal, my_id,
                            idx, sq, sk, first, q_mm)
                state[my_id] = _online_update(s, *state[my_id],
                                              tile[:, d_k:].float(), v_mm)
        if step < n - 1:  # ppermute i -> i + 1
            kv = kv[-1:] + kv[:-1]
    out = []
    for m, l, o in state:
        out.append((o / torch.where(l == 0.0, 1.0, l)).to(q.dtype))
    return torch.cat(out, dim=0)


def ring_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n: int, causal: bool = False) -> torch.Tensor:
    """Exact attention of q [S, dk] over k [S', dk], v [S', dv], each cut
    into n row shards, as the ring computes it: rank r folds the block of
    rank ``(r - step) mod n`` at each step, then divides once. Returns
    [S, dv] in q's dtype."""
    sk = _shards(q, k, v, n)[1]
    return _ring_fold(q, k, v, n, causal, sk, torch.matmul, torch.matmul)


def ring_attention_batched(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           n: int, causal: bool) -> torch.Tensor:
    """The function of the reference's ``xla_ring_attention_batched`` (the
    training stage's attention): q, k, v [B, S, D*], independent sequences,
    each cut into n row shards over a ring of n ranks. With every rank on
    one card the ring moves no data, so each sequence's scores go through
    one softmax, the causal mask by global position (the position in the
    whole sequence): exact attention, as the ring's online softmax
    computes it, in f32 whatever the input type. Raises where a sequence
    does not cut into n shards. Plain torch, so autograd differentiates
    it. Returns [B, S, dv] in q's dtype."""
    if q.dim() != 3 or k.shape[:2] != q.shape[:2] or k.shape[2] != q.shape[2]:
        raise ValueError(f"k shape {tuple(k.shape)} incompatible with q "
                         f"{tuple(q.shape)}")
    _shards(q[0], k[0], v[0], n)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(
        q.shape[2])
    if causal:
        pos = torch.arange(q.shape[1], device=q.device)
        s = torch.where(pos[None, :] <= pos[:, None], s, torch.full(
            (), _NEG_INF, dtype=s.dtype, device=s.device))
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


# -- the kernel's arithmetic, written out --------------------------------------


def key_tile(d_k: int, d_v: int) -> int:
    """Keys of the kernel's key tile: 64, or 16 where dk or dv exceeds 128
    (its two instances)."""
    return 64 if max(d_k, d_v) <= 128 else 16


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of f32 x as the kernel's ``cvt.rna.tf32.f32`` cuts it:
    hi is x rounded to 10 mantissa bits, to nearest with ties away from
    zero (on the f32 bit pattern: add half of the 13 dropped bits, clear
    them), lo is ``x - hi`` (exact in f32) rounded the same way. hi + lo
    is x within 2**-22 of |x|, and within 2**-137 where x - hi is
    subnormal; lo is 0 where x is exact in TF32, as every bf16 value is.
    Defined for finite x below 2**128 * (1 - 2**-12), where hi would
    round to inf."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def split_matmul(a: torch.Tensor, b: torch.Tensor, a_exact: bool,
                 b_exact: bool, single: bool = False) -> torch.Tensor:
    """a @ b in f32 as the kernel's tensor-core passes compute it: each
    operand split by ``tf32_split``, ``lo_a hi_b + hi_a lo_b + hi_a hi_b``
    with the small terms first, each pass a product of TF32 values (exact
    in f32) summed in f32. The pass of an operand whose type is exact in
    TF32 (``a_exact``/``b_exact``: bf16) is dropped: its lo is 0.
    ``single`` keeps only ``hi_a hi_b``, plain TF32's one pass."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    if single:
        return a_hi @ b_hi
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    if not a_exact:
        out += a_lo @ b_hi
    if not b_exact:
        out += a_hi @ b_lo
    return out + a_hi @ b_hi


def ring_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n: int, causal: bool = False,
                         single: bool = False) -> torch.Tensor:
    """``ring_attention_plain``'s function with the kernel's arithmetic:
    each block folded one key tile (``key_tile``) at a time, both products
    by ``split_matmul`` under the kernel's pass rule (q . k drops the pass
    of a bf16 q or K, p . v that of a bf16 V; p is f32). ``single``: one
    TF32 pass each, which the f32 bars do not admit."""
    q_exact = q.dtype == torch.bfloat16
    kv_exact = torch.promote_types(k.dtype, v.dtype) == torch.bfloat16

    def q_mm(a, b):
        return split_matmul(a, b, q_exact, kv_exact, single)

    def v_mm(a, b):
        return split_matmul(a, b, False, kv_exact, single)

    return _ring_fold(q, k, v, n, causal,
                      key_tile(q.shape[1], v.shape[1]), q_mm, v_mm)


# -- the kernel ---------------------------------------------------------------


def _launcher():
    from ..cuda_build import load

    fn = load("ring_attn").ring_attn_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8
                       + [ctypes.POINTER(ctypes.c_longlong)] * 2
                       + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_ulonglong,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ring_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n: int, causal: bool = False) -> torch.Tensor:
    """``ring_attention_plain``'s function in one launch of the ring
    kernel, all n ranks on q's card. q f32 or bf16; k and v packed to
    their promoted type, which must be f32 or bf16; dk, dv <= 256;
    1 <= n <= 8. Raises on anything else and where the card refuses the
    launch."""
    if q.device.type == "cpu":
        return ring_attention_plain(q, k, v, n, causal)
    if q.device.type != "cuda":
        raise ValueError(f"ring_attention_cuda: no kernel for device "
                         f"{q.device}")
    sq, sk = _shards(q, k, v, n)
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    kv = _pack_kv(k, v)
    q = q.contiguous()
    d_k, d_v = q.shape[1], v.shape[1]
    if q.dtype not in KERNEL_DTYPES or kv.dtype not in KERNEL_DTYPES:
        raise ValueError(f"ring_attention_cuda: the kernel takes f32 or "
                         f"bf16, got q {q.dtype}, packed k/v {kv.dtype}")
    if not (1 <= n <= MAX_RANKS and d_k <= MAX_DIM and d_v <= MAX_DIM):
        raise ValueError(f"ring_attention_cuda: the kernel takes 1..{MAX_RANKS}"
                         f" ranks and dk, dv <= {MAX_DIM}, got n={n} "
                         f"dk={d_k} dv={d_v}")
    dev = q.device
    out = torch.empty((n * sq, d_v), dtype=q.dtype, device=dev)
    slots = torch.empty((n, 2, sk, d_k + d_v), dtype=kv.dtype, device=dev)
    m = torch.empty(n * sq, dtype=torch.float32, device=dev)
    l = torch.empty(n * sq, dtype=torch.float32, device=dev)
    o = torch.empty((n * sq, d_v), dtype=torch.float32, device=dev)
    launch = _launcher()
    _launch("ring_attn", q, n,
            lambda right, left, flags, epoch, stream: launch(
                q.data_ptr(), kv.data_ptr(), out.data_ptr(),
                slots.data_ptr(), m.data_ptr(), l.data_ptr(), o.data_ptr(),
                flags, right, left, n, sq, sk, d_k, d_v,
                int(q.dtype == torch.bfloat16),
                int(kv.dtype == torch.bfloat16), int(causal),
                1.0 / math.sqrt(d_k), epoch, stream))
    ring_attention_cuda.launches += 1
    return out


#: Kernel launches so far (CPU calls of the wrapper do not count).
ring_attention_cuda.launches = 0


def make_ring_attention(mesh: Mapping[str, int], axis: str = "sp",
                        causal: bool = False, *, kernel: Optional[str] = None,
                        device=None):
    """``fn(q, k, v)``: q [S, dk], k [S', dk], v [S', dv] on ``device``,
    each cut into ``mesh[axis]`` row shards, one per rank of the ring
    (the reference's ``P(axis, None)``) → exact attention [S, dv] in q's
    dtype, computed by streaming K/V around the ring with an f32 online
    softmax. ``mesh`` maps axis names to sizes (``{"dp": 2, "sp": 4,
    "tp": 1}``); only ``axis`` shapes the result. ``kernel`` is
    ``"cuda"`` (the default on a CUDA device: the ring kernel) or
    ``"torch"`` (the default on the CPU: the plain version). ``device``
    None means the CUDA card, and raises without one."""
    n, device, kernel = _ring_setup(mesh, axis, kernel, device,
                                    "make_ring_attention")
    impl = ring_attention_cuda if kernel == "cuda" else ring_attention_plain

    def fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}; this ring "
                                 f"attention runs on {device}")
        return impl(q, k, v, n, causal)

    return fn


# -- serving fusion (context-parallel paged KV) -------------------------------


def merge_partial_softmax(parts):
    """Fold per-shard flash-attention partials in shard order — the
    `_online_update` recurrence with the per-hop RDMA replaced by a
    host-side gather. Each part is ``(m, l, o)`` for ONE shard's key
    range: running max ``m [...]``, un-normalized denominator ``l
    [...]`` and un-normalized accumulator ``o [..., dv]`` (numpy or
    jax arrays, any leading batch shape). A shard that owns no valid
    keys for a row contributes ``(m=-1e30, l=0, o=0)``, the fold
    identity. Returns the NORMALIZED attention output ``o / l``
    (rows with no keys anywhere come back 0).

    This is how the serving plane's page-sharded paged-KV replicas
    (serving/kvcache/sharded.py) compose their per-rank attention
    over long prefill chunks: each rank scans only its own pages
    (``PagedRankStep``), the coordinator folds here."""
    if not parts:
        raise ValueError("merge_partial_softmax needs >= 1 partial")
    m0, l0, o0 = parts[0]
    m = np.asarray(m0, np.float32)
    l = np.asarray(l0, np.float32)
    o = np.asarray(o0, np.float32)
    for m_r, l_r, o_r in parts[1:]:
        m_r = np.asarray(m_r, np.float32)
        l_r = np.asarray(l_r, np.float32)
        o_r = np.asarray(o_r, np.float32)
        m_new = np.maximum(m, m_r)
        # exp(-1e30 - (-1e30)) would be exp(0)=1 — but its l/o are 0,
        # so the identity still folds as the identity (the _NEG_INF
        # rationale: never produce a NaN rescale, let the zero
        # weights carry the truth).
        alpha = np.exp(m - m_new)
        beta = np.exp(m_r - m_new)
        l = l * alpha + l_r * beta
        o = o * alpha[..., None] + o_r * beta[..., None]
        m = m_new
    denom = np.where(l > 0.0, l, 1.0)[..., None]
    return (o / denom).astype(np.float32)
