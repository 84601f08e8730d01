"""Collective matmuls: the tensor-parallel boundary pair, with the
collective cut into ring steps so that each step's product runs while
the next block is on its way.

Counterpart of the JAX package's ``parallel/collective_matmul.py``:

  * the all-gather matmul, ``Y[B, F/n] = AllGather(X[B/n, K]) @ W[K, F/n]``
    on every rank: activations gathered over their rows against
    column-sharded weights. Rank r ends with columns ``r * F/n ..`` of
    ``X @ W``;
  * the matmul reduce-scatter, ``Y[B/n, F] = ReduceScatter(X[B, K/n] @
    W[K/n, F])``: contraction-sharded partials summed and scattered by
    rows. Rank j ends with rows ``j * B/n ..`` of ``X @ W``.

Composed, ``Y = mm_rs(relu(ag_mm(X, W1)), W2)``, they are the classic
pair around a feature-sharded MLP: the first one's output sharding is the
second one's input sharding, so nothing is reshuffled between them.

Each kernel has its plain versions and a wrapper:

  * ``ag_matmul_plain`` -- the reference's ``_xla_ag_matmul_overlapped``
    rank by rank: at step k rank r multiplies the block of rank
    ``(r - k) mod n`` (a rotation of the per-rank list of blocks stands
    for ``ppermute``) by its columns of W, in f32, and stores it rounded
    once to x's type; ``ag_matmul_naive`` -- ``_xla_ag_matmul_naive``:
    one f32 product of the gathered x, one cast;
  * ``mm_rs_plain`` -- each rank's f32 partial, summed in the ring's
    order in f32 by ``ring_reduce_scatter_plain``, then one cast; a ring
    of one is one f32 product and a cast;
  * ``ag_matmul_cuda`` / ``mm_rs_cuda`` -- one cooperative launch of
    ``csrc/collective_matmul.cu`` (built for ``sm_90a`` at first use)
    that holds every rank of the ring on the tensors' card: the ring
    protocols of ``csrc/ring_stream.cuh`` with the tile product of
    ``csrc/tile_product.cuh`` inside (bf16: TMA-fed wgmma, its operands
    read through the tensor-map views of ``tma_views``; f32: mma.sync
    TF32 with each operand split into hi and lo, three passes a product,
    as ``tf32x3_product`` writes it out).
    Given tensors on the CPU they run the plain version; on a CUDA tensor
    they launch the kernel or raise. ``.launches`` counts their launches.

``make_allgather_matmul`` and ``make_matmul_reduce_scatter`` are the
entry points, on whole tensors. **The ranks of a ring share one card**,
so the transfers the products hide are copies within its memory, not a
link's.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Optional, Tuple

import torch

from .ring_attention import split_matmul
from .ring_probe import (_kernel_input, _launch, _on, _ring_setup,
                         ring_reduce_scatter_plain)
from .tile_mma import (K_AXIS, PART_AXIS, TILE_AXIS, WG_BK, WG_BM, WG_PANEL,
                       TmaView)

#: The kernels' operand types and their codes in ``csrc/collective_matmul.cu``.
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: K depth of the f32 kernels' fresh sums: each 16-deep slice's split
#: passes are added to the running f32 sum once (``tile_product_tf32x3``).
FOLD_K = 16


def tma_views(op: str, n: int, chunk: int, k: int, f: int,
              item: int = 2) -> Dict[str, TmaView]:
    """The tensor maps of the bf16 kernels, in the order their C entry
    points take them. ``op`` "ag": x [n * chunk, k] as (k, chunk, n) by
    shard, the slots [2n][chunk, k] as (k, chunk, 2n) by slot, w [k, f] as
    (f / n, n, k) by rank. ``op`` "rs": x [n * chunk, k] as (k / n, n,
    n * chunk) and w [k, f] as (f, k / n, n), both by rank, so that a
    rank's contraction ends at k / n and TMA zero-fills past it rather
    than read the next rank's. Pure: shapes in, views out."""
    a_box = (WG_BK, WG_BM, 1)
    if op == "ag":
        fn = f // n
        return {
            "x": TmaView((k, chunk, n), (k * item, chunk * k * item), a_box,
                         (K_AXIS, TILE_AXIS, PART_AXIS)),
            "slots": TmaView((k, chunk, 2 * n),
                             (k * item, chunk * k * item), a_box,
                             (K_AXIS, TILE_AXIS, PART_AXIS)),
            "w": TmaView((fn, n, k), (fn * item, f * item),
                         (WG_PANEL, 1, WG_BK),
                         (TILE_AXIS, PART_AXIS, K_AXIS)),
        }
    if op == "rs":
        kn = k // n
        return {
            "x": TmaView((kn, n, n * chunk), (kn * item, k * item),
                         (WG_BK, 1, WG_BM), (K_AXIS, PART_AXIS, TILE_AXIS)),
            "w": TmaView((f, kn, n), (f * item, kn * f * item),
                         (WG_PANEL, WG_BK, 1),
                         (TILE_AXIS, K_AXIS, PART_AXIS)),
        }
    raise ValueError(f"tma_views: op is 'ag' or 'rs', got {op!r}")


def _views_arg(x: torch.Tensor, op: str, n: int, chunk: int, k: int, f: int):
    """``tma_views`` as the C entry points take them for bf16 operands
    (one flat array of long long); None for f32, which reads no map."""
    if x.dtype != torch.bfloat16:
        return None
    flat = [v for view in tma_views(op, n, chunk, k, f).values()
            for v in view.values()]
    return (ctypes.c_longlong * len(flat))(*flat)


def _operands(x: torch.Tensor, w: torch.Tensor, what: str
              ) -> Tuple[int, int, int]:
    """``(B, K, F)`` of x [B, K] @ w [K, F]; raises otherwise."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{what}: want x [B, K] @ w [K, F], got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if x.numel() == 0 or w.numel() == 0:
        raise ValueError(f"{what}: empty operands {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    return x.shape[0], x.shape[1], w.shape[1]


def _product(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype
             ) -> torch.Tensor:
    """One f32 product, rounded once to ``dtype``."""
    return (x.float() @ w.float()).to(dtype)


def tf32x3_product(a: torch.Tensor, b: torch.Tensor,
                   single: bool = False) -> torch.Tensor:
    """f32 a [M, K] @ b [K, N] with the f32 kernels' arithmetic
    (``tile::tile_product_tf32x3``): K in slices of ``FOLD_K``, the last
    one zero-filled to its depth as the kernel's loads are; each slice's
    product by ``split_matmul`` (``lo_a hi_b + hi_a lo_b + hi_a hi_b``,
    the small terms first) in fresh f32 sums, then added to the running
    f32 sum with one rounding. ``single``: one TF32 pass a slice, which
    the f32 bar does not admit. The tensor cores' own sums within a slice
    truncate and run in another order; this form rounds to nearest."""
    a, b = a.float(), b.float()
    k = a.shape[1]
    pad = -k % FOLD_K
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, k + pad, FOLD_K):
        out += split_matmul(a[:, k0:k0 + FOLD_K], b[k0:k0 + FOLD_K],
                            False, False, single)
    return out


# -- all-gather matmul ----------------------------------------------------------


def _ag_split(x: torch.Tensor, w: torch.Tensor, n: int) -> Tuple[int, int]:
    """``(chunk, F / n)``: rows of a rank's shard of x and columns of its
    shard of w; raises where they do not cut into n."""
    b, _, f = _operands(x, w, "all-gather matmul")
    if n < 1:
        raise ValueError(f"all-gather matmul: ring of {n} ranks")
    if b % n or f % n:
        raise ValueError(f"all-gather matmul rows {b} and columns {f} must "
                         f"divide by axis size {n}")
    return b // n, f // n


def ag_matmul_plain(x: torch.Tensor, w: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """``AllGather(x) @ w`` as the ring computes it: x [B, K] cut into n
    row shards and w [K, F] into n column shards, one each per rank;
    returns [B, F] in x's type, rank r's columns ``r * F/n ..``. Rank r
    multiplies at step k the block of rank ``(r - k) mod n`` by its
    columns of w, in f32, and stores the product rounded once to x's type
    at that block's rows."""
    chunk, fn = _ag_split(x, w, n)
    out = x.new_empty((x.shape[0], w.shape[1]))
    blocks = list(x.split(chunk))
    for step in range(n):
        for r in range(n):
            idx = (r - step + n) % n
            out[idx * chunk:(idx + 1) * chunk, r * fn:(r + 1) * fn] = (
                _product(blocks[r], w[:, r * fn:(r + 1) * fn], x.dtype))
        blocks = blocks[-1:] + blocks[:-1]  # ppermute i -> i + 1
    return out


def ag_matmul_naive(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The gather first, then the product: one f32 product of the
    gathered x [B, K] with w [K, F], one cast to x's type (every rank's
    columns at once)."""
    _operands(x, w, "all-gather matmul")
    return _product(x, w, x.dtype)


def _library():
    from ..cuda_build import load

    lib = load("collective_matmul")
    if lib.ag_matmul_launch.argtypes is None:
        ids = ctypes.POINTER(ctypes.c_longlong)
        for fn, pointers in ((lib.ag_matmul_launch, 5),
                             (lib.mm_rs_launch, 6)):
            fn.argtypes = ([ctypes.c_void_p] * pointers
                           + [ids, ids, ids] + [ctypes.c_int] * 5
                           + [ctypes.c_ulonglong, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def _kernel_operands(x: torch.Tensor, w: torch.Tensor, n: int, what: str,
                     rows: Mapping[str, int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x and w as the kernels read them (``_kernel_input``: on a CUDA card,
    contiguous, on 16-byte boundaries, 1 <= n <= 8), both f32 or both bf16
    on one card, and every row the kernel reads or writes (``rows``: name
    -> values) whole 16-byte units, since cp.async moves 16 bytes and a
    tensor map's strides are multiples of 16 bytes. Raises on anything
    else."""
    x, w = _kernel_input(x, n, what), _kernel_input(w, n, what)
    if w.device != x.device:
        raise ValueError(f"{what}: w is on {w.device}, x on {x.device}")
    if x.dtype not in KERNEL_DTYPES or w.dtype != x.dtype:
        raise ValueError(f"{what}: the kernel takes x and w both f32 or "
                         f"both bf16, got {x.dtype} and {w.dtype}")
    for name, values in rows.items():
        if values * x.element_size() % 16:
            raise ValueError(f"{what}: a row of {name} is "
                             f"{values * x.element_size()} bytes, not whole "
                             f"16-byte units")
    return x, w


def ag_matmul_cuda(x: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """``ag_matmul_plain``'s function in one launch of the all-gather
    matmul kernel, all n ranks on x's card; 1 <= n <= 8. Raises on
    anything else and where the card refuses the launch."""
    if x.device.type == "cpu":
        return ag_matmul_plain(x, w, n)
    chunk, fn = _ag_split(x, w, n)
    k, f = x.shape[1], w.shape[1]
    x, w = _kernel_operands(x, w, n, "ag_matmul_cuda",
                            {"x": k, "a rank's columns of w and y": fn})
    y = torch.empty((x.shape[0], f), dtype=x.dtype, device=x.device)
    slots = torch.empty(2 * n * chunk * k, dtype=x.dtype, device=x.device)
    views = _views_arg(x, "ag", n, chunk, k, f)
    lib = _library()
    _launch("ag_matmul", x, n,
            lambda right, left, flags, epoch, stream: lib.ag_matmul_launch(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), slots.data_ptr(),
                flags, right, left, views, n, chunk, k, f,
                KERNEL_DTYPES[x.dtype], epoch, stream))
    ag_matmul_cuda.launches += 1
    return y


#: Kernel launches so far (CPU calls of the wrapper do not count).
ag_matmul_cuda.launches = 0


# -- matmul reduce-scatter ------------------------------------------------------


def _rs_split(x: torch.Tensor, w: torch.Tensor, n: int) -> Tuple[int, int]:
    """``(chunk, K / n)``: rows of a rank's share of the result and the
    contraction a rank holds; raises where they do not cut into n (rows
    with the reference's words)."""
    b, k, _ = _operands(x, w, "matmul-reduce-scatter")
    if n < 1:
        raise ValueError(f"matmul-reduce-scatter: ring of {n} ranks")
    if b % n:
        raise ValueError(f"matmul-reduce-scatter rows {b} must divide by "
                         f"axis size {n}")
    if k % n:
        raise ValueError(f"matmul-reduce-scatter contraction {k} must "
                         f"divide by axis size {n}")
    return b // n, k // n


def mm_rs_plain(x: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """``ReduceScatter(x_r @ w_r)`` as the ring computes it: x [B, K] cut
    into n column shards and w [K, F] into n row shards; returns [B, F]
    in x's type, rank j's rows ``j * B/n ..``. Each rank's partial is an
    f32 product; the partials are summed in the ring's order, in f32
    (``ring_reduce_scatter_plain``), and rounded once. A ring of one is
    one f32 product and a cast."""
    _, kn = _rs_split(x, w, n)
    if n == 1:
        return _product(x, w, x.dtype)
    parts = torch.cat([x[:, r * kn:(r + 1) * kn].float()
                       @ w[r * kn:(r + 1) * kn].float() for r in range(n)])
    return ring_reduce_scatter_plain(parts, n).to(x.dtype)


def mm_rs_cuda(x: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """``mm_rs_plain``'s function in one launch of the matmul
    reduce-scatter kernel, all n ranks on x's card, the same f32 adds in
    the same order; 1 <= n <= 8 (a ring of one is one f32 product and a
    cast, and launches nothing). Raises on anything else and where the
    card refuses the launch."""
    if x.device.type == "cpu":
        return mm_rs_plain(x, w, n)
    chunk, kn = _rs_split(x, w, n)
    k, f = x.shape[1], w.shape[1]
    x, w = _kernel_operands(x, w, n, "mm_rs_cuda",
                            {"a rank's columns of x": kn, "w and y": f})
    if n == 1:
        return _product(x, w, x.dtype)
    y = torch.empty((x.shape[0], f), dtype=x.dtype, device=x.device)
    send, recv = (torch.empty(2 * n * chunk * f, dtype=torch.float32,
                              device=x.device) for _ in range(2))
    views = _views_arg(x, "rs", n, chunk, k, f)
    lib = _library()
    _launch("mm_rs", x, n,
            lambda right, left, flags, epoch, stream: lib.mm_rs_launch(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), send.data_ptr(),
                recv.data_ptr(), flags, right, left, views, n, chunk, k, f,
                KERNEL_DTYPES[x.dtype], epoch, stream))
    mm_rs_cuda.launches += 1
    return y


#: Kernel launches so far (CPU calls of the wrapper do not count).
mm_rs_cuda.launches = 0


# -- entry points ---------------------------------------------------------------


def make_allgather_matmul(mesh: Mapping[str, int], axis: str = "tp", *,
                          overlap: bool = True,
                          kernel: Optional[str] = None, device=None):
    """``fn(x, w)``: x [B, K] on ``device``, cut into ``mesh[axis]`` row
    shards, and w [K, F], cut into as many column shards, one each per
    rank (the reference's ``P(axis, None)`` and ``P(None, axis)``) -> Y =
    AllGather(x) @ w [B, F] in x's type, rank r's columns ``r * F/n ..``
    (``out_specs=P(None, axis)``), the gather cut into ring steps so that
    each block's product runs while it moves on. ``overlap=False`` keeps
    the naive gather-then-product (the A/B baseline), which has no kernel:
    with ``kernel="cuda"`` it raises. ``mesh`` maps axis names to sizes;
    only ``axis`` shapes the result. ``kernel`` is ``"cuda"`` (the default
    on a CUDA device: the ring kernel) or ``"torch"`` (the default on the
    CPU: the plain version). ``device`` None means the CUDA card, and
    raises without one."""
    if not overlap:
        if kernel == "cuda":
            raise ValueError("overlap=False has no cuda form (the kernel is "
                             "inherently overlapped); leave kernel unset")
        kernel = "torch"
    n, device, kernel = _ring_setup(mesh, axis, kernel, device,
                                    "make_allgather_matmul")
    impl = ag_matmul_cuda if kernel == "cuda" else ag_matmul_plain

    def fn(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        _on(device, "all-gather matmul", x=x, w=w)
        if not overlap:
            _ag_split(x, w, n)
            return ag_matmul_naive(x, w)
        return impl(x, w, n)

    return fn


def make_matmul_reduce_scatter(mesh: Mapping[str, int], axis: str = "tp", *,
                               kernel: Optional[str] = None, device=None):
    """``fn(x, w)``: x [B, K] on ``device``, cut into ``mesh[axis]``
    column shards (the contraction), and w [K, F], cut into as many row
    shards, one each per rank (the reference's ``P(None, axis)`` and
    ``P(axis, None)``) -> Y = ReduceScatter(x_r @ w_r) [B, F] in x's
    type, rank j's rows ``j * B/n ..`` (``out_specs=P(axis, None)``): the
    partial-sum ring with each row-block's product computed at its ring
    step, summed in f32 and rounded once. The reverse boundary of
    ``make_allgather_matmul``; composed they form the tensor-parallel
    pair around a feature-sharded layer. ``mesh``, ``kernel`` and
    ``device`` as in ``make_allgather_matmul``."""
    n, device, kernel = _ring_setup(mesh, axis, kernel, device,
                                    "make_matmul_reduce_scatter")
    impl = mm_rs_cuda if kernel == "cuda" else mm_rs_plain

    def fn(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        _on(device, "matmul reduce-scatter", x=x, w=w)
        return impl(x, w, n)

    return fn
