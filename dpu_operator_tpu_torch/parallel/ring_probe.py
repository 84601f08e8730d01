"""Ring addressing, the ring protocols and the collectives of the fabric
probe.

Counterpart of the JAX package's ``parallel/ring_probe.py``: ``_ring_ids``
(plain integer arithmetic on a rank's mesh coordinates), the one-way and
bidirectional ring all-gather, the ring reduce-scatter (sum), the
all-to-all and ``measure_ring_bandwidth``. The protocol bodies
(``_run_ring_stream`` and ``_run_rs_ring`` there) are device code here,
written once in ``csrc/ring_stream.cuh`` as templates, so that every
kernel built on a ring shares one copy of each; ``csrc/ring_collectives.cu``
holds the ring collectives' kernels and ``csrc/all_to_all.cu`` the
all-to-all's, whose all-rank barrier needs no ring.

Each collective has two versions of the same function:

  * ``ring_all_gather_plain`` / ``ring_reduce_scatter_plain`` -- the ring
    written out in PyTorch, step by step and rank by rank (the
    all-gather copies between the ranks' outputs; in the reduce-scatter a
    rotation of the per-rank list of blocks stands for the neighbour
    copy), in the kernels' order, so that a wrong step index or a wrong
    operand order shows;
  * ``ring_all_gather_cuda`` / ``ring_reduce_scatter_cuda`` -- one
    cooperative launch that holds every rank of the ring on the tensor's
    card (built for ``sm_90a`` at first use). Given a tensor on the CPU
    they run the plain version; on a CUDA tensor they launch the kernel
    or raise. ``.launches`` counts their launches.

The all-to-all has the same two versions, ``all_to_all_plain`` (rank by
rank, in the kernel's order of stores) and ``all_to_all_cuda``.

``make_ring_all_gather``, ``make_ring_reduce_scatter`` and
``make_all_to_all`` are the entry points, on whole tensors cut into
``mesh[axis]`` row shards.

**The ranks of a ring share one card.** What ``measure_ring_bandwidth``
times is then the protocol and the copies within that card's memory, not
any link between cards.

The all-gather protocol (``run_gather_relay``), per rank r of an n-rank
one-way ring, the block of step k being row ``idx = (r - k) mod n``:

  * a neighbour barrier: both neighbours have entered;
  * step 0: the own shard is read once and stored twice, into the rank's
    own output row r and the right neighbour's row r, and the right
    neighbour's receive flag is raised;
  * step k = 1 .. n - 2: wait for the block of step k, read row idx from
    the rank's own output and store it into the right neighbour's row
    idx, raise its receive flag;
  * step n - 1: wait for the last block, so that the rank's output is
    complete when the kernel ends.

Every output row of every rank is written exactly once, so no slot and
no credit is needed: no store waits for a reader. A rank's CTAs count
their arrivals on two counters by step parity, so from step 2 on a CTA
also waits until its own rank's step k - 2 has been signalled: with no
credit, nothing else keeps it from running two steps ahead of a slow CTA
of its rank and counting towards the wrong step.
``all_gather_moved_bytes`` counts what the kernel reads and writes. The
bidirectional form runs the same protocol twice, each stream on half of
every shard, one towards higher positions and one the other way.

The stream protocol with its two slots and credits
(``run_ring_stream``) remains for ring attention and the all-gather
matmul, which consume each block as it passes. Why it needs the credit:
waiting on one's own receive flag bounds nothing about the neighbours'
progress, so around an n-ring a neighbour can run up to n - 1 steps
ahead, and its step-(k + 2) copy would land in a slot whose step-k
contents this rank has not yet forwarded (seen as chunk corruption on
the reference's 8-wide ring). Each rank grants its left neighbour a
credit after each step and waits for one before every send after the
first; skew is bounded to one step, which the two slots absorb.

The reduce-scatter protocol (``run_rs_fold_send``): chunk j starts at
rank ``(j + 1) mod n`` and travels right, gathering each rank's
contribution, and is complete on rank j after n - 1 hops. Step k = 1 ..
n - 2 reads its arrival (at step 1 the left neighbour's own part of
row-block ``(my_id - 2) mod n``, read where it lies; later the slot
``k % 2`` the left neighbour's step k - 1 filled) and stores ``own part
of row-block (my_id - k - 1) mod n + arrival`` straight into the right
neighbour's slot ``(k + 1) % 2``; the last step stores ``arrival + own
part of row-block my_id`` as the rank's result. From step 3 on a store
reuses the slot the neighbour read in its previous step, so it waits for
a credit, which the neighbour grants after its steps 2 .. n - 3.
``reduce_scatter_moved_bytes`` counts what the kernel reads and writes.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..device import pick_kernel, resolve_device
from .mesh import ring_is_ici_adjacent

#: Largest ring the kernels take.
MAX_RANKS = 8


def _ring_ids(axis: str, axis_size: int, axis_names: Sequence[str],
              coords: Sequence[int]
              ) -> Tuple[int, Tuple[int, ...], Tuple[int, ...]]:
    """``(my_id, right, left)`` for the rank at mesh coordinates
    ``coords`` (one per name of ``axis_names``) on the ring over
    ``axis``: its position on the ring and its two neighbours' full mesh
    coordinates. Only the ring axis differs from the rank's own
    coordinates, so the ring stays on ``axis`` whatever the other axes
    are."""
    if len(coords) != len(axis_names):
        raise ValueError(f"coords {tuple(coords)} do not match axes "
                         f"{tuple(axis_names)}")
    ring_pos = list(axis_names).index(axis)
    my_id = int(coords[ring_pos])
    if not 0 <= my_id < axis_size:
        raise ValueError(f"rank {my_id} is not on a ring of {axis_size}")
    right = list(coords)
    right[ring_pos] = (my_id + 1) % axis_size
    left = list(coords)
    left[ring_pos] = (my_id - 1 + axis_size) % axis_size
    return my_id, tuple(right), tuple(left)


def _neighbours(n: int) -> Tuple[List[int], List[int]]:
    """Each rank's right and left neighbour on a ring of n."""
    right, left = [], []
    for rank in range(n):
        _, r, l = _ring_ids("sp", n, ("sp",), (rank,))
        right.append(r[0])
        left.append(l[0])
    return right, left


class _RingControl:
    """The rings' flag words on one (device, stream), zeroed once and
    kept across calls, and the epoch that tags each call's flag values
    (``csrc/ring_stream.cuh``). Calls on one stream run in order, and a
    flag only grows, so every ring kernel can share the words. Two sets:
    a launch runs at most two streams (the bidirectional all-gather),
    each on its own."""

    WORDS_PER_RANK = 16  # sizeof(ring::Flags) / 8, padded to 128 bytes
    STREAMS = 2

    def __init__(self, device: torch.device):
        self.flags = torch.zeros(
            self.STREAMS * MAX_RANKS * self.WORDS_PER_RANK,
            dtype=torch.int64, device=device)
        self.epoch = 0


class _A2AControl(_RingControl):
    """The all-to-all's own flag words (``A2AFlags`` of
    ``csrc/all_to_all.cu``: one tagged word per source rank for "entered"
    and one for "landed", and two arrival counters), apart from the
    rings'. The library reports the struct's size, which must be this."""

    WORDS_PER_RANK = 32  # sizeof(A2AFlags) / 8, padded to 256 bytes
    STREAMS = 1


_controls: Dict[Tuple[type, int, int], _RingControl] = {}
_controls_lock = threading.Lock()


def _control(device: torch.device, stream: int,
             kind: type = _RingControl) -> _RingControl:
    """The control words of ``kind`` on (device, stream)."""
    with _controls_lock:
        key = (kind, device.index, stream)
        ctl = _controls.get(key)
        if ctl is None:
            ctl = kind(device)
            _controls[key] = ctl
        return ctl


def _next_epoch(ctl: _RingControl) -> int:
    """``ctl``'s epoch, advanced by one for the call about to be
    launched."""
    with _controls_lock:
        ctl.epoch += 1
        return ctl.epoch


# -- all-gather ---------------------------------------------------------------


def _chunk_rows(x: torch.Tensor, n: int, what: str) -> int:
    """Rows of one rank's shard of x [N, W]; raises where x does not cut
    into n equal row shards."""
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be [N, W], got {tuple(x.shape)}")
    if n < 1:
        raise ValueError(f"{what}: ring of {n} ranks")
    if x.shape[0] == 0 or x.shape[0] % n:
        raise ValueError(f"{what}: rows {x.shape[0]} do not cut into {n} "
                         f"equal shards")
    return x.shape[0] // n


def ring_all_gather_plain(x: torch.Tensor, n: int,
                          bidirectional: bool = False) -> torch.Tensor:
    """The ring all-gather of x [N, W], cut into n row shards, one per
    rank: every rank's gathered copy, [n, N, W], each equal to x. Written
    out step by step and rank by rank in the kernel's protocol: at step 0
    rank r stores its shard into its own row r and its right neighbour's
    row r; at step k = 1 .. n - 2 it copies its own row ``(r - k) mod n``
    into the right neighbour's same row. Bidirectional (and an even
    shard; an odd one runs the one-way ring), the top half of every shard
    travels right and the bottom half left, the left-going stream's rows
    ``(r + k) mod n``."""
    chunk = _chunk_rows(x, n, "ring_all_gather")
    out = x.new_empty((n,) + tuple(x.shape))
    if bidirectional and chunk % 2 == 0:
        streams = ((1, 0, chunk // 2), (-1, chunk // 2, chunk))
    else:
        streams = ((1, 0, chunk),)
    for direction, lo, hi in streams:
        for r in range(n):
            own = slice(r * chunk + lo, r * chunk + hi)
            out[r, own] = x[own]
            if n > 1:
                out[(r + direction) % n, own] = x[own]
        for step in range(1, n - 1):
            for r in range(n):
                idx = (r - direction * step) % n
                rows = slice(idx * chunk + lo, idx * chunk + hi)
                out[(r + direction) % n, rows] = out[r, rows]
    return out


def all_gather_moved_bytes(n: int, chunk_bytes: int) -> int:
    """Bytes the all-gather kernel reads and writes, all ranks of a ring
    of n, one way or both: per rank the own shard read once and written
    twice, then n - 2 relays of a read and a write, 2n - 1 blocks. A ring
    of one reads its shard and writes it once."""
    if n < 2:
        return 2 * chunk_bytes
    return n * (2 * n - 1) * chunk_bytes


def _library():
    from ..cuda_build import load

    lib = load("ring_collectives")
    if lib.ring_all_gather_launch.argtypes is None:
        ids = ctypes.POINTER(ctypes.c_longlong)
        lib.ring_all_gather_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ids, ids, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_ulonglong, ctypes.c_void_p])
        lib.ring_all_gather_launch.restype = ctypes.c_int
        lib.ring_reduce_scatter_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ids, ids, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_ulonglong, ctypes.c_void_p])
        lib.ring_reduce_scatter_launch.restype = ctypes.c_int
    return lib


def _kernel_input(x: torch.Tensor, n: int, what: str) -> torch.Tensor:
    """x as the kernels read it: contiguous, its base 16-byte aligned."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if not 1 <= n <= MAX_RANKS:
        raise ValueError(f"{what}: the kernel takes 1..{MAX_RANKS} ranks, "
                         f"got {n}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x


def _launch(what: str, x: torch.Tensor, n: int, call) -> None:
    """Run ``call(ids_right, ids_left, flags_ptr, epoch, stream)`` on x's
    card and current stream; raise where the launch was refused."""
    right, left = _neighbours(n)
    ids = ctypes.c_longlong * n
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ctl = _control(x.device, stream)
        err = call(ids(*right), ids(*left), ctl.flags.data_ptr(),
                   _next_epoch(ctl), stream)
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def ring_all_gather_cuda(x: torch.Tensor, n: int,
                         bidirectional: bool = False) -> torch.Tensor:
    """``ring_all_gather_plain``'s function in one launch of the ring
    kernel, all n ranks on x's card: [n, N, W]. Any type whose shard has
    an even number of bytes; 1 <= n <= 8. Raises on anything else and
    where the card refuses the launch."""
    if x.device.type == "cpu":
        return ring_all_gather_plain(x, n, bidirectional)
    chunk = _chunk_rows(x, n, "ring_all_gather")
    x = _kernel_input(x, n, "ring_all_gather_cuda")
    bidirectional = bool(bidirectional) and chunk % 2 == 0
    chunk_bytes = chunk * x.shape[1] * x.element_size()
    if chunk_bytes == 0 or chunk_bytes % 2 or (bidirectional
                                               and chunk_bytes % 4):
        raise ValueError(f"ring_all_gather_cuda: the kernel moves 2-byte "
                         f"units; a shard of {chunk_bytes} bytes "
                         f"({'halved' if bidirectional else 'whole'}) is "
                         f"none")
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    lib = _library()
    _launch("ring_all_gather", x, n,
            lambda right, left, flags, epoch, stream:
            lib.ring_all_gather_launch(
                x.data_ptr(), out.data_ptr(), flags, right, left, n,
                chunk_bytes, int(bidirectional), epoch, stream))
    if bidirectional:
        ring_all_gather_cuda.launches_bidir += 1
    else:
        ring_all_gather_cuda.launches += 1
    return out


#: Kernel launches so far of the one-way ring and of the bidirectional
#: ring (CPU calls of the wrapper do not count).
ring_all_gather_cuda.launches = 0
ring_all_gather_cuda.launches_bidir = 0


# -- reduce-scatter -----------------------------------------------------------

RS_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                    torch.int32: 3}


def _rs_rows(x: torch.Tensor, n: int) -> int:
    """Rows of one rank's contribution in x [n * rows, W]; raises where
    they do not cut into n row-blocks."""
    rows = _chunk_rows(x, n, "ring_reduce_scatter")
    if rows % n:
        raise ValueError(f"reduce-scatter rows {rows} must divide by axis "
                         f"size {n}")
    return rows


def ring_reduce_scatter_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """The ring reduce-scatter (sum) of n contributions: x [n * rows, W],
    rank r's contribution its rows ``r * rows ..``; returns [rows, W],
    rank j's chunk (the sum over ranks of row-block j) at rows
    ``j * chunk ..``. Adds in the ring's order and in x's type: chunk j
    starts as rank ``(j + 1) mod n``'s part and each rank on the way to
    rank j adds its own to what arrives (``own + arrival``; the last hop
    ``arrival + own``), rounding at every hop."""
    rows = _rs_rows(x, n)
    if n == 1:
        return x
    chunk = rows // n
    parts = [c.split(chunk) for c in x.split(rows)]  # [rank][row-block]
    send = [parts[r][(r - 1 + n) % n] for r in range(n)]
    recv = send
    for step in range(n - 1):
        recv = send[-1:] + send[:-1]  # i -> i + 1
        nxt = [parts[r][(r - step - 2 + 2 * n) % n] for r in range(n)]
        if step < n - 2:
            nxt = [nxt[r] + recv[r] for r in range(n)]
        send = nxt
    return torch.cat([recv[r] + send[r] for r in range(n)], dim=0)


def reduce_scatter_moved_bytes(n: int, block_bytes: int) -> int:
    """Bytes the reduce-scatter kernel reads and writes, all ranks of a
    ring of n: per rank n - 1 steps that each read the arrival and the own
    block and write their sum, 3(n - 1) blocks. A ring of one moves
    nothing."""
    if n < 2:
        return 0
    return n * 3 * (n - 1) * block_bytes


def ring_reduce_scatter_cuda(x: torch.Tensor, n: int) -> torch.Tensor:
    """``ring_reduce_scatter_plain``'s function in one launch of the ring
    kernel, all n ranks on x's card, the same adds in the same order, so
    the same bits. f32, bf16, f16 or int32; 1 <= n <= 8 (a ring of one is
    the identity and launches nothing). Raises on anything else and where
    the card refuses the launch."""
    if x.device.type == "cpu":
        return ring_reduce_scatter_plain(x, n)
    rows = _rs_rows(x, n)
    x = _kernel_input(x, n, "ring_reduce_scatter_cuda")
    if x.dtype not in RS_KERNEL_DTYPES:
        raise ValueError(f"ring_reduce_scatter_cuda: the kernel takes f32, "
                         f"bf16, f16 or int32, got {x.dtype}")
    if n == 1:
        return x
    block_bytes = rows // n * x.shape[1] * x.element_size()
    if block_bytes == 0:
        raise ValueError("ring_reduce_scatter_cuda: empty row-blocks")
    out = torch.empty((rows, x.shape[1]), dtype=x.dtype, device=x.device)
    slots = torch.empty(2 * n * block_bytes, dtype=torch.uint8,
                        device=x.device)
    lib = _library()
    _launch("ring_reduce_scatter", x, n,
            lambda right, left, flags, epoch, stream:
            lib.ring_reduce_scatter_launch(
                x.data_ptr(), out.data_ptr(), slots.data_ptr(), flags,
                right, left, n, block_bytes, RS_KERNEL_DTYPES[x.dtype],
                epoch, stream))
    ring_reduce_scatter_cuda.launches += 1
    return out


#: Kernel launches so far (CPU calls of the wrapper do not count).
ring_reduce_scatter_cuda.launches = 0


# -- all-to-all ---------------------------------------------------------------


def _a2a_rows(x: torch.Tensor, n: int) -> int:
    """Rows of one rank's shard in x [n * rows, W]; raises where they do
    not cut into n blocks (the reference's error)."""
    rows = _chunk_rows(x, n, "all_to_all")
    if rows % n:
        raise ValueError(f"all-to-all rows {rows} must divide by axis size "
                         f"{n}")
    return rows


def all_to_all_plain(x: torch.Tensor, n: int) -> torch.Tensor:
    """The all-to-all of n ranks: x [n * rows, W], rank s's shard its rows
    ``s * rows ..``, cut into n blocks of ``rows / n``; returns the
    exchanged [n * rows, W], in which rank r's block s is rank s's input
    block r. Written as the kernel works, rank by rank: the own block,
    then the n - 1 peers, block ``dst = (my_id + k) mod n`` to rank dst
    for k = 1 .. n - 1. A ring of one is the identity."""
    rows = _a2a_rows(x, n)
    if n == 1:
        return x
    chunk = rows // n
    blocks = [shard.split(chunk) for shard in x.split(rows)]  # [rank][blk]
    out = x.new_empty(tuple(x.shape))
    for my_id in range(n):
        for k in range(n):
            dst = (my_id + k) % n
            at = dst * rows + my_id * chunk
            out[at:at + chunk] = blocks[my_id][dst]
    return out


_a2a_lib = None


def _a2a_library():
    """The all-to-all's library, bound and checked at its first call."""
    global _a2a_lib
    if _a2a_lib is not None:
        return _a2a_lib
    from ..cuda_build import load

    lib = load("all_to_all")
    if lib.all_to_all_launch.argtypes is None:
        lib.all_to_all_flag_words.argtypes = []
        lib.all_to_all_flag_words.restype = ctypes.c_int
        words = lib.all_to_all_flag_words()
        if words != _A2AControl.WORDS_PER_RANK:
            raise RuntimeError(f"all_to_all.cu's A2AFlags holds {words} "
                               f"words a rank; the wrapper allocates "
                               f"{_A2AControl.WORDS_PER_RANK}")
        lib.all_to_all_launch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_ulonglong, ctypes.c_void_p]
        lib.all_to_all_launch.restype = ctypes.c_int
    _a2a_lib = lib
    return lib


def _raw_stream(device: torch.device) -> int:
    """The handle of the current stream on ``device`` (a CUDA device),
    without building a ``torch.cuda.Stream`` where this torch offers the
    raw getter."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:
        return get(device.index)
    return torch.cuda.current_stream(device).cuda_stream


class _A2ALaunch:
    """What one all-to-all launch on (device, stream, n, output base,
    rank bytes) passes besides x: the n ranks' output pointers as a
    ctypes array, and the control words of (device, stream) with the
    address of their flags. Built once per key and kept, so a call in a
    steady loop (where the allocator hands the same output block back)
    builds no array and takes no lock to find its words."""

    __slots__ = ("outs", "control", "flags")

    def __init__(self, out_base: int, rank_bytes: int, n: int,
                 control: _RingControl):
        self.outs = (ctypes.c_void_p * n)(*(out_base + r * rank_bytes
                                            for r in range(n)))
        self.control = control
        self.flags = control.flags.data_ptr()


_a2a_launches: Dict[tuple, _A2ALaunch] = {}
#: Launch states kept at once; the oldest goes first.
A2A_LAUNCHES_KEPT = 32


def _a2a_launch(device: torch.device, stream: int, n: int, out_base: int,
                rank_bytes: int) -> _A2ALaunch:
    """The launch state of (device, stream, n, output base, rank bytes),
    built at its first call."""
    key = (device.index, stream, n, out_base, rank_bytes)
    state = _a2a_launches.get(key)
    if state is None:
        state = _A2ALaunch(out_base, rank_bytes, n,
                           _control(device, stream, _A2AControl))
        with _controls_lock:
            _a2a_launches[key] = state
            while len(_a2a_launches) > A2A_LAUNCHES_KEPT:
                _a2a_launches.pop(next(iter(_a2a_launches)))
    return state


def all_to_all_cuda(x: torch.Tensor, n: int) -> torch.Tensor:
    """``all_to_all_plain``'s function in one launch of the all-to-all
    kernel, all n ranks on x's card, every block moved bit for bit. Any
    type whose block is a whole number of 2-byte units; 1 <= n <= 8 (a
    ring of one is the identity and launches nothing). Raises on anything
    else and where the card refuses the launch. Enters x's device only
    where it is not the current one."""
    if x.device.type == "cpu":
        return all_to_all_plain(x, n)
    rows = _a2a_rows(x, n)
    x = _kernel_input(x, n, "all_to_all_cuda")
    if n == 1:
        return x
    block_bytes = rows // n * x.shape[1] * x.element_size()
    if block_bytes == 0 or block_bytes % 2:
        raise ValueError(f"all_to_all_cuda: the kernel moves 2-byte units; "
                         f"a block of {block_bytes} bytes is none")
    if torch.cuda.current_device() != x.device.index:
        with torch.cuda.device(x.device):
            return all_to_all_cuda(x, n)
    out = torch.empty_like(x)
    lib = _a2a_library()
    stream = _raw_stream(x.device)
    state = _a2a_launch(x.device, stream, n, out.data_ptr(),
                        rows * x.shape[1] * x.element_size())
    err = lib.all_to_all_launch(x.data_ptr(), state.outs, state.flags, n,
                                block_bytes, _next_epoch(state.control),
                                stream)
    if err:
        raise RuntimeError(f"all_to_all kernel launch failed: CUDA error "
                           f"{err}")
    all_to_all_cuda.launches += 1
    return out


#: Kernel launches so far (CPU calls of the wrapper do not count).
all_to_all_cuda.launches = 0


# -- entry points -------------------------------------------------------------


def _ring_setup(mesh: Mapping[str, int], axis: str, kernel: Optional[str],
                device, owner: str) -> Tuple[int, torch.device, str]:
    """``(ring size, device, kernel)`` of an entry point: ``kernel`` is
    ``"cuda"`` by default on a CUDA device and ``"torch"`` on the CPU;
    ``device`` None means the CUDA card, and raises without one."""
    if axis not in mesh:
        raise ValueError(f"axis {axis!r} is not in the mesh {dict(mesh)}")
    device = resolve_device(device, owner)
    return int(mesh[axis]), device, pick_kernel(kernel, device)


def _on(device: torch.device, owner: str, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}; this {owner} runs "
                             f"on {device}")


def make_ring_all_gather(mesh: Mapping[str, int], axis: str = "sp", *,
                         bidirectional: bool = True,
                         kernel: Optional[str] = None, device=None):
    """``fn(x)``: x [N, W] on ``device``, cut into ``mesh[axis]`` row
    shards, one per rank of the ring (the reference's ``P(axis, None)``)
    -> the gathered [N, W] as a rank holds it after the ring (the
    reference's ``out_specs=P()``; every rank's copy is the same, and
    ``ring_all_gather_cuda`` returns them all). The ring runs both ways
    by default, each direction carrying half of every shard;
    ``bidirectional=False`` gives the one-way ring, and odd shards fall
    back to it. ``mesh`` maps axis names to sizes; only ``axis`` shapes
    the result. ``kernel`` is ``"cuda"`` (the default on a CUDA device:
    the ring kernel) or ``"torch"`` (the default on the CPU: the plain
    version). ``device`` None means the CUDA card, and raises without
    one."""
    n, device, kernel = _ring_setup(mesh, axis, kernel, device,
                                    "make_ring_all_gather")
    impl = ring_all_gather_cuda if kernel == "cuda" else ring_all_gather_plain

    def fn(x: torch.Tensor) -> torch.Tensor:
        _on(device, "ring all-gather", x=x)
        return impl(x, n, bidirectional)[0]

    return fn


def make_ring_reduce_scatter(mesh: Mapping[str, int], axis: str = "sp", *,
                             kernel: Optional[str] = None, device=None):
    """``fn(x)``: x [n * rows, W] on ``device``, rank r's [rows, W]
    contribution at rows ``r * rows ..`` (the reference's
    ``P(axis, None)``) -> [rows, W], rank j's chunk of the sum at rows
    ``j * rows / n ..`` (ring reduce-scatter). Composed with
    ``make_ring_all_gather`` it is a bandwidth-optimal all-reduce.
    ``mesh``, ``kernel`` and ``device`` as in ``make_ring_all_gather``."""
    n, device, kernel = _ring_setup(mesh, axis, kernel, device,
                                    "make_ring_reduce_scatter")
    impl = (ring_reduce_scatter_cuda if kernel == "cuda"
            else ring_reduce_scatter_plain)

    def fn(x: torch.Tensor) -> torch.Tensor:
        _on(device, "ring reduce-scatter", x=x)
        return impl(x, n)

    return fn


def make_all_to_all(mesh: Mapping[str, int], axis: str = "sp", *,
                    kernel: Optional[str] = None, device=None):
    """``fn(x)``: x [n * rows, W] on ``device``, rank r's [rows, W] shard
    at rows ``r * rows ..`` (the reference's ``P(axis, None)``), each cut
    into n blocks -> the exchanged [n * rows, W], sharded the same way:
    block j of every rank's shard goes to rank j, which stores it as its
    block of the sender's index (the sequence/expert-parallel shuffle
    behind Ulysses attention). ``mesh``, ``kernel`` and ``device`` as in
    ``make_ring_all_gather``."""
    n, device, kernel = _ring_setup(mesh, axis, kernel, device,
                                    "make_all_to_all")
    impl = all_to_all_cuda if kernel == "cuda" else all_to_all_plain

    def fn(x: torch.Tensor) -> torch.Tensor:
        _on(device, "all-to-all", x=x)
        return impl(x, n)

    return fn


def measure_ring_bandwidth(mesh: Mapping[str, int], axis: str = "sp",
                           mbytes: int = 16, rounds: int = 4, *,
                           bidirectional: bool = False,
                           kernel: Optional[str] = None, device=None) -> dict:
    """Time repeated ring all-gathers of an ``mbytes`` payload; returns
    {"seconds_per_round", "effective_gbps", "axis_size", "ici_adjacent",
    "mode"}. ``effective_gbps`` is the reference's figure, in gigabits
    per second: the bytes every rank must receive, ``(n - 1) / n`` of the
    payload, over the wall time of one round. Where the ranks share one
    card it rates the protocol and the copies within that card's memory,
    not a link.

    Defaults to the one-way ring; with ``bidirectional=True`` the same
    bytes move both ways round at once. ``mode`` records which protocol
    ran: ``"unidir"``, ``"bidir"``, or ``"torch"`` for the plain version.
    ``ici_adjacent`` is None: ranks that share a card carry no physical
    coordinates."""
    axis_size, device, kernel = _ring_setup(mesh, axis, kernel, device,
                                            "measure_ring_bandwidth")
    width = 512
    rows = max(axis_size, (mbytes * 1024 * 1024) // (4 * width))
    rows -= rows % axis_size or 0
    rows = max(rows, axis_size)
    chunk = rows // axis_size
    if kernel != "cuda":
        mode = "torch"
    elif bidirectional and chunk % 2 == 0:
        mode = "bidir"
    else:
        mode = "unidir"
    x = torch.ones((rows, width), dtype=torch.float32, device=device)
    fn = make_ring_all_gather(mesh, axis, bidirectional=bidirectional,
                              kernel=kernel, device=device)

    def wait() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(x)  # builds the kernel at first use
    wait()
    start = time.perf_counter()
    for _ in range(rounds):
        fn(x)
    wait()
    elapsed = (time.perf_counter() - start) / rounds
    moved_bytes = x.numel() * x.element_size() * (axis_size - 1) / max(
        axis_size, 1)
    return {
        "seconds_per_round": elapsed,
        "effective_gbps": (moved_bytes * 8 / elapsed / 1e9) if elapsed
        else 0.0,
        "axis_size": axis_size,
        "ici_adjacent": ring_is_ici_adjacent(mesh, axis),
        "mode": mode,
    }
