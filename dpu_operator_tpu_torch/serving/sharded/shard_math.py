"""The per-shard slice of a serving replica's decode step, in torch.

Counterpart of the JAX package's ``serving/sharded/shard_math.py``. One
``FabricExecutor`` replica spans ``world`` shard workers; each worker
holds ONE tensor-parallel slice of the params and the (replicated)
``[slots, d]`` decode state, computes its partial contribution per stage,
and closes the contraction with an allreduce over whatever collective
plane the backend provides: the in-process reduce board of
``SyntheticShardSet``, or ``parallel/fabric_collectives.RingTransport``
in the real shard worker.

Each slice holds its weights as tensors on an explicit ``device`` (None
means the CUDA card, and raises without one; ``"cpu"`` for the CPU), and
``partial`` / ``finish`` run in torch there. Slices built from one params
dict share its device copy through views, so ``world`` ranks of
``TpShardSlice`` on one card cost one copy of the weights, not ``world``
copies of the replicated MoE body.

The collective seam is the reference's: ``reduce_fn``, ``reduce_submit``
and ``reduce_wait`` take and return f32 numpy arrays, so the reduce
board, ``GuardedReducer`` and ``RingTransport`` stay the reference's
code. A stage's partial goes to the host and its reduced sum comes back
once a stage; the state goes back to the host once a step, for the
tokens, which are the argmax of the host state, as the reference's are.

Two slice families:

  * ``TpShardSlice`` — the Megatron pairing over the ``init_params``
    layout: w1 column-sharded, w2 row-sharded, so ``relu(x @ w1_r) @
    w2_r`` summed over ranks equals ``relu(x @ w1) @ w2`` (exact in real
    arithmetic; only the sum's fp order differs, which argmax
    tolerates). After the reduce every rank computes the identical
    tanh + MoE residual. E must be 1: the expert exchange is not carried
    across shards.
  * ``DoubleShardSlice`` — the reference's ``SyntheticExecutor`` double
    (``tanh(x @ W)``) with W row-sharded over the input dim, W drawn with
    ``np.random.RandomState(seed)`` exactly as the reference draws it.

``make_mesh_stage_fn`` is the mesh form of the stage: the tensor-parallel
ranks stacked on one device, each stage's w1 product the all-gather
matmul (``collective_matmul.make_allgather_matmul``: on a CUDA device
the ring kernel ``csrc/collective_matmul.cu`` ``ag_matmul_kernel``), the
w2 contraction closed by a plain sum of the ranks' products in rank
order.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ...device import resolve_device
# Token ownership (shard r reports slots seg[r]) and weight slicing use
# the SAME even-contiguous split the fabric ring uses for its collective
# segments — imported, not re-implemented, so the two can never silently
# diverge.
from ...parallel.fabric_collectives import (
    _segment_bounds as segment_bounds)


def params_on(params: Mapping, device: torch.device) -> Dict[str, torch.Tensor]:
    """``params`` as f32 tensors on ``device``: a tensor already there in
    f32 is taken as it is (shared, not copied), a numpy array on the CPU
    shares its memory (a read-only one is copied), anything else is
    copied once."""
    out = {}
    for k, v in params.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().to(device=device, dtype=torch.float32)
            continue
        a = np.asarray(v, np.float32)
        if not a.flags.writeable:
            a = a.copy()
        out[k] = torch.as_tensor(a, device=device)
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """An f32 tensor's values as a numpy array on the host."""
    return t.detach().cpu().numpy()


class ShardSlice:
    """One rank's compute: per-stage ``partial`` (pre-reduce) and
    ``finish`` (post-reduce) on tensors on ``self.device``, plus the
    stage loop on the host state. ``reduce_fn(partial, stage)`` is the
    collective seam the backend injects, on f32 numpy arrays."""

    stages: int = 1
    d: int = 0
    device: torch.device = torch.device("cpu")

    def partial(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        raise NotImplementedError

    def finish(self, x: torch.Tensor, dense: torch.Tensor,
               stage: int) -> torch.Tensor:
        raise NotImplementedError

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=self.device)

    def forward(self, x: np.ndarray,
                reduce_fn: Callable[[np.ndarray, int], np.ndarray],
                ) -> Tuple[np.ndarray, np.ndarray]:
        """One decode step on the replicated state: per stage, local
        partial -> allreduce -> local finish. Returns (x_next, tokens) on
        the host; tokens are the FULL [slots] argmax (identical on every
        rank — callers report only their owned segment)."""
        xd = self._dev(x)
        for s in range(self.stages):
            dense = reduce_fn(_host(self.partial(xd, s)), s)
            xd = self.finish(xd, self._dev(dense), s)
        x = _host(xd)
        return x, np.argmax(x, axis=1).astype(np.int32)

    def forward_overlapped(self, x: np.ndarray,
                           reduce_submit: Callable,
                           reduce_wait: Callable,
                           blocks: int = 2,
                           partial_fn: Optional[Callable] = None,
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """The same step with the slots split into ``blocks`` row blocks
        (every piece of the stage math is row-independent) and the seam
        split into ``reduce_submit(partial, stage, block) -> ticket`` /
        ``reduce_wait(ticket) -> dense``, so a block's reduce runs on the
        backend's collective plane while this thread computes the next
        block's partial, and stage k's in-flight reduces overlap stage
        k+1's partials. Every rank issues submits in the identical
        (stage, block) order: the schedule is the ordering contract.
        On the synthetic board (rank-ordered sum) block splitting changes
        no sum; on the real ring the block-wise allreduces re-segment the
        payload, so equivalence there is token-level, as in the
        reference. ``partial_fn`` overrides the local partial (the
        synthetic shard's injected compute cost wraps it)."""
        pf = partial_fn if partial_fn is not None else self.partial
        ff = self.finish
        xd = self._dev(x).clone()  # mutated per block below
        bounds = [b for b in segment_bounds(xd.shape[0], max(1, blocks))
                  if b[1] > b[0]]
        pending: list = []  # (ticket, lo, hi) in (stage, block) order
        for s in range(self.stages):
            for bi, (lo, hi) in enumerate(bounds):
                if s > 0:
                    t, plo, phi = pending.pop(0)
                    xd[plo:phi] = ff(xd[plo:phi], self._dev(reduce_wait(t)),
                                     s - 1)
                part = _host(pf(xd[lo:hi], s))
                pending.append((reduce_submit(part, s, bi), lo, hi))
        for t, lo, hi in pending:
            xd[lo:hi] = ff(xd[lo:hi], self._dev(reduce_wait(t)),
                           self.stages - 1)
        x = _host(xd)
        return x, np.argmax(x, axis=1).astype(np.int32)


def make_mesh_stage_fn(mesh: Mapping[str, int], params: Mapping,
                       axis: str = "tp", overlap: bool = True, *,
                       kernel: Optional[str] = None, device=None):
    """The mesh form of the stage, its tensor-parallel ranks stacked on
    one device: each stage's w1 product is
    ``collective_matmul.make_allgather_matmul(mesh, axis, overlap=,
    kernel=, device=)`` (the slot gather cut into ring steps inside the
    product: on a CUDA device one launch of the all-gather matmul kernel
    a stage), the w2 contraction closes with the sum of each rank's
    ``relu(h_r) @ w2_r`` in rank order (the reference's ``psum``), and the
    finish (tanh, then the E = 1 expert body as a residual) runs once.
    ``overlap=False`` keeps the naive gather-then-product.

    ``mesh`` maps axis names to sizes. Returns ``step(x[slots, d]) ->
    (x_next, tokens)`` on host arrays; slots must divide the axis size.
    ``device`` None means the CUDA card; ``kernel`` as in
    ``make_allgather_matmul``."""
    from ...parallel.collective_matmul import make_allgather_matmul

    dev = resolve_device(device, "make_mesh_stage_fn")
    p = params_on(params, dev)
    if p["router"].shape[2] != 1 or p["moe_w1"].shape[1] != 1:
        raise ValueError(
            "mesh-stage serving shards require E == 1 (tp shards the "
            "dense contraction; experts replicate)")
    S = p["w1"].shape[0]
    n = int(mesh[axis])
    ag_mm = make_allgather_matmul(mesh, axis, overlap=overlap,
                                  kernel=kernel, device=dev)

    def close(h_col: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
        fn = h_col.shape[1] // n
        dense = None
        for r in range(n):
            part = torch.relu(h_col[:, r * fn:(r + 1) * fn]) \
                @ w2[r * fn:(r + 1) * fn]
            dense = part if dense is None else dense + part
        return dense

    def finish(dense, m1, m2):
        y = torch.tanh(dense)
        return y + torch.relu(y @ m1) @ m2

    def step(x: np.ndarray):
        x = np.ascontiguousarray(x, np.float32)
        if x.shape[0] % n:
            raise ValueError(
                f"slots {x.shape[0]} must divide the {axis!r} axis "
                f"size {n} (shard_map even-shard contract)")
        xd = torch.as_tensor(x, device=dev)
        for s in range(S):
            h_col = ag_mm(xd, p["w1"][s])          # gather ∥ matmul
            dense = close(h_col, p["w2"][s])      # the sum closes w2
            xd = finish(dense, p["moe_w1"][s, 0], p["moe_w2"][s, 0])
        x = _host(xd)
        return x, np.argmax(x, axis=1).astype(np.int32)

    return step


class TpShardSlice(ShardSlice):
    """Rank r's Megatron slice of the stage-stacked ``init_params``
    weights (the ``LocalExecutor`` model): w1 [S, d, h] column slice, w2
    [S, h, d] row slice, the MoE body replicated; all views of one copy
    of ``params`` on ``device`` (None means the CUDA card). A zero row
    stays zero through relu/matmul/tanh and contributes zero MoE
    residual, so no row mask is needed at E == 1."""

    def __init__(self, params: Mapping, rank: int, world: int,
                 device=None):
        if not (0 <= rank < world):
            raise ValueError(f"bad shard shape rank={rank} "
                             f"world={world}")
        self.device = resolve_device(device, "TpShardSlice")
        p = params_on(params, self.device)
        S, d, h = p["w1"].shape
        if p["router"].shape[2] != 1 or p["moe_w1"].shape[1] != 1:
            raise ValueError(
                "tensor-parallel serving shards require E == 1: the "
                "MoE all_to_all is not carried across the shard "
                "fabric (tp shards the dense contraction; experts "
                "replicate)")
        if "wq" in p:
            raise ValueError("attention params are not supported by "
                             "the serving shard slice (decode state "
                             "has no sequence axis)")
        self.rank, self.world = rank, world
        self.stages, self.d, self.h = S, d, h
        lo, hi = segment_bounds(h, world)[rank]
        # Empty slices are legal (world > h): the rank contributes a
        # zero partial and still participates in every collective.
        self.w1 = p["w1"][:, :, lo:hi]            # [S, d, h_r]
        self.w2 = p["w2"][:, lo:hi, :]            # [S, h_r, d]
        self.moe_w1 = p["moe_w1"][:, 0]           # [S, d, h]
        self.moe_w2 = p["moe_w2"][:, 0]           # [S, h, d]

    def partial(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        if self.w1.shape[2] == 0:
            return torch.zeros((x.shape[0], self.d), dtype=torch.float32,
                               device=self.device)
        return torch.relu(x @ self.w1[stage]) @ self.w2[stage]

    def finish(self, x: torch.Tensor, dense: torch.Tensor,
               stage: int) -> torch.Tensor:
        y = torch.tanh(dense)
        # Switch MoE at E == 1: softmax over one expert is exactly 1.0
        # and capacity (ceil(rows · cf) >= rows) never drops a token, so
        # the block reduces to the expert body as a residual.
        return y + torch.relu(y @ self.moe_w1[stage]) @ self.moe_w2[stage]


class DoubleShardSlice(ShardSlice):
    """Rank r's row slice of the reference's ``SyntheticExecutor`` double:
    partials ``x[:, lo:hi] @ W[lo:hi]`` allreduce to ``x @ W``; finish is
    the elementwise tanh. W is drawn as the reference draws it, so token
    streams compare 1:1. ``device`` None means the CUDA card."""

    stages = 1

    def __init__(self, d: int, seed: int, rank: int, world: int,
                 device=None):
        if not (0 <= rank < world):
            raise ValueError(f"bad shard shape rank={rank} "
                             f"world={world}")
        self.device = resolve_device(device, "DoubleShardSlice")
        self.rank, self.world, self.d = rank, world, d
        # f64, as numpy's promotion makes the reference's W (an f32 draw
        # divided by an f64 scalar), so the partial is an f64 product
        # rounded to f32, as the reference's is.
        w = np.random.RandomState(seed).randn(d, d).astype(
            np.float32) / np.sqrt(d)
        lo, hi = segment_bounds(d, world)[rank]
        self._lo, self._hi = lo, hi
        self.w = torch.as_tensor(np.ascontiguousarray(w[lo:hi, :]),
                                 device=self.device)  # [d_r, d]

    def partial(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        if self._hi == self._lo:
            return torch.zeros((x.shape[0], self.d), dtype=torch.float32,
                               device=self.device)
        return (x[:, self._lo:self._hi].to(self.w.dtype) @ self.w).float()

    def finish(self, x: torch.Tensor, dense: torch.Tensor,
               stage: int) -> torch.Tensor:
        return torch.tanh(dense)
