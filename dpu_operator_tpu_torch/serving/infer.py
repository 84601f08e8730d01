"""Forward-only ``infer_step`` built from the train_step.py model.

Counterpart of the JAX package's ``serving/infer.py``. The serving plane
runs the same stage math the five-axis training step trains
(``train_step._stage_fn``: the dense pair + the Switch MoE) as a pure
forward over a fixed ``[slots, d]`` batch, so the continuous-batching
scheduler's occupancy varies and shapes never do.

Mesh contract: the serving mesh keeps pp == sp == 1, and shards the batch
over ("dp", "ep") with the experts over ``ep``. The port's mesh is a
mapping of the five axis sizes. Its ``ep`` ranks are stacked on one card,
as every multi-rank path of the port runs them: a step's ``[slots, d]``
batch is ``[E, slots/E, d]``, rank r's rows ``r·slots/E ..``, and each
stage's two expert exchanges are one all-to-all over all ranks
(``parallel/moe.py``): the CUDA all-to-all kernel on the card (one launch
each at ep > 1; a ring of one launches nothing), its plain version on the
CPU. dp and tp stay 1 until the multi-process harness (queue 1 #7).

``DecodeStep`` keeps the slot state on the device. A step's slot updates
are staged at fixed shapes in pinned host memory and copied with
``non_blocking=True``, so dispatching a step never makes the host wait
for the card; only the caller's read of the ``[slots]`` int32 tokens
(``TokenHandle.wait``) does. The reference's ``donate`` (XLA buffer aliasing) has no PyTorch
counterpart and is not ported; its ahead-of-time compile is one warm-up
step in the constructor.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import pick_kernel, resolve_device
from ..parallel.moe import pick_exchange
from ..parallel.train_step import AXES, _stage_fn, shard_params


def serving_mesh(devices: Optional[Sequence] = None,
                 shape: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """The 5-axis (dp, pp, sp, tp, ep) serving mesh as a mapping of axis
    sizes. Default: every axis singleton, the per-replica shape; ``shape``
    sizes ``ep`` (pp and sp must stay 1; dp and tp > 1 are not ported).
    The ranks share one card; ``devices``, when given, holds one entry a
    rank and must match their count."""
    shape = dict(shape or {})
    if shape.get("pp", 1) != 1 or shape.get("sp", 1) != 1:
        raise ValueError(
            "serving mesh keeps pp == sp == 1: decode state has no "
            f"sequence axis and every stage is local, got {shape}")
    sizes = {a: int(shape.get(a, 1)) for a in AXES}
    _check_ported_axes(sizes)
    want = int(np.prod(list(sizes.values())))
    if devices is not None and len(devices) != want:
        raise ValueError(
            f"mesh shape {sizes} needs {want} devices, got {len(devices)}")
    return sizes


def _check_ported_axes(mesh: Mapping[str, int]) -> None:
    for axis in ("dp", "tp"):
        if int(mesh.get(axis, 1)) != 1:
            raise ValueError(
                f"serving mesh {axis}={mesh[axis]} is not ported yet: dp "
                f"and tp > 1 come with the multi-process harness (queue 1 "
                f"#7)")


def _check_serving_axes(mesh: Mapping[str, int]) -> None:
    for axis in ("pp", "sp"):
        if mesh[axis] != 1:
            raise ValueError(
                f"infer_step requires {axis}=1, got {mesh[axis]}")
    _check_ported_axes(mesh)


def _make_per_device(E: int, capacity_factor: float, exchange):
    """The stage stack over the E stacked ranks, shared by infer_step and
    DecodeStep: x [E, rows, d] -> [E, rows, d]."""

    def per_device(params, x):
        S = params["router"].shape[0]
        # Idle slots are EXACTLY zero-filled (the scheduler's contract)
        # and stay zero through every stage. They must also vanish from
        # MoE routing: a zero row's uniform softmax would win bucket
        # slot 0 by stream priority and, under capacity pressure, drop
        # a REAL token's dispatch — making decode occupancy-dependent.
        active = (x != 0).any(dim=-1)
        for s in range(S):
            p = {k: v[s] for k, v in params.items()}
            x = _stage_fn(p, x, E=E, tp_axis="tp", ep_axis="ep",
                          capacity_factor=capacity_factor,
                          row_mask=active, exchange=exchange)
        return x

    return per_device


def _setup(mesh: Mapping[str, int], kernel: Optional[str], device,
           owner: str):
    """(E, device, kernel, exchange) of a serving step."""
    _check_serving_axes(mesh)
    device = resolve_device(device, owner)
    kernel = pick_kernel(kernel, device)
    E = int(mesh["ep"])
    return E, device, kernel, pick_exchange(kernel, E)


def make_infer_step(mesh: Mapping[str, int], capacity_factor: float = 4.0,
                    *, kernel: Optional[str] = None, device=None):
    """infer_step(params, x[B, d]) -> y[B, d] on ``device``: one decode
    step of the stage stack. Params are the stage-stacked
    ``train_step.init_params`` layout on ``device`` (``shard_params``); x
    is a tensor or an array; B must divide by dp·ep (batch rows shard
    over both). ``kernel`` and ``device`` as in ``DecodeStep``."""
    E, device, kernel, exchange = _setup(mesh, kernel, device,
                                         "make_infer_step")
    per_device = _make_per_device(E, capacity_factor, exchange)

    def infer_step(params, x):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        B, d = x.shape
        if B % E:
            raise ValueError(f"batch {B} does not shard over dp*ep={E}")
        return per_device(params, x.view(E, B // E, d)).reshape(B, d)

    infer_step.kernel = kernel
    return infer_step


class DecodeStep:
    """Device-resident decode step: the slot state never round-trips the
    host. One call applies the step's slot updates on the device, runs
    the forward stack, and computes the per-slot argmax there; only the
    [slots] int32 token ids reach the host, when the caller reads them.

    Updates carry fixed [slots]/[slots, d] shapes: padding entries use
    index == slots, which lands in a sink row and is dropped. They are
    staged in pinned host memory and copied with ``non_blocking=True``.
    The weights are bound at build time (a weight swap means building a
    new DecodeStep); a float32 dict already on ``device`` is shared, not
    copied.

    ``kernel`` is ``"cuda"`` (the default on a CUDA device: each stage's
    two expert exchanges launch the all-to-all kernel at ep > 1) or
    ``"torch"`` (the default on the CPU: its plain version). ``device``
    None means the CUDA card, and raises without one. The constructor
    runs one warm-up step (library loads, the kernel's build), which the
    call counter does not count."""

    def __init__(self, mesh: Mapping[str, int], params, slots: int,
                 capacity_factor: float = 4.0, *,
                 kernel: Optional[str] = None, device=None):
        E, self.device, self.kernel, exchange = _setup(
            mesh, kernel, device, "DecodeStep")
        self.slots = int(slots)
        if self.slots % E:
            raise ValueError(f"slots={slots} must divide over ep={E}")
        self.E = E
        self.params = shard_params(params, mesh, self.device)
        self.d = int(self.params["w1"].shape[1])
        self._per_device = _make_per_device(E, capacity_factor, exchange)
        # Own call counter: the overflow ValueError below must name a
        # step even when the scheduler passes none (debug callers).
        self._calls = 0
        self._fwd(self.init_state())
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def init_state(self) -> torch.Tensor:
        """Fresh all-idle [slots, d] device state (exact zeros — the
        scheduler's idle-slot contract)."""
        return torch.zeros((self.slots, self.d), dtype=torch.float32,
                           device=self.device)

    def _fwd(self, x: torch.Tensor):
        y = self._per_device(
            self.params, x.view(self.E, self.slots // self.E, self.d))
        y = y.reshape(self.slots, self.d)
        return y, y.argmax(dim=1).to(torch.int32)

    def _stage(self, updates):
        """The step's updates as fixed-shape device tensors, filled in
        pinned host memory and copied without waiting for the card (the
        caching host allocator reuses a block only after its copy ran)."""
        pin = self.device.type == "cuda"
        idx = torch.full((self.slots,), self.slots, dtype=torch.int64,
                         pin_memory=pin)
        val = torch.zeros((self.slots, self.d), dtype=torch.float32,
                          pin_memory=pin)
        idx_np, val_np = idx.numpy(), val.numpy()
        for j, (i, row) in enumerate(updates):
            idx_np[j] = i
            val_np[j] = row
        if not pin:
            return idx, val
        return (idx.to(self.device, non_blocking=True),
                val.to(self.device, non_blocking=True))

    def __call__(self, x: torch.Tensor, updates=(), step=None,
                 request_ids=None):
        """(x_next, token_ids), both device tensors, possibly still being
        computed: on the card the call returns once the step is queued,
        which is what the scheduler's pipelined loop overlaps against.
        `updates` is [(slot, row[d])]. `step`/`request_ids` are
        DIAGNOSTIC context only: the batcher's seize path can legally
        race admissions close to the slot limit, and an overflow error
        that names neither the step nor the requests being admitted is
        undebuggable from a flight snapshot."""
        self._calls += 1
        if not updates:
            return self._fwd(x)
        if len(updates) > self.slots:
            step_no = self._calls if step is None else step
            rids = (", ".join(str(r) for r in request_ids)
                    if request_ids else "unknown")
            raise ValueError(
                f"{len(updates)} updates for {self.slots} slots at "
                f"decode step {step_no} (admitting request_ids: "
                f"{rids}) — at most one update per slot per step")
        idx, val = self._stage(updates)
        # Row `slots` is the sink the padding entries land in.
        ext = torch.cat([x, x.new_zeros((1, self.d))])
        ext.index_copy_(0, idx, val)
        return self._fwd(ext[:self.slots])


class TokenHandle:
    """One step's [slots] int32 token ids on their way to the host:
    ``host`` is their copy, queued with ``non_blocking=True`` into pinned
    memory from the caching host allocator, and ``done`` the CUDA event
    recorded after it, hence after the step's end (None on the CPU, where
    the copy ran before the handle was made). ``wait`` blocks on that
    copy alone, never on steps queued after it."""

    __slots__ = ("host", "done")

    def __init__(self, tokens: torch.Tensor):
        self.host = tokens.to("cpu", non_blocking=True)
        self.done = None
        if tokens.is_cuda:
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(tokens.device))

    def wait(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()


def make_decode_step(mesh: Mapping[str, int], params, slots: int,
                     capacity_factor: float = 4.0, *,
                     kernel: Optional[str] = None,
                     device=None) -> DecodeStep:
    """DecodeStep factory, the device-resident sibling of
    make_infer_step (params are bound at build time — see DecodeStep)."""
    return DecodeStep(mesh, params, slots, capacity_factor, kernel=kernel,
                      device=device)
