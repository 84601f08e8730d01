"""1F1B and interleaved-1F1B pipeline schedules: the ``pp`` axis, shaped
for training.

Counterpart of the JAX package's ``parallel/pipeline_1f1b.py``. GPipe
(``pipeline.py``) runs every forward and then every backward, so each
microbatch's activations live until its backward: a stash of O(M). 1F1B
starts a microbatch's backward as soon as it can, which caps the
microbatches in flight on a device at W_d = (v - 1)·n + (n - d) whatever M
is; the interleaved form (v chunks a device, global chunk j = s·n + d on
device d) also shrinks the bubble. Neither changes the math: the loss and
the gradients are those of the stages applied in order.

The scheduler is the reference's, statement for statement (numpy only):
``build_schedule`` is a greedy list scheduler (a backward whenever the
device is at its cap, a forward otherwise) that emits integer instruction
tables, ``[T, n]`` each: the unit a device runs at each tick (``op``,
``s``, ``m``), the buffer slots it reads and writes (``fin_k``,
``stash_k``, ``bin_k``) and what lands in its buffers after the tick
(``frecv_*``, ``brecv_*``), with the high-water marks ``Kf``, ``Kb`` and
``Ks`` that size the buffers. ``gpipe_bubble`` and ``interleave_order``
are copies too.

The executor is the port's own. The reference runs the tables as one
``lax.scan`` inside ``shard_map``, every device every tick, masking the
idle units' compute on zero ghosts, with ``ppermute`` rings carrying
activations forward and cotangents back. Here the n devices are stacked
on one card, as every multi-rank path of the port runs its ranks:
``run_schedule`` walks the tables tick by tick and device by device
within a tick, the rings become hand-offs between the devices' buffers at
the end of each tick, and idle (device, tick) pairs run nothing. A
forward unit runs the stage without a graph and stashes its input; a
backward unit rematerializes: it runs the stage again on the stashed
input with the chunk's weights as leaves (views of the stack, no copy)
and takes the input's cotangent and the weights' gradient with
``torch.autograd.grad``. The buffers are the tables' slots, so the stash
never holds more than the scheduler's high-water marks.

``make_1f1b`` runs a schedule over a pp-only mesh; the five-axis training
step (``train_step.make_train_step_1f1b``) runs its stages through
``run_schedule`` too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

IDLE, FWD, BWD = 0, 1, 2


@dataclass
class Schedule:
    """Static instruction tables, [T, n] int32 unless noted. Local chunk
    slot s ∈ [0, v); global chunk j = s * n + d for device d (round-robin
    chunk placement — what makes the interleaved ring work)."""

    n: int
    v: int
    M: int
    T: int
    op: np.ndarray          # IDLE/FWD/BWD
    s: np.ndarray           # local chunk slot of the unit
    m: np.ndarray           # microbatch of the unit
    fin_k: np.ndarray       # F: fwd_in slot to read (-1 → read x[m] directly)
    stash_k: np.ndarray     # F: stash slot to write; B: slot to read
    bin_k: np.ndarray       # B: bwd_in slot to read; F@last chunk: slot to
                            #    WRITE the loss cotangent
    # What lands in MY buffers after this tick's ppermutes:
    frecv_valid: np.ndarray
    frecv_s: np.ndarray
    frecv_k: np.ndarray
    brecv_valid: np.ndarray
    brecv_s: np.ndarray
    brecv_k: np.ndarray
    Kf: int                 # fwd_in slots per chunk (high-water)
    Kb: int                 # bwd_in slots per chunk
    Ks: int                 # stash slots per chunk
    bubble: float           # idle fraction of the T·n slot grid
    max_inflight: np.ndarray  # per-device peak outstanding microbatches

    @property
    def stages(self) -> int:
        return self.n * self.v


class _SlotPool:
    """Tracks buffer-slot allocation during scheduling so the executor's
    arrays can be sized to the true high-water mark."""

    def __init__(self):
        self.free: Dict[Tuple, List[int]] = {}
        self.size: Dict[Tuple, int] = {}
        self.held: Dict[Tuple, int] = {}

    def alloc(self, key: Tuple) -> int:
        pool = self.free.setdefault(key, [])
        if pool:
            return pool.pop()
        k = self.size.get(key, 0)
        self.size[key] = k + 1
        return k

    def release(self, key: Tuple, k: int) -> None:
        self.free.setdefault(key, []).append(k)

    def high_water(self) -> int:
        return max(self.size.values(), default=1)


def build_schedule(n: int, M: int, v: int = 1) -> Schedule:
    """Greedy 1F1B list-scheduler: forward while the device's
    outstanding microbatches are under the cap W_d = (v-1)·n + (n-d),
    backward otherwise — the classic warmup/steady/cooldown timeline.
    The cap is what makes it 1F1B: the stash stays O(S) regardless of M
    (peak in-flight == W_d, asserted in tests), and in steady state
    every F admission forces a B drain, i.e. strict alternation. For
    v=1 this reproduces the textbook schedule exactly (bubble ==
    GPipe's (n-1)/(M+n-1), memory better); for v>1 the same rule over
    round-robin chunks yields a Megatron-family interleaved schedule
    whose measured bubble beats v=1 (e.g. n=4 M=8: 0.20 vs 0.27; the
    tests assert the inequality from the emitted table, not a formula)."""
    if n < 1 or M < 1 or v < 1:
        raise ValueError(f"need n,M,v >= 1, got n={n} M={M} v={v}")
    S = n * v
    dev_of = lambda j: j % n
    slot_of = lambda j: j // n

    f_done = {}  # (j, m) -> tick
    b_done = {}
    outstanding = [0] * n
    peak = [0] * n
    W = [(v - 1) * n + (n - d) for d in range(n)]

    fwd_pool, bwd_pool, stash_pool = _SlotPool(), _SlotPool(), _SlotPool()
    fwd_slot = {}    # (j, m) -> fwd_in slot at consumer
    bwd_slot = {}    # (j, m) -> bwd_in slot at consumer
    stash_slot = {}  # (j, m) -> stash slot at owner

    rows_op, rows_s, rows_m = [], [], []
    rows_fin, rows_stash, rows_bin = [], [], []
    rows_fv, rows_fs, rows_fk = [], [], []
    rows_bv, rows_bs, rows_bk = [], [], []

    t = 0
    total_units = 2 * S * M
    done_units = 0
    while done_units < total_units:
        if t > 4 * total_units + 16:
            raise RuntimeError("scheduler livelock — dependency bug")
        op_r = [IDLE] * n
        s_r = [0] * n
        m_r = [0] * n
        fin_r = [0] * n
        stash_r = [0] * n
        bin_r = [0] * n
        fv_r, fs_r, fk_r = [0] * n, [0] * n, [0] * n
        bv_r, bs_r, bk_r = [0] * n, [0] * n, [0] * n

        chosen: List[Tuple] = [None] * n
        for d in range(n):
            f_cands = []
            b_cands = []
            for sl in range(v):
                j = sl * n + d
                for m in range(M):
                    if (j, m) not in f_done:
                        if j == 0 or f_done.get((j - 1, m), t) < t:
                            f_cands.append((m, j))
                    elif (j, m) not in b_done and f_done[(j, m)] < t:
                        if j == S - 1 or b_done.get((j + 1, m), t) < t:
                            b_cands.append((m, -j))
            # Forward while under the in-flight cap (fills the chunk
            # waves tightly — what buys the interleaved bubble win);
            # backward otherwise (drains the stash). FIFO by microbatch,
            # deepest chunk first among backwards.
            if f_cands and outstanding[d] < W[d]:
                m, j = min(f_cands)
                chosen[d] = (FWD, j, m)
            elif b_cands:
                m, negj = min(b_cands)
                chosen[d] = (BWD, -negj, m)

        for d in range(n):
            unit = chosen[d]
            if unit is None:
                continue
            op, j, m = unit
            sl = slot_of(j)
            op_r[d], s_r[d], m_r[d] = op, sl, m
            done_units += 1
            if op == FWD:
                f_done[(j, m)] = t
                outstanding[d] += 1
                peak[d] = max(peak[d], outstanding[d])
                if j == 0:
                    fin_r[d] = -1
                else:
                    k = fwd_slot.pop((j, m))
                    fin_r[d] = k
                    fwd_pool.release((d, sl), k)
                stash_r[d] = stash_pool.alloc((d, sl))
                stash_slot[(j, m)] = stash_r[d]
                if j == S - 1:
                    # Loss cotangent is produced HERE and parked in my
                    # own bwd_in until this chunk's backward runs.
                    k = bwd_pool.alloc((d, sl))
                    bwd_slot[(j, m)] = k
                    bin_r[d] = k
                else:
                    # Output ships to the next chunk's device this tick.
                    nd, ns = dev_of(j + 1), slot_of(j + 1)
                    k = fwd_pool.alloc((nd, ns))
                    fwd_slot[(j + 1, m)] = k
                    fv_r[nd], fs_r[nd], fk_r[nd] = 1, ns, k
            else:
                b_done[(j, m)] = t
                outstanding[d] -= 1
                k = bwd_slot.pop((j, m))
                bin_r[d] = k
                bwd_pool.release((d, sl), k)
                ks = stash_slot.pop((j, m))
                stash_r[d] = ks
                stash_pool.release((d, sl), ks)
                if j > 0:
                    nd, ns = dev_of(j - 1), slot_of(j - 1)
                    k = bwd_pool.alloc((nd, ns))
                    bwd_slot[(j - 1, m)] = k
                    bv_r[nd], bs_r[nd], bk_r[nd] = 1, ns, k

        rows_op.append(op_r)
        rows_s.append(s_r)
        rows_m.append(m_r)
        rows_fin.append(fin_r)
        rows_stash.append(stash_r)
        rows_bin.append(bin_r)
        rows_fv.append(fv_r)
        rows_fs.append(fs_r)
        rows_fk.append(fk_r)
        rows_bv.append(bv_r)
        rows_bs.append(bs_r)
        rows_bk.append(bk_r)
        t += 1

    T = t
    op = np.array(rows_op, np.int32)
    bubble = float((op == IDLE).sum()) / (T * n)
    return Schedule(
        n=n, v=v, M=M, T=T,
        op=op,
        s=np.array(rows_s, np.int32),
        m=np.array(rows_m, np.int32),
        fin_k=np.array(rows_fin, np.int32),
        stash_k=np.array(rows_stash, np.int32),
        bin_k=np.array(rows_bin, np.int32),
        frecv_valid=np.array(rows_fv, np.int32),
        frecv_s=np.array(rows_fs, np.int32),
        frecv_k=np.array(rows_fk, np.int32),
        brecv_valid=np.array(rows_bv, np.int32),
        brecv_s=np.array(rows_bs, np.int32),
        brecv_k=np.array(rows_bk, np.int32),
        Kf=fwd_pool.high_water(),
        Kb=bwd_pool.high_water(),
        Ks=stash_pool.high_water(),
        bubble=bubble,
        max_inflight=np.array(peak, np.int32),
    )


def gpipe_bubble(n: int, M: int) -> float:
    """GPipe's schedule-theoretic bubble with the same slot accounting
    (F and B one slot each, forward-all then backward-all): (n-1) idle
    slots per device per phase over M + n - 1 slots of phase timeline —
    the textbook (S-1)/(M+S-1) pipeline.py's docstring cites."""
    return (n - 1) / (M + n - 1)


def interleave_order(n: int, v: int) -> np.ndarray:
    """THE round-robin chunk placement, in one place: position d·v + s
    of a stacked leading dim holds global chunk s·n + d, so P('pp')
    block-sharding gives device d chunks {d, n+d, …} — the layout
    run_schedule's chunk addressing (j = s·n + my) assumes. Every
    interleave/uninterleave helper derives from this array."""
    return np.array([s * n + d for d in range(n) for s in range(v)])




def _take(a, index: np.ndarray):
    """``a[index]`` along the leading dim, for a tensor or an array."""
    if isinstance(a, torch.Tensor):
        return a[torch.from_numpy(index).to(a.device)]
    return np.asarray(a)[index]


def interleave_stack(per_stage_params: Sequence[Mapping], n: int, v: int
                     ) -> Dict:
    """Stack per-stage dicts of tensors in ``interleave_order``: position
    d·v + s holds global chunk s·n + d."""
    S = n * v
    if len(per_stage_params) != S:
        raise ValueError(f"need {S} stages for n={n} v={v}, "
                         f"got {len(per_stage_params)}")
    order = interleave_order(n, v)
    return {k: torch.stack([per_stage_params[j][k] for j in order])
            for k in per_stage_params[0]}


def uninterleave(stacked: Mapping, n: int, v: int) -> Dict:
    """Inverse of ``interleave_order`` on a stacked leading dim (tensors
    or arrays): back to the natural stage order."""
    inv = np.argsort(interleave_order(n, v))
    return {k: _take(a, inv) for k, a in stacked.items()}


def run_schedule(sched: Schedule, stage_fn: Callable, params_stacked,
                 x_mb, tgt_mb, *, norm: float,
                 counted: Optional[Tuple] = None):
    """Execute a 1F1B schedule over its n devices stacked on one device.

    ``params_stacked``: a dict of tensors whose leading dim is n·v in
    ``interleave_order`` (chunk slot s of device d at d·v + s).
    ``x_mb``/``tgt_mb``: M microbatches (a tensor or a sequence), each of
    any shape ``stage_fn`` takes and gives. ``stage_fn(p, x)`` applies one
    chunk, ``p`` being that chunk's dict of tensors.

    At each tick, each device runs its unit of the tables:
      * F: ``y = stage_fn(p, x)`` without a graph, x from the microbatches
        (chunk 0) or the device's forward buffer; x is stashed. The last
        chunk adds ``sum((y - tgt[m])²) / norm`` to the loss and parks the
        cotangent ``2·(y - tgt[m]) / norm`` in its own backward
        buffer; any other chunk ships y to the next chunk's device.
      * B: the stage runs again on the stashed input, the chunk's weights
        as leaves that share the stack's storage; ``torch.autograd.grad``
        of y against the parked cotangent gives the input's cotangent,
        shipped to the previous chunk's device, and the weights' gradient,
        added into that chunk's accumulator.
    What was shipped lands in the receivers' slots after the tick, as the
    reference's ``ppermute`` rings deliver it. ``counted``, an index into
    y, restricts the loss and the cotangent to those entries (the rest of
    the cotangent is zero).

    Returns ``(grads, loss)``: ``grads`` in ``params_stacked``'s layout,
    each chunk's sum over its backward units in tick order; ``loss`` a
    float32 scalar on the params' device."""
    n, v, S = sched.n, sched.v, sched.stages
    if len(x_mb) != sched.M:
        # The schedule is baked for M microbatches; a clamped gather
        # would silently train on duplicated/missing data.
        raise ValueError(
            f"x carries {len(x_mb)} microbatches but the schedule "
            f"was built for M={sched.M}")
    names = list(params_stacked)
    grads = {k: torch.zeros_like(t) for k, t in params_stacked.items()}
    dev = next(iter(grads.values())).device
    loss = torch.zeros((), dtype=torch.float32, device=dev)

    def slots(K):  # [device][chunk slot][k]
        return [[[None] * K for _ in range(v)] for _ in range(n)]

    fwd_in, bwd_in, stash = slots(sched.Kf), slots(sched.Kb), slots(sched.Ks)
    for t in range(sched.T):
        fsend: List = [None] * n
        bsend: List = [None] * n
        for d in range(n):
            op = int(sched.op[t, d])
            if op == IDLE:
                continue  # the bubble: no microbatch here
            s, m = int(sched.s[t, d]), int(sched.m[t, d])
            j, idx = s * n + d, d * v + s
            if op == FWD:
                fin_k = int(sched.fin_k[t, d])
                if fin_k < 0:
                    x = x_mb[m]
                else:
                    x, fwd_in[d][s][fin_k] = fwd_in[d][s][fin_k], None
                with torch.no_grad():
                    y = stage_fn({k: params_stacked[k][idx] for k in names},
                                 x)
                stash[d][s][int(sched.stash_k[t, d])] = x
                if j == S - 1:
                    diff = y - tgt_mb[m]
                    cot = 2.0 * diff / norm
                    if counted is not None:
                        diff = diff[counted]
                        kept, cot = cot[counted], torch.zeros_like(cot)
                        cot[counted] = kept
                    loss = loss + torch.sum(diff ** 2) / norm
                    bwd_in[d][s][int(sched.bin_k[t, d])] = cot
                else:
                    fsend[d] = y
            else:
                stash_k = int(sched.stash_k[t, d])
                bin_k = int(sched.bin_k[t, d])
                x, stash[d][s][stash_k] = stash[d][s][stash_k], None
                cot, bwd_in[d][s][bin_k] = bwd_in[d][s][bin_k], None
                leaves = [params_stacked[k][idx].detach().requires_grad_()
                          for k in names]
                wants = leaves
                if j > 0:
                    x = x.detach().requires_grad_()
                    wants = [x] + leaves
                with torch.enable_grad():
                    y = stage_fn(dict(zip(names, leaves)), x)
                    got = torch.autograd.grad(y, wants, cot,
                                              allow_unused=True)
                if j > 0:
                    bsend[d], got = got[0], got[1:]
                for k, g in zip(names, got):
                    if g is not None:
                        grads[k][idx].add_(g)
        for d in range(n):  # the rings: d receives from d - 1 and d + 1
            if sched.frecv_valid[t, d]:
                fwd_in[d][int(sched.frecv_s[t, d])][
                    int(sched.frecv_k[t, d])] = fsend[(d - 1) % n]
            if sched.brecv_valid[t, d]:
                bwd_in[d][int(sched.brecv_s[t, d])][
                    int(sched.brecv_k[t, d])] = bsend[(d + 1) % n]
    return grads, loss


def make_1f1b(mesh: Mapping[str, int], stage_fn: Callable, axis: str = "pp",
              v: int = 1, M: Optional[int] = None, *, device=None):
    """Returns ``step(params_stacked, x_mb, tgt_mb) -> (loss, grads)`` on
    ``device`` (None means the CUDA card, and raises without one), with
    the schedule as ``step.schedule``.

    ``params_stacked``: tensors whose leading dim is n·v in
    ``interleave_stack`` order, n = ``mesh[axis]``. ``x_mb``/``tgt_mb``:
    [M, rows, d]. ``loss``: the mean squared error over every microbatch;
    ``grads``: ``params_stacked``'s layout, what an optimizer in the same
    interleaved layout consumes. The whole 1F1B timeline (warmup forwards,
    strict alternation, cooldown backwards) is ``build_schedule(n, M,
    v)``'s tables, run by ``run_schedule``."""
    if axis not in mesh:
        raise ValueError(f"axis {axis!r} is not in the mesh {dict(mesh)}")
    n = int(mesh[axis])
    if M is None:
        raise ValueError("M (microbatch count) is static — pass it")
    device = resolve_device(device, "make_1f1b")
    sched = build_schedule(n, M, v)

    def step(params_stacked, x_mb, tgt_mb):
        for name, t in [("x", x_mb), ("target", tgt_mb),
                        *params_stacked.items()]:
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}; this pipeline "
                                 f"runs on {device}")
        leading = {s // n if s % n == 0 else s / n
                   for s in (a.shape[0] for a in params_stacked.values())}
        if leading != {v}:
            raise ValueError(
                f"each device must hold v={v} chunks (stacked leading "
                f"dim {n * v} over a {n}-way {axis!r} axis), got local "
                f"leading dims {sorted(leading)}")
        rows, dm = x_mb.shape[1], x_mb.shape[2]
        grads, loss = run_schedule(sched, stage_fn, params_stacked, x_mb,
                                   tgt_mb, norm=float(M * rows * dm))
        return loss, grads

    step.schedule = sched
    return step


def sequential_loss(per_stage_params, x_mb, tgt_mb, stage_fn):
    """Ground truth: stages in natural order on every microbatch, the mean
    squared error over everything; its autograd gradient is what the 1F1B
    schedule's hand-scheduled gradients must equal."""
    M, rows, dm = x_mb.shape
    total = 0.0
    for m in range(M):
        h = x_mb[m]
        for p in per_stage_params:
            h = stage_fn(p, h)
        total = total + torch.sum((h - tgt_mb[m]) ** 2)
    return total / (M * rows * dm)
