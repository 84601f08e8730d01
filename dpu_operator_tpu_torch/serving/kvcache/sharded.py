"""Context-parallel paged KV, in PyTorch: the K/V pools of ONE paged
replica partitioned across shard workers, behind the unchanged
two-phase submit/collect seam.

Counterpart of the JAX package's ``serving/kvcache/sharded.py``. It
composes three planes, none of which changes shape:

  * the HOST plane (kvcache/executor.py) stays global on the
    coordinator: the allocator, leases, prefix tree and the per-step
    ``_StepPlan`` are exactly the single-worker ones — a sharded
    replica plans like one worker and stores like ``world`` of them;
  * the DEVICE plane splits into per-rank ``PagedRankStep`` partial
    steps (kvcache/paged.py) along the axis the replica's ``KVSpec``
    declares — "head" (Ulysses: all pages, a head slice of each; a
    rank launches the paged-attention kernel at its own head count,
    and decode and k+1 speculative verify windows attend entirely
    locally) or "page" (ring: all heads of a block-id range; each rank
    scans only its own pages in the plain composition and the
    coordinator folds the flash partials with ring attention's
    online-softmax recurrence, ``merge_partial_softmax``);
  * the SHARD plane's failure semantics (serving/sharded/synthetic.py)
    carry over typed: per-rank fault sites ``{site}{rank}.step``,
    generation-keyed poison, an ``outstanding()`` leak ledger, and a
    ``reset()`` re-rendezvous that RESPAWNS workers but KEEPS every
    rank's pool slice — which is exactly why a seize→requeue after a
    shard kill re-attaches leases with all ranks' pages intact.

Per appended token rank r stores ``1/world`` of the bytes (a head slice
on the head axis, a whole page every ``world``-th block on the page
axis), so at fixed memory a rank holds ``world`` times the context;
``KVSpec.rank_resident_nbytes`` is that arithmetic.

Two backends, one duck: ``SyntheticKVShardSet`` (rank threads and a
coordinator thread in one process; on a CUDA device every rank shares
the card, each on its own stream) and ``KVShardProcessSet`` (one
``python -m dpu_operator_tpu_torch.serving.sharded.shard_worker --kv``
process a rank, over the shard plane's framed protocol). Both decode
token streams byte-identical to the single-worker ``PagedKVExecutor``
on the head axis: a rank's heads go through the same fused call as the
single worker's, and every rank and the coordinator's finish step read
one set of weights (``build_paged_params``). On the page axis the
rank-ordered fold reassociates the softmax, so equality is argmax
stability, as in the reference.

Unlike the reference's, a rank's pools are updated in place. Every read
or write of them (its step, a page export or import) runs on the rank's
stream under the rank's lock, after every earlier one.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import contextlib
import os

import numpy as np
import torch

from ... import faults
from ...device import resolve_device
from ...obs import trace as obs_trace
from ..sharded.synthetic import (ShardAborted, ShardStepError,
                                 ShardTimeout)
from .executor import KVExecutorBase, _StepPlan

__all__ = ["SyntheticKVShardSet", "KVShardProcessSet",
           "ShardedPagedKVExecutor", "resolve_shard_axis"]


def resolve_shard_axis(axis: str, heads: int, world: int) -> str:
    """The ring-vs-Ulysses selection rule (docs/serving.md): "auto"
    picks head sharding whenever the Ulysses constraint holds
    (``heads % world == 0`` — decode/verify windows then attend
    all-local), page sharding otherwise. Explicit "head"/"page" pass
    through; validity is the KVSpec's job."""
    if axis == "auto":
        return "head" if heads % world == 0 else "page"
    return axis


def _np(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype))


def _on_stream(stream):
    """Queue what follows on ``stream`` (None: the CPU, no streams)."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


def _dev(a, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on ``device``, queued on the current
    stream."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


def _after(stream, device) -> None:
    """The caller's current stream waits for ``stream``: work queued
    later (a draft reading the weights) follows what it made."""
    if stream is not None:
        torch.cuda.current_stream(device).wait_stream(stream)


def _new_stream(device):
    return (torch.cuda.Stream(device=device) if device.type == "cuda"
            else None)


class _KVJob:
    """One submitted step: the plan payload plus per-rank reply slots
    — the reply-board idiom of the row plane's ``_StepHandle``."""

    __slots__ = ("gen", "step_no", "payload", "done", "tokens",
                 "error", "partials", "rank_err", "rank_ev", "t0")

    def __init__(self, gen: int, step_no: int, payload: dict,
                 world: int):
        self.gen = gen
        self.step_no = step_no
        self.payload = payload
        self.done = threading.Event()
        self.tokens: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        self.partials: Dict[int, tuple] = {}
        self.rank_err: Dict[int, Exception] = {}
        self.rank_ev = [threading.Event() for _ in range(world)]
        self.t0 = time.monotonic()

    def abort(self, exc: Exception) -> None:
        self.error = exc
        for ev in self.rank_ev:
            ev.set()
        self.done.set()


class _RankState:
    """One rank's pool slice + compiled partial step. Owned by the
    SET, not the worker thread: a re-rendezvous respawns the thread
    and hands it the SAME state — pages survive, which is the whole
    point of re-attach."""

    def __init__(self, step, lock: threading.Lock, stream=None):
        self.step = step
        self.lock = lock
        #: Every read or write of this rank's pools queues here.
        self.stream = stream
        with _on_stream(stream):
            (self.kpool, self.kscale,
             self.vpool, self.vscale) = step.init_pools()


class SyntheticKVShardSet:
    """In-process KV shard workers: ``world`` rank threads each
    owning one pool slice, plus a coordinator thread that sequences
    the token recurrence (rank partials → merge → finish → prev). On a
    CUDA device every rank runs on the one card, on a stream of its
    own, and the ranks and the finish step share one device copy of the
    weights. ``device=None`` means the card; ``kernel`` is the rank
    steps' (``PagedRankStep``)."""

    def __init__(self, spec, *, slots: int, num_blocks: int,
                 chunk: int, per_pos: bool = False,
                 kernel: Optional[str] = None, device=None,
                 fault_site: str = "kvshard",
                 step_timeout_s: float = 30.0):
        from .paged import (PagedFinishStep, PagedRankStep,
                            build_paged_params, params_from_numpy)

        spec.validate_codec(spec.default_codec())
        self.spec = spec
        self.world = int(spec.world)
        self.slots = int(slots)
        self.num_blocks = int(num_blocks)
        self.chunk = int(chunk)
        self.per_pos = bool(per_pos)
        self.fault_site = str(fault_site)
        self.step_timeout_s = float(step_timeout_s)
        d = spec.heads * spec.d_head
        self.device = resolve_device(device, "SyntheticKVShardSet")
        #: The coordinator's stream: the weights' upload, the finish.
        self._stream = _new_stream(self.device)
        with _on_stream(self._stream):
            # ONE device copy of the weights, read by every rank step
            # and the finish step.
            params = params_from_numpy(build_paged_params(
                spec.seed, spec.vocab, d, spec.max_context), self.device)
            self._finish = PagedFinishStep(
                slots=slots, vocab=spec.vocab, d=d,
                block_size=spec.block_size,
                max_blocks_per_req=spec.max_blocks_per_req, chunk=chunk,
                seed=spec.seed, per_pos=per_pos, params=params,
                device=self.device)
        self._states: List[_RankState] = []
        for r in range(self.world):
            stream = _new_stream(self.device)
            if stream is not None:
                stream.wait_stream(self._stream)
            with _on_stream(stream):
                step = PagedRankStep(
                    slots=slots, vocab=spec.vocab, d=d, heads=spec.heads,
                    block_size=spec.block_size, num_blocks=num_blocks,
                    max_blocks_per_req=spec.max_blocks_per_req,
                    chunk=chunk, shard_axis=spec.shard_axis,
                    head_bounds=spec.rank_heads(r),
                    block_bounds=spec.rank_blocks(r, num_blocks),
                    seed=spec.seed, pool_dtype=spec.pool_dtype,
                    kernel=kernel, params=params, device=self.device)
            self._states.append(_RankState(step, threading.Lock(),
                                           stream))
        _after(self._stream, self.device)
        self.draft_params = self._finish.draft_params
        self._lock = threading.Lock()
        self._gen = 0
        self._closed = False
        self._poisoned: Optional[Exception] = None
        self._prev = np.zeros((self.slots,), np.int32)
        self._outstanding: set = set()
        self.resets = 0
        self._spawn()

    # -- worker lifecycle -----------------------------------------------------

    def _spawn(self) -> None:
        gen = self._gen
        self._rank_qs = [queue.Queue() for _ in range(self.world)]
        self._coord_q: "queue.Queue" = queue.Queue()
        self._threads = []
        for r in range(self.world):
            t = threading.Thread(target=self._rank_loop,
                                 args=(r, gen), daemon=True,
                                 name=f"kvshard-{r}")
            t.start()
            self._threads.append(t)
        self._coord = threading.Thread(target=self._coord_loop,
                                       args=(gen,), daemon=True,
                                       name="kvshard-coord")
        self._coord.start()

    def reset(self) -> None:
        """Re-rendezvous: bump the generation (a possibly-hung worker
        wakes to a stale gen and drops its job), abort every
        outstanding step, respawn the worker threads — and KEEP every
        rank's pools. The surviving pages are what a post-seize
        re-attach resumes on."""
        t0 = time.monotonic()
        with self._lock:
            # Revivable after close() — the _GuardedWorker discipline:
            # ReplicaPool.stop() closes every executor, and the next
            # pool's batcher start re-opens it through reset().
            self._closed = False
            self._gen += 1
            self._poisoned = None
            stale = set(self._outstanding)
            for job in stale:
                job.abort(ShardAborted(
                    f"kv shard set reset at gen {self._gen}"))
            self._outstanding.difference_update(stale)
            self._prev = np.zeros((self.slots,), np.int32)
            self.resets += 1
            self._spawn()
        obs_trace.get_tracer().record_span(
            "kvshard.rendezvous", t0, time.monotonic(),
            attrs={"world": self.world, "resets": self.resets,
                   "gen": self._gen})

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._gen += 1
            for job in set(self._outstanding):
                job.abort(ShardAborted("kv shard set closed"))
            self._outstanding.clear()

    def live_ranks(self) -> List[int]:
        return [r for r, t in enumerate(self._threads)
                if t.is_alive()]

    def outstanding(self) -> int:
        """Leak ledger: steps submitted and never collected nor
        aborted. Clean teardown means 0 — the board sibling of the
        allocator's ``assert_clean``."""
        return len(self._outstanding)

    # -- the two-phase backend contract ---------------------------------------

    def submit(self, payload: dict) -> _KVJob:
        with self._lock:
            if self._closed:
                raise ShardAborted("kv shard set is closed")
            job = _KVJob(self._gen, int(payload["step_no"]), payload,
                         self.world)
            if self._poisoned is not None:
                job.abort(ShardAborted(
                    f"kv shard gen {self._gen} poisoned: "
                    f"{self._poisoned}"))
                return job
            self._outstanding.add(job)
            q = self._coord_q
        # Enqueue outside the lock (GL004). If a reset slips between,
        # the job was already aborted from _outstanding and the stale
        # generation's coordinator drops it on its gen check.
        q.put(job)
        return job

    def collect(self, job: _KVJob, timeout: float) -> np.ndarray:
        ok = job.done.wait(timeout)
        with self._lock:
            self._outstanding.discard(job)
        if not ok:
            raise ShardTimeout(
                f"kv shard step {job.step_no} not done in "
                f"{timeout:.1f}s (live ranks: {self.live_ranks()})")
        if job.error is not None:
            raise job.error
        return job.tokens

    # -- worker loops ---------------------------------------------------------

    def _rank_loop(self, rank: int, gen: int) -> None:
        st = self._states[rank]
        q = self._rank_qs[rank]
        site = f"{self.fault_site}{rank}.step"
        while not self._closed and self._gen == gen:
            try:
                got = q.get(timeout=0.2)
            except queue.Empty:
                continue
            job, prev = got
            if job.gen != self._gen or job.error is not None:
                job.rank_ev[rank].set()
                continue
            try:
                faults.fire(site, attrs={"rank": rank,
                                         "step": job.step_no})
                p = job.payload
                dev = st.step.device
                with st.lock, _on_stream(st.stream):
                    out = st.step(
                        st.kpool, st.kscale, st.vpool, st.vscale,
                        _dev(prev, dev), _dev(p["host_tok"], dev),
                        _dev(p["use_host"], dev), _dev(p["ctx"], dev),
                        _dev(p["n_new"], dev), _dev(p["tables"], dev))
                    (st.kpool, st.kscale, st.vpool,
                     st.vscale) = out[:4]
                    # The copy to the host waits for this rank's step.
                    job.partials[rank] = tuple(
                        a.cpu().numpy() for a in out[4:])
            except Exception as e:  # noqa: BLE001 - posted typed
                job.rank_err[rank] = e
            job.rank_ev[rank].set()

    def _coord_loop(self, gen: int) -> None:
        """Sequences the token recurrence: rank partials for step N
        merge and finish BEFORE step N+1's rank work is released (the
        single-worker device recurrence, reconstructed across
        workers). Pipelining survives upward: submit() never blocks —
        the batcher's host bookkeeping overlaps all of this."""
        while not self._closed and self._gen == gen:
            try:
                job = self._coord_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if job.gen != self._gen or job.error is not None:
                continue
            prev = self._prev
            for r in range(self.world):
                self._rank_qs[r].put((job, prev))
            deadline = time.monotonic() + self.step_timeout_s
            err: Optional[Exception] = None
            for r in range(self.world):
                if not job.rank_ev[r].wait(
                        max(0.0, deadline - time.monotonic())):
                    err = ShardTimeout(
                        f"rank {r} silent for step {job.step_no}",
                        rank=r)
                    break
                if r in job.rank_err:
                    cause = job.rank_err[r]
                    err = ShardStepError(
                        f"rank {r} failed step {job.step_no}: "
                        f"{cause}", rank=r)
                    err.__cause__ = cause
                    break
            if job.gen != self._gen:
                continue
            if err is not None:
                with self._lock:
                    # Permanent poison for this generation — the
                    # reduce-board rule: a half-stepped pool set must
                    # never serve another step until re-rendezvous.
                    self._poisoned = err
                job.abort(err)
                continue
            tokens = self._merge_and_finish(job, prev)
            if not self.per_pos:
                self._prev = tokens
            job.tokens = tokens
            job.done.set()

    def _merge_and_finish(self, job: _KVJob,
                          prev: np.ndarray) -> np.ndarray:
        from ...parallel.ring_attention import merge_partial_softmax
        from ...parallel.ulysses_attention import concat_head_partials

        S, C = self.slots, self.chunk
        H, dh = self.spec.heads, self.spec.d_head
        if self.spec.shard_axis == "head":
            o = concat_head_partials(
                [job.partials[r][0] for r in range(self.world)])
        else:
            merged = merge_partial_softmax(
                [job.partials[r] for r in range(self.world)])
            o = np.transpose(merged, (0, 2, 1, 3))  # [S,C,H,dh]
        p = job.payload
        dev = self._finish.device
        with _on_stream(self._stream):
            return self._finish(
                _dev(prev, dev), _dev(p["host_tok"], dev),
                _dev(p["use_host"], dev), _dev(p["ctx"], dev),
                _dev(p["n_new"], dev),
                _dev(o.reshape(S, C, H * dh), dev)).cpu().numpy()

    # -- page export/import (per-rank plane sets) -----------------------------

    def export_rank_pages(self, blocks: Sequence[int]
                          ) -> Tuple[list, List[int]]:
        """Gather the written pages rank by rank:
        ``([(k, ksc), (v, vsc)] per rank, rank_block_counts)``. Head
        axis ships every rank's head slice of ALL requested blocks;
        page axis ships each rank's OWNED subset (in request order) —
        the per-rank point-to-point sets the disagg stream frames
        with ``KVSpec.rank_view`` geometry."""
        blocks = [int(b) for b in blocks]
        planes, counts = [], []
        for r, st in enumerate(self._states):
            mine = self._rank_owned(r, blocks)
            idx = _np([blocks[j] for j in mine]
                      if self.spec.shard_axis == "page" else blocks,
                      np.int64)
            if self.spec.shard_axis == "page":
                lo, _ = self.spec.rank_blocks(r, self.num_blocks)
                idx = idx - lo
            # On the rank's stream: after every step queued before it.
            with st.lock, _on_stream(st.stream):
                i = _dev(idx, st.step.device)
                planes.append([
                    (st.kpool[i].cpu().numpy(),
                     st.kscale[i].cpu().numpy()),
                    (st.vpool[i].cpu().numpy(),
                     st.vscale[i].cpu().numpy())])
            counts.append(len(mine) if self.spec.shard_axis == "page"
                          else len(blocks))
        return planes, counts

    def import_rank_pages(self, blocks: Sequence[int],
                          rank_planes: list, meta: dict) -> None:
        """Scatter per-SOURCE-rank plane sets into this set's pools at
        freshly acquired block ids. Head axis: source rank r's slice
        IS dest rank r's slice (the hello check pinned world and
        axis). Page axis: reassemble request order from the source's
        ``rank_index``, then re-scatter by DEST ownership — fresh ids
        land wherever the dest partition puts them."""
        blocks = [int(b) for b in blocks]
        if self.spec.shard_axis == "head":
            for r, st in enumerate(self._states):
                (k, ksc), (v, vsc) = rank_planes[r]
                _write_pages(st, _np(blocks, np.int64), k, ksc, v, vsc)
            return
        # Page axis: request-order reassembly, then dest scatter.
        order = meta["rank_index"]
        n = len(blocks)
        full: List[Optional[tuple]] = [None] * n
        for r, mine in enumerate(order):
            (k, ksc), (v, vsc) = rank_planes[r]
            for i, j in enumerate(mine):
                full[j] = (k[i], ksc[i], v[i], vsc[i])
        for r, st in enumerate(self._states):
            lo, _ = self.spec.rank_blocks(r, self.num_blocks)
            mine = self._rank_owned(r, blocks)
            if not mine:
                continue
            idx = _np([blocks[j] - lo for j in mine], np.int64)
            k = np.stack([full[j][0] for j in mine])
            ksc = np.stack([full[j][1] for j in mine])
            v = np.stack([full[j][2] for j in mine])
            vsc = np.stack([full[j][3] for j in mine])
            _write_pages(st, idx, k, ksc, v, vsc)

    def _rank_owned(self, rank: int, blocks: List[int]) -> List[int]:
        """Indices (into ``blocks``) of the entries rank's pool holds
        — spec-derived bounds, request order preserved."""
        lo, hi = self.spec.rank_blocks(rank, self.num_blocks)
        return [j for j, b in enumerate(blocks) if lo <= b < hi]


def _write_pages(st: _RankState, idx: np.ndarray, k, ksc, v,
                 vsc) -> None:
    """Host planes into a rank's pools at local block ids ``idx``, in
    place: queued on the rank's stream under its lock, so every step
    queued before it runs on the old contents and every step after it
    sees the whole import."""
    dev = st.step.device
    with st.lock, _on_stream(st.stream):
        i = _dev(idx, dev)
        st.kpool[i] = _dev(k, dev, st.kpool.dtype)
        st.kscale[i] = _dev(ksc, dev, torch.float32)
        st.vpool[i] = _dev(v, dev, st.vpool.dtype)
        st.vscale[i] = _dev(vsc, dev, torch.float32)


class KVShardProcessSet:
    """Real-subprocess KV shard workers (``shard_worker --kv``): the
    same backend duck as ``SyntheticKVShardSet`` with each rank's
    pool slice and partial step living in its own OS process, frames
    over the sharded plane's ``protocol.py`` transport. The
    coordinator (in-process thread) still owns merge/finish and the
    token recurrence — workers are stateless but for their pools,
    exactly the control/bulk split the row-plane worker uses.

    Each rank process runs the port's own entry,
    ``python -m dpu_operator_tpu_torch.serving.sharded.shard_worker
    --kv``, on ``device`` (``None``: the card; the coordinator's finish
    step runs there too).

    Scope: the world-equivalence smoke (decode paths). Page
    export/import stays on the in-process backend — migrating a
    sharded lease out of subprocess pools belongs with host-tier
    (tiering) work."""

    def __init__(self, spec, *, slots: int, num_blocks: int,
                 chunk: int, per_pos: bool = False,
                 step_timeout_s: float = 60.0,
                 spawn_timeout_s: float = 120.0, device=None):
        import socket
        import subprocess
        import sys

        from ..sharded.protocol import recv_msg, send_msg
        from .paged import PagedFinishStep

        self._send, self._recv = send_msg, recv_msg
        self.spec = spec
        self.world = int(spec.world)
        self.slots = int(slots)
        self.num_blocks = int(num_blocks)
        self.chunk = int(chunk)
        self.per_pos = bool(per_pos)
        self.step_timeout_s = float(step_timeout_s)
        d = spec.heads * spec.d_head
        self.device = resolve_device(device, "KVShardProcessSet")
        self._stream = _new_stream(self.device)
        with _on_stream(self._stream):
            self._finish = PagedFinishStep(
                slots=slots, vocab=spec.vocab, d=d,
                block_size=spec.block_size,
                max_blocks_per_req=spec.max_blocks_per_req, chunk=chunk,
                seed=spec.seed, per_pos=per_pos, device=self.device)
        _after(self._stream, self.device)
        self.draft_params = self._finish.draft_params
        self._lock = threading.Lock()
        self._gen = 0
        self._closed = False
        self._poisoned: Optional[Exception] = None
        self._prev = np.zeros((self.slots,), np.int32)
        self._outstanding: set = set()
        self.resets = 0
        self._procs, self._socks = [], []
        listeners = []
        # The package's parent directory, so that ``-m`` finds it.
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        for r in range(self.world):
            srv = socket.socket()
            srv.bind(("127.0.0.1", 0))
            srv.listen(1)
            listeners.append(srv)
            cmd = [sys.executable, "-m",
                   "dpu_operator_tpu_torch.serving.sharded.shard_worker",
                   "--kv", "--rank", str(r),
                   "--connect",
                   f"127.0.0.1:{srv.getsockname()[1]}",
                   "--slots", str(slots),
                   "--num-blocks", str(num_blocks),
                   "--chunk", str(chunk),
                   "--kv-spec", _spec_argv(spec),
                   "--device", str(self.device)]
            self._procs.append(subprocess.Popen(cmd, cwd=root))
        for r, srv in enumerate(listeners):
            srv.settimeout(spawn_timeout_s)
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                self.close()
                raise ShardTimeout(
                    f"kv shard worker {r} never connected", rank=r)
            finally:
                srv.close()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                            1)
            self._socks.append(conn)
            hello, _ = recv_msg(conn, spawn_timeout_s)
            if hello.get("op") != "hello":
                raise ShardStepError(
                    f"rank {r} bad hello {hello}", rank=r)
        self._coord_q: "queue.Queue" = queue.Queue()
        self._spawn_coord()

    def _spawn_coord(self) -> None:
        gen = self._gen
        self._coord = threading.Thread(target=self._coord_loop,
                                       args=(gen,), daemon=True,
                                       name="kvproc-coord")
        self._coord.start()

    def reset(self) -> None:
        with self._lock:
            self._gen += 1
            self._poisoned = None
            stale = set(self._outstanding)
            for job in stale:
                job.abort(ShardAborted("kv proc set reset"))
            self._outstanding.difference_update(stale)
            self._prev = np.zeros((self.slots,), np.int32)
            self.resets += 1
            self._coord_q = queue.Queue()
            self._spawn_coord()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._gen += 1
            for job in set(self._outstanding):
                job.abort(ShardAborted("kv proc set closed"))
            self._outstanding.clear()
        for s in getattr(self, "_socks", ()):
            try:
                self._send(s, {"op": "close"})
                s.close()
            except Exception:
                pass
        for p in self._procs:
            try:
                p.wait(timeout=10)
            except Exception:
                p.kill()

    def live_ranks(self) -> List[int]:
        return [r for r, p in enumerate(self._procs)
                if p.poll() is None]

    def outstanding(self) -> int:
        return len(self._outstanding)

    def submit(self, payload: dict) -> _KVJob:
        with self._lock:
            if self._closed:
                raise ShardAborted("kv proc set is closed")
            job = _KVJob(self._gen, int(payload["step_no"]), payload,
                         self.world)
            if self._poisoned is not None:
                job.abort(ShardAborted(
                    f"gen poisoned: {self._poisoned}"))
                return job
            self._outstanding.add(job)
            q = self._coord_q
        # Enqueue outside the lock (GL004): same discipline as the
        # synthetic set's submit.
        q.put(job)
        return job

    def collect(self, job: _KVJob, timeout: float) -> np.ndarray:
        ok = job.done.wait(timeout)
        with self._lock:
            self._outstanding.discard(job)
        if not ok:
            raise ShardTimeout(
                f"kv proc step {job.step_no} not done in "
                f"{timeout:.1f}s (live: {self.live_ranks()})")
        if job.error is not None:
            raise job.error
        return job.tokens

    def _coord_loop(self, gen: int) -> None:
        S, C = self.slots, self.chunk
        H, dh = self.spec.heads, self.spec.d_head
        B = self.spec.max_blocks_per_req
        head = self.spec.shard_axis == "head"
        while not self._closed and self._gen == gen:
            try:
                job = self._coord_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if job.gen != self._gen or job.error is not None:
                continue
            p = job.payload
            prev = self._prev
            payload = b"".join([
                _np(prev, np.int32).tobytes(),
                _np(p["host_tok"], np.int32).tobytes(),
                _np(p["use_host"], np.uint8).tobytes(),
                _np(p["ctx"], np.int32).tobytes(),
                _np(p["n_new"], np.int32).tobytes(),
                _np(p["tables"], np.int32).tobytes()])
            err: Optional[Exception] = None
            try:
                for s in self._socks:
                    self._send(s, {"op": "step",
                                   "step": job.step_no}, payload)
                for r, s in enumerate(self._socks):
                    reply, buf = self._recv(s, self.step_timeout_s)
                    if reply.get("op") != "partial":
                        raise ShardStepError(
                            f"rank {r} replied {reply}", rank=r)
                    hr = int(reply["heads"])
                    if head:
                        o = np.frombuffer(
                            buf, np.float32).reshape(S, C, hr, dh)
                        job.partials[r] = (o,)
                    else:
                        stats = S * H * C
                        m = np.frombuffer(
                            buf, np.float32,
                            count=stats).reshape(S, H, C)
                        l = np.frombuffer(
                            buf, np.float32, count=stats,
                            offset=4 * stats).reshape(S, H, C)
                        o = np.frombuffer(
                            buf, np.float32,
                            offset=8 * stats).reshape(S, H, C, dh)
                        job.partials[r] = (m, l, o)
            except Exception as e:  # noqa: BLE001 - typed upward
                err = e if isinstance(e, ShardStepError) else \
                    ShardStepError(f"kv proc step failed: {e}")
                err.__cause__ = e
            if job.gen != self._gen:
                continue
            if err is not None:
                with self._lock:
                    self._poisoned = err
                job.abort(err)
                continue
            tokens = self._merge_and_finish(job, prev)
            if not self.per_pos:
                self._prev = tokens
            job.tokens = tokens
            job.done.set()
        _ = B  # geometry pinned by the spec argv, kept for clarity

    # Same fold as the synthetic set — one definition would be nicer
    # still, but the two classes share it via this module.
    _merge_and_finish = SyntheticKVShardSet._merge_and_finish


def _spec_argv(spec) -> str:
    """KVSpec → one argv token for the worker (k=v CSV over the
    fingerprint) — the worker rebuilds the spec and derives its OWN
    slice bounds from it, never receiving raw geometry."""
    return ",".join(f"{k}={v}" for k, v in
                    sorted(spec.fingerprint().items()))


def spec_from_argv(text: str):
    from ..disagg.spec import KVSpec

    kw: dict = {}
    for part in text.split(","):
        k, v = part.split("=", 1)
        kw[k] = v if k in ("model", "pool_dtype", "shard_axis") \
            else int(v)
    return KVSpec(**kw)


def serve_kv_rank(sock, rank: int, spec, *, slots: int,
                  num_blocks: int, chunk: int, device=None) -> None:
    """The ``shard_worker --kv`` serve loop: one rank's pool slice +
    partial step behind reset/step/close frames. Geometry comes from
    the spec ONLY (rank_heads/rank_blocks — the GL018 discipline
    holds across the process boundary). The step runs on ``device``
    (``None``: the card) under the rank step's kernel rule: a head
    rank on the card launches the paged-attention kernel."""
    from ..sharded.protocol import recv_msg, send_msg
    from .paged import PagedRankStep

    d = spec.heads * spec.d_head
    step = PagedRankStep(
        slots=slots, vocab=spec.vocab, d=d, heads=spec.heads,
        block_size=spec.block_size, num_blocks=num_blocks,
        max_blocks_per_req=spec.max_blocks_per_req, chunk=chunk,
        shard_axis=spec.shard_axis,
        head_bounds=spec.rank_heads(rank),
        block_bounds=spec.rank_blocks(rank, num_blocks),
        seed=spec.seed, pool_dtype=spec.pool_dtype, device=device)
    dev = step.device
    kpool, kscale, vpool, vscale = step.init_pools()
    S, C, B = slots, chunk, spec.max_blocks_per_req
    send_msg(sock, {"op": "hello", "rank": rank,
                    "spec": spec.fingerprint()})
    sizes = np.cumsum([S * 4, S * C * 4, S, S * 4, S * 4,
                       S * B * 4])
    while True:
        msg, buf = recv_msg(sock, timeout=None)
        op = msg.get("op")
        if op == "close":
            return
        if op == "reset":
            kpool, kscale, vpool, vscale = step.init_pools()
            send_msg(sock, {"op": "reset-ok"})
            continue
        if op != "step":
            send_msg(sock, {"op": "error",
                            "error": f"unknown op {op!r}"})
            continue
        prev = np.frombuffer(buf[:sizes[0]], np.int32)
        host_tok = np.frombuffer(
            buf[sizes[0]:sizes[1]], np.int32).reshape(S, C)
        use_host = np.frombuffer(
            buf[sizes[1]:sizes[2]], np.uint8).astype(bool)
        ctx = np.frombuffer(buf[sizes[2]:sizes[3]], np.int32)
        n_new = np.frombuffer(buf[sizes[3]:sizes[4]], np.int32)
        tables = np.frombuffer(
            buf[sizes[4]:sizes[5]], np.int32).reshape(S, B)
        out = step(kpool, kscale, vpool, vscale,
                   _dev(prev, dev), _dev(host_tok, dev),
                   _dev(use_host, dev), _dev(ctx, dev),
                   _dev(n_new, dev), _dev(tables, dev))
        kpool, kscale, vpool, vscale = out[:4]
        parts = [np.ascontiguousarray(a.cpu().numpy(), np.float32)
                 for a in out[4:]]
        send_msg(sock, {"op": "partial", "step": msg.get("step"),
                        "heads": step.pool_heads}, *parts)


class ShardedPagedKVExecutor(KVExecutorBase):
    """Context-parallel ``PagedKVExecutor``: same host plane, same
    modes (pipelined / sync / speculative), same submit/collect seam
    — the K/V pools live sliced across a KV shard set. The batcher,
    supervisor, chaos matrix and speculative mode ride it untouched;
    token streams are byte-identical to the single-worker executor
    on the same trace (the tier-1 equivalence lane's contract).

    ``device=None`` means the card, as ``PagedKVExecutor``'s;
    ``kernel`` is the rank steps' (``None``: the paged-attention kernel
    for head ranks on the card, the plain composition otherwise)."""

    def __init__(self, slots: int = 4, vocab: int = 64, d: int = 16,
                 heads: int = 2, block_size: int = 4,
                 num_blocks: int = 128, max_blocks_per_req: int = 16,
                 prefill_chunk: int = 8,
                 prefill_budget: Optional[int] = None,
                 prefix_cache: bool = True, seed: int = 0,
                 mode: str = "pipelined", warmup: bool = True,
                 kernel: Optional[str] = None,
                 pool_dtype: str = "int8",
                 spec_k: int = 4, draft=None,
                 world: int = 2, shard_axis: str = "auto",
                 fault_site: str = "kvshard",
                 backend: Optional[object] = None,
                 step_timeout_s: float = 30.0, device=None):
        if mode not in ("pipelined", "sync", "speculative"):
            raise ValueError(f"mode must be pipelined|sync|"
                             f"speculative, got {mode!r}")
        speculative = mode == "speculative"
        super().__init__(slots, vocab=vocab, block_size=block_size,
                         num_blocks=num_blocks,
                         max_blocks_per_req=max_blocks_per_req,
                         prefill_chunk=prefill_chunk,
                         prefill_budget=prefill_budget,
                         prefix_cache=prefix_cache,
                         pipelined=mode == "pipelined")
        from ..spec import SpecConfig, TruncatedDraft
        from ..disagg.spec import KVSpec

        self._seed = int(seed)
        axis = resolve_shard_axis(shard_axis, heads, world)
        self._kvspec = KVSpec(
            model="paged", block_size=block_size, heads=heads,
            d_head=d // heads, vocab=vocab,
            max_blocks_per_req=max_blocks_per_req,
            pool_dtype=pool_dtype, planes=2, seed=seed,
            shard_axis=axis, world=world)
        self._timeout = float(step_timeout_s)
        if backend is None:
            backend = SyntheticKVShardSet(
                self._kvspec, slots=slots, num_blocks=num_blocks,
                chunk=prefill_chunk, per_pos=speculative,
                kernel=kernel, device=device,
                fault_site=fault_site,
                step_timeout_s=step_timeout_s)
        self.shards = backend
        if speculative:
            if draft is None:
                draft = TruncatedDraft(
                    *backend.draft_params, spec_k, slots)
            self._install_spec(SpecConfig(draft, spec_k))
        if warmup:
            self.collect(self.submit((), gen=self._gen))
            self.reset()

    # -- backend hooks --------------------------------------------------------

    @property
    def world(self) -> int:
        return self._kvspec.world

    def _backend_reset(self) -> None:
        # Pools survive on every rank (the shard set's reset keeps
        # _RankState); only the recurrence and in-flight steps drop.
        self.shards.reset()

    def _spec_fields(self) -> dict:
        sp = self._kvspec
        return dict(model=sp.model, block_size=sp.block_size,
                    heads=sp.heads, d_head=sp.d_head, vocab=sp.vocab,
                    max_blocks_per_req=sp.max_blocks_per_req,
                    pool_dtype=sp.pool_dtype, planes=sp.planes,
                    seed=sp.seed, shard_axis=sp.shard_axis,
                    world=sp.world)

    def _dispatch(self, plan: _StepPlan):
        return self.shards.submit(dict(
            step_no=plan.step_no, host_tok=plan.host_tok,
            use_host=plan.use_host, ctx=plan.ctx, n_new=plan.n_new,
            tables=plan.tables))

    def _materialize(self, raw) -> np.ndarray:
        return self.shards.collect(raw, timeout=self._timeout)

    def close(self) -> None:
        self.shards.close()

    # -- per-rank observability ----------------------------------------------

    def kv_rank_stats(self) -> Dict[int, Dict[str, int]]:
        """Per-rank resident page counts for the ``rank``-labelled
        ``serving_kv_blocks`` series: page axis counts each rank's
        owned slice of the allocator's live blocks; head axis pins
        every block on every rank (each holds its head slice of it).
        Derived from the spec's partition + the allocator's refcounts
        — the pools themselves are never touched at scrape time."""
        spec, alloc = self._kvspec, self.allocator
        used_ids = [b for b in range(self.num_blocks)
                    if alloc.refcount(b) > 0]
        out: Dict[int, Dict[str, int]] = {}
        for r in range(spec.world):
            lo, hi = spec.rank_blocks(r, self.num_blocks)
            used = (len([b for b in used_ids if lo <= b < hi])
                    if spec.shard_axis == "page" else len(used_ids))
            out[r] = {"blocks_used": used,
                      "blocks_free": (hi - lo) - used
                      if spec.shard_axis == "page"
                      else self.num_blocks - used}
        return out

    # -- per-rank transfer plane ----------------------------------------------

    def kv_export(self, req, detach: dict):
        meta, planes = super().kv_export(req, detach)
        n_blocks = int(meta["n_blocks"])
        lease = detach["lease"]
        blocks = [int(b) for b in lease.blocks[:n_blocks]]
        meta["rank_blocks"] = self._rank_counts
        meta["rank_index"] = [
            self.shards._rank_owned(r, blocks)
            if self._kvspec.shard_axis == "page"
            else list(range(n_blocks))
            for r in range(self._kvspec.world)]
        return meta, planes

    def _export_pages(self, blocks, req, n_tokens: int) -> list:
        planes, counts = self.shards.export_rank_pages(blocks)
        # Stashed for kv_export's meta (same _slock'd call chain).
        self._rank_counts = counts
        return planes

    def _import_pages(self, blocks, planes: list,
                      meta: dict) -> None:
        self.shards.import_rank_pages(blocks, planes, meta)
