"""Prefix-aware front-end router: route to the KV, and
when the KV is elsewhere, move the KV — never re-prefill shared bytes.

``PrefixRouter`` sits in front of N replicas (each a ``RouterReplica``:
an admission queue + a KV executor + its gossip publisher). For each
incoming request it:

  1. computes the request's own chain keys (gossip.chain_keys — the
     same chained sha1 the PrefixTree uses, so scoring is
     content-addressed end to end);
  2. scores every replica by its longest CONTIGUOUS cached prefix in
     the age-filtered gossip snapshot (contiguity matters: the restore
     and pull paths both walk the chain from the matched depth, an
     island past a gap is unreachable);
  3. routes to the owning replica (ties broken by load), UNLESS the
     owner is overloaded past ``max_load_skew`` queued requests
     relative to the least-loaded replica — then the request goes to
     the least-loaded replica and the router first PULLS the prefix
     blocks from the owner over ``KVPageStream`` into the target pool,
     so prefill covers only the uncached suffix.

The pull is best-effort by design: any stream failure (cut
mid-transfer, nack, refused hello) falls back to local prefill of the
whole prompt — the deterministic recurrence makes the resulting stream
identical either way, only slower. The receiving side re-verifies the
claimed chain keys against the shipped token ids
(``verify_block_tokens``) before publishing anything into its tree:
a lying or stale sender degrades to re-prefill, never to wrong KV.
``KVSpec`` hello-checks both ends of every stream (model identity,
layout, codec), and sharded pools inherit the per-rank ``rank_view``
sub-stream transfer from the context-parallel stream plane untouched.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from types import SimpleNamespace
from typing import Dict, List, Optional

from ... import faults
from ..disagg.stream import (KVPageStream, KVPageStreamServer,
                             KVStreamError)
from ..kvcache.allocator import _ROOT as _TREE_ROOT
from ..kvcache.tiering import verify_block_tokens
from .gossip import GossipBoard, ReplicaGossip, chain_keys

log = logging.getLogger(__name__)

__all__ = ["PrefixRouter", "RouterReplica"]


class RouterReplica:
    """One routable serving replica: name, admission queue, KV
    executor, and (lazily, when pulls are enabled) a
    ``KVPageStreamServer`` importing pulled prefixes into the
    executor's pool. The batcher driving the queue is owned by the
    caller — the router only submits and moves KV."""

    def __init__(self, name: str, queue, executor,
                 registry=None):
        self.name = name
        self.queue = queue
        self.executor = executor
        self.registry = registry
        self.gossip: Optional[ReplicaGossip] = None  # set by router
        self._server: Optional[KVPageStreamServer] = None
        self._streams: Dict[str, KVPageStream] = {}
        self._lock = threading.Lock()

    def load(self) -> int:
        return int(self.queue.depth() + self.queue.inflight())

    # -- pull plumbing --------------------------------------------------------

    def pull_addr(self):
        """This replica's import endpoint, starting the server on
        first use (hello-checked by its executor's KVSpec)."""
        with self._lock:
            if self._server is None:
                self._server = KVPageStreamServer(
                    self.executor.kv_spec, self._pull_import)
            return self._server.addr

    def stream_to(self, dst: "RouterReplica") -> KVPageStream:
        """Source-side stream client toward `dst`, cached per pair —
        the hello/spec check runs once per (src, dst) connection."""
        with self._lock:
            stream = self._streams.get(dst.name)
        if stream is None:
            stream = KVPageStream(self.executor.kv_spec,
                                  dst.pull_addr())
            with self._lock:
                self._streams[dst.name] = stream
        return stream

    def drop_stream(self, dst_name: str) -> None:
        with self._lock:
            stream = self._streams.pop(dst_name, None)
        if stream is not None:
            stream.close()

    def _pull_import(self, meta: dict, planes: list) -> dict:
        """Import one pulled prefix: re-derive every claimed chain key
        from the shipped token ids (the GL019 chained-hash
        re-verification — a collision or a lying sender degrades to
        re-prefill), write the planes into freshly acquired blocks,
        and publish them tagged ``origin="remote"`` so their first
        serve is credited to the pull. The temp owner's refs release
        in the finally — on ANY failure the ledger stays clean and
        the nack falls back to local prefill."""
        # ``kind`` is the stream protocol's field ("pages" on the
        # wire); the pull marker rides its own key.
        if not meta.get("prefix_pull"):
            raise ValueError("pull endpoint got a non-pull transfer")
        ex = self.executor
        bs = ex.block_size
        tokens = [int(t) for t in meta["prompt_tokens"]]
        keys = list(meta["keys"])
        n_blocks = int(meta["n_blocks"])
        if n_blocks != len(keys) or n_blocks * bs != len(tokens):
            raise ValueError(
                f"pull geometry mismatch: {n_blocks} block(s), "
                f"{len(keys)} key(s), {len(tokens)} token(s)")
        parent = _TREE_ROOT
        for i, key in enumerate(keys):
            chunk = tokens[i * bs:(i + 1) * bs]
            if not verify_block_tokens(parent, chunk, key):
                raise ValueError(
                    f"pulled prefix fails chained-hash "
                    f"re-verification at block {i}")
            parent = key
        owner = f"__pull_import__{meta.get('xfer', 'x')}"
        fresh = ex._acquire_with_evict(n_blocks, owner)
        try:
            ex._import_pages(fresh, planes, dict(meta))
            ex.prefix.insert(tokens, fresh, origin="remote")
        finally:
            # The tree holds CACHE_OWNER refs on whatever it kept
            # (first insert wins); the temp owner always lets go.
            ex.allocator.release(fresh, owner)
        return {"blocks": n_blocks}

    def close(self) -> None:
        with self._lock:
            streams = list(self._streams.values())
            self._streams.clear()
            server, self._server = self._server, None
        for s in streams:
            s.close()
        if server is not None:
            server.close()


class PrefixRouter:
    """The scoring + placement front end over ``RouterReplica``s.

    ``policy="prefix"`` is the routed arm; ``policy="round_robin"``
    is the baseline arm the bench compares against (same machinery,
    no scoring, no pulls)."""

    def __init__(self, replicas: List[RouterReplica],
                 policy: str = "prefix", max_age_s: float = 5.0,
                 cadence_s: float = 0.05, pull: bool = True,
                 pull_min_blocks: int = 1, max_load_skew: int = 8,
                 registry=None, tracer=None):
        if policy not in ("prefix", "round_robin"):
            raise ValueError(
                f"policy must be prefix|round_robin, got {policy!r}")
        if not replicas:
            raise ValueError("router needs at least one replica")
        sizes = {r.executor.block_size for r in replicas}
        if len(sizes) != 1:
            raise ValueError(
                f"replicas disagree on block_size: {sorted(sizes)} — "
                f"chain keys would never match across them")
        self.replicas = list(replicas)
        self.block_size = sizes.pop()
        self.policy = policy
        self.max_age_s = float(max_age_s)
        self.pull = bool(pull)
        self.pull_min_blocks = int(pull_min_blocks)
        self.max_load_skew = int(max_load_skew)
        self.registry = registry
        self.tracer = tracer
        self.board = GossipBoard()
        for r in self.replicas:
            r.gossip = ReplicaGossip(self.board, r.name, [r.executor],
                                     cadence_s=cadence_s)
        self._rr = 0
        self._lock = threading.Lock()

    # -- bookkeeping ----------------------------------------------------------

    def _count(self, name: str, labels=None, by: float = 1.0,
               help: str = "") -> None:
        if self.registry is not None:
            self.registry.counter_inc(name, labels, by=by, help=help)

    def _event(self, name: str, req, attrs: dict) -> None:
        if self.tracer is not None:
            self.tracer.event(
                name, request_id=getattr(req, "request_id", None),
                parent_id=getattr(req, "trace_parent", None),
                attrs=attrs)

    # -- scoring --------------------------------------------------------------

    def scores(self, tokens) -> Dict[str, int]:
        """Cached-prefix tokens per replica: the longest contiguous
        run of the request's chain present in each (age-filtered)
        gossip map."""
        keys = chain_keys(tokens, self.block_size)
        view = self.board.snapshot(max_age_s=self.max_age_s)
        out: Dict[str, int] = {}
        for r in self.replicas:
            keymap = view.get(r.name, {})
            depth = 0
            for key in keys:
                if key not in keymap:
                    break
                depth += 1
            out[r.name] = depth * self.block_size
        return out

    def route(self, req) -> RouterReplica:
        """Pick the replica (and run the affinity-miss pull when one
        applies). Does NOT submit — ``submit()`` wraps this."""
        for r in self.replicas:
            r.gossip.maybe_publish()
        if self.policy == "round_robin":
            with self._lock:
                chosen = self.replicas[self._rr % len(self.replicas)]
                self._rr += 1
            self._count("serving_router_routed_total",
                        {"outcome": "rr"},
                        help="router placements by outcome")
            return chosen
        tokens = getattr(req, "prompt_tokens", None) or []
        scored = self.scores(tokens)
        best = max(self.replicas, key=lambda r: (scored[r.name],
                                                 -r.load()))
        # Rotate load ties: min() alone would pin every cold request
        # to the first replica while loads are equal (fast replicas
        # drain to zero between arrivals), starving the rest of the
        # fleet of any prefix to own.
        with self._lock:
            start = self._rr % len(self.replicas)
            self._rr += 1
        order = self.replicas[start:] + self.replicas[:start]
        least = min(order, key=lambda r: r.load())
        outcome, chosen = "cold", least
        if scored[best.name] > 0:
            if best.load() - least.load() <= self.max_load_skew:
                outcome, chosen = "affinity", best
            else:
                # The owner is swamped: place by load and move the
                # prefix to the chosen replica instead of the request
                # to the hot one.
                outcome, chosen = "load", least
                gain = scored[best.name] - scored[chosen.name]
                if (self.pull and chosen is not best
                        and gain >= self.pull_min_blocks
                        * self.block_size):
                    self._pull(best, chosen, tokens, req)
        self._count("serving_router_routed_total",
                    {"outcome": outcome},
                    help="router placements by outcome")
        self._event("router.route", req,
                    {"replica": chosen.name, "outcome": outcome,
                     "score_tokens": scored[chosen.name],
                     "best": best.name,
                     "best_tokens": scored[best.name]})
        return chosen

    def submit(self, req) -> RouterReplica:
        chosen = self.route(req)
        chosen.queue.submit(req)
        return chosen

    # -- the affinity-miss pull ------------------------------------------------

    def _pull(self, src: RouterReplica, dst: RouterReplica, tokens,
              req) -> int:
        """Stream `src`'s cached prefix of `tokens` into `dst`'s pool.
        Best-effort: returns pulled block count, 0 on any failure
        (local prefill covers it). Source refs are forked under a temp
        owner and ALWAYS released — a cut transfer leaves both
        ledgers clean."""
        owner = f"__pull__{uuid.uuid4().hex[:8]}"
        ex = src.executor
        t0 = time.monotonic()
        try:
            faults.fire("router.pull",
                        attrs={"src": src.name, "dst": dst.name})
            blocks, cached = ex.kv_match_prefix(tokens, owner)
        except Exception:
            log.warning("router: pull source match failed "
                        "(%s -> %s), prefilling locally",
                        src.name, dst.name, exc_info=True)
            self._count("serving_router_pull_failed_total",
                        help="cross-replica pulls that fell back to "
                             "local prefill")
            return 0
        if not blocks:
            self.allocator_release(ex, blocks, owner)
            return 0
        try:
            shim = SimpleNamespace(
                request_id=owner,
                prompt_tokens=[int(t) for t in tokens[:cached]],
                tokens=[])
            planes = ex._export_pages(blocks, shim, cached)
            meta = {"req": owner, "prefix_pull": True,
                    "xfer": owner.rsplit("__", 1)[-1],
                    "tokens": cached, "n_blocks": len(blocks),
                    "prompt_tokens": [int(t)
                                      for t in tokens[:cached]],
                    "settled": [], "max_tokens": 0,
                    "keys": chain_keys(tokens[:cached + 1],
                                       self.block_size)[:len(blocks)]}
            stream = src.stream_to(dst)
            ack = stream.send_pages(meta, planes)
            dt = time.monotonic() - t0
            nbytes = sum(int(arr.nbytes) for pair in planes
                         for arr in pair)
            self._count("serving_router_pulled_blocks_total",
                        by=float(len(blocks)),
                        help="prefix blocks moved by cross-replica "
                             "pulls")
            self._count("serving_router_pull_bytes_total",
                        by=float(nbytes),
                        help="pool bytes moved by cross-replica pulls")
            self._count("serving_router_pull_seconds_total", by=dt,
                        help="wall seconds spent in cross-replica "
                             "pulls")
            self._event("router.pull", req,
                        {"src": src.name, "dst": dst.name,
                         "blocks": len(blocks), "bytes": nbytes,
                         "outcome": "ok",
                         "ack_blocks": ack.get("blocks")})
            return len(blocks)
        except (KVStreamError, OSError, ValueError) as e:
            # Torn stream / nack / refused hello: drop the (possibly
            # desynced) stream, fall back to prefill. The request is
            # unharmed — it has not even been enqueued yet.
            src.drop_stream(dst.name)
            log.warning("router: pull %s -> %s failed (%s), "
                        "prefilling locally", src.name, dst.name, e)
            self._count("serving_router_pull_failed_total",
                        help="cross-replica pulls that fell back to "
                             "local prefill")
            self._event("router.pull", req,
                        {"src": src.name, "dst": dst.name,
                         "outcome": "failed",
                         "error": str(e)[:120]})
            return 0
        finally:
            ex.allocator.release(blocks, owner)

    @staticmethod
    def allocator_release(ex, blocks, owner) -> None:
        """Release-if-held: a zero-block match never registered the
        owner, releasing nothing must not raise."""
        if blocks:
            ex.allocator.release(blocks, owner)

    def close(self) -> None:
        for r in self.replicas:
            r.close()
