"""Host-side paged KV-cache management: block allocator + prefix tree.

The device keeps one flat ``[num_blocks, block_size, heads, d_head]``
KV pool (kvcache/paged.py); everything about WHO owns WHICH pages is
host-side python in this module, jax-free by design so the scheduler
plane can import it in any process:

  * ``KVBlockAllocator`` — fixed-size blocks on an explicit free list
    with per-block refcounts and OWNER-TAGGED accounting: every
    ``acquire``/``fork`` names its owner (a request id, or the prefix
    cache), every ``release`` must come from an owner that actually
    holds the ref, and ``leaked()``/``assert_clean()`` make "zero
    leaked KV blocks after every test" an assertable teardown contract
    instead of a hope (the vLLM block-manager discipline, with the
    leak ledger made first-class).
  * ``KVLease`` — one request's block table. It lives ON the
    ``GenerateRequest`` (``req.kv_lease``) and therefore rides the
    supervisor's seize→requeue path through the AdmissionQueue: a replica kill
    mid-decode re-attaches these pages instead of re-decoding from the
    prompt. Release is idempotent and funnelled through one choke
    point (``GenerateRequest.finish`` calls ``on_request_settled``),
    so every settle path — retire, fail, shed, server stop — returns
    the pages exactly once.
  * ``PrefixTree`` — refcounted prefix sharing keyed on chained
    token-id hashes at BLOCK granularity (PagedAttention's prefix
    reuse): a finished request's full prompt blocks are inserted under
    the cache's own owner tag; a later request with the same prefix
    forks them (refcount++) and skips that much prefill. Only FULL
    blocks are ever shared and a request's appends always land in its
    own freshly-acquired blocks (positions ≥ the block-aligned cached
    prefix), so shared pages are immutable by construction — no
    copy-on-write machinery is needed. Matches are capped at
    ``len(prompt) - 1`` tokens: the last prompt token always
    recomputes, because its forward pass is what EMITS the first
    decode token (logits are not cached, KV is).

Thread-safety: the allocator and tree each hold one lock. Leases are
released from batcher, supervisor and HTTP-handler threads; the
``match → fork`` window is closed by doing both under the tree lock
(``match_and_fork``) so eviction can never free a block between the
lookup and the ref.
"""

from __future__ import annotations

import hashlib
import heapq
import logging
import threading
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

log = logging.getLogger(__name__)

#: Owner tag for refs held by the prefix cache itself (exempt from
#: leak accounting: cached blocks are retained capacity, not a leak).
CACHE_OWNER = "__prefix_cache__"


class KVCacheOOM(Exception):
    """Not enough free KV blocks. Admission-control signal, not a
    replica failure: the scheduler sheds the request with a 503-shaped
    error (server maps ``KV_OOM_ERROR``) instead of crashing the loop."""

    def __init__(self, need: int, free: int):
        super().__init__(
            f"kv cache exhausted: need {need} block(s), {free} free")
        self.need = need
        self.free = free


class KVBlockAllocator:
    """Fixed-size KV blocks with refcounts and owner-tagged leak
    accounting. ``acquire`` hands out exclusively-owned blocks
    (ref=1); ``fork`` adds a ref to existing blocks (prefix sharing);
    ``release`` drops the caller's refs and returns fully-released
    blocks to the free list."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need num_blocks >= 1 and block_size >= 1, got "
                f"{num_blocks}/{block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._lock = threading.Lock()
        # Stack of free block ids; popping from the end gives LIFO
        # reuse (warm pages, and deterministic ids for tests).
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._ref = [0] * self.num_blocks
        self._owners: Dict[str, Counter] = {}
        self.acquired_total = 0
        self.released_total = 0

    # -- core lifecycle -------------------------------------------------------

    def acquire(self, n: int, owner: str) -> List[int]:
        """n fresh exclusively-owned blocks, or KVCacheOOM (atomic:
        never a partial grant — a partial grant is a leak the caller
        has to remember to unwind mid-error-path)."""
        if n < 0:
            raise ValueError(f"acquire({n}): negative block count")
        with self._lock:
            if n > len(self._free):
                raise KVCacheOOM(n, len(self._free))
            blocks = [self._free.pop() for _ in range(n)]
            for b in blocks:
                self._ref[b] = 1
            if blocks:
                self._owners.setdefault(owner, Counter()).update(blocks)
                self.acquired_total += n
            return blocks

    def fork(self, blocks: Sequence[int], owner: str) -> None:
        """Add one ref per block for `owner` — the prefix-sharing ref.
        Every block must already be live (ref > 0): forking a freed
        block is a use-after-free and raises."""
        with self._lock:
            for b in blocks:
                if not 0 <= b < self.num_blocks or self._ref[b] <= 0:
                    raise ValueError(
                        f"fork of non-live block {b} (owner {owner!r})")
            for b in blocks:
                self._ref[b] += 1
            if blocks:
                self._owners.setdefault(owner, Counter()).update(blocks)
                self.acquired_total += len(blocks)

    def release(self, blocks: Sequence[int], owner: str) -> int:
        """Drop `owner`'s ref on each block; returns how many blocks
        actually went back to the free list (ref hit 0). Releasing a
        ref the owner does not hold raises — that is the double-free
        the leak ledger exists to catch."""
        freed = 0
        with self._lock:
            held = self._owners.get(owner)
            for b in blocks:
                if held is None or held[b] <= 0:
                    raise ValueError(
                        f"release of block {b} not held by {owner!r}")
                held[b] -= 1
                if held[b] <= 0:
                    del held[b]
                self._ref[b] -= 1
                self.released_total += 1
                if self._ref[b] == 0:
                    self._free.append(b)
                    freed += 1
            if held is not None and not held:
                del self._owners[owner]
        return freed

    # -- accounting -----------------------------------------------------------

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref[block]

    def stats(self) -> Dict[str, int]:
        """used/free/shared block counts for the
        ``serving_kv_blocks{state=}`` gauge (shared = ref > 1)."""
        with self._lock:
            used = self.num_blocks - len(self._free)
            shared = sum(1 for r in self._ref if r > 1)
            return {"used": used, "free": len(self._free),
                    "shared": shared}

    def leaked(self, ignore: Sequence[str] = (CACHE_OWNER,)
               ) -> Dict[str, List[int]]:
        """Blocks still held per owner, excluding `ignore` (the prefix
        cache's refs are retained capacity, not a leak). Empty means
        every request-owned ref was returned."""
        with self._lock:
            return {o: sorted(c.elements())
                    for o, c in self._owners.items()
                    if o not in ignore and c}

    def assert_clean(self, ignore: Sequence[str] = (CACHE_OWNER,)) -> None:
        """Teardown contract: zero leaked KV blocks (tier-1 serving and
        chaos tests call this after every run)."""
        leaks = self.leaked(ignore)
        if leaks:
            raise AssertionError(f"leaked KV blocks: {leaks}")


class KVLease:
    """One request's KV-page ownership: the ordered block table plus
    the immutable facts a re-attach rebuilds decode cursors from (the
    prompt itself and the block-aligned cached-prefix length). Mutable
    per-step cursors (ctx, prefill position, last emitted token) live
    in the EXECUTOR's slot state, not here: on seize→requeue→re-attach
    they are rewound from ``req.tokens`` — the request's settled tokens
    are the durable truth, so a kill between dispatch and settle can
    never leave the lease ahead of (or behind) what the client saw."""

    __slots__ = ("allocator", "exec_id", "owner", "blocks", "prompt",
                 "cached_tokens", "cached_by_tier", "_released",
                 "_in_transit", "_lock")

    def __init__(self, allocator: KVBlockAllocator, exec_id: str,
                 owner: str, blocks: List[int],
                 prompt: Tuple[int, ...], cached_tokens: int,
                 cached_by_tier: Optional[Dict[str, int]] = None):
        self.allocator = allocator
        self.exec_id = exec_id
        self.owner = owner
        self.blocks = list(blocks)
        self.prompt = tuple(int(t) for t in prompt)
        self.cached_tokens = int(cached_tokens)
        # Where the cached prefix came from: the response
        # body's per-tier ``cached_tokens`` decomposition. Defaults to
        # all-HBM, the only tier that existed before tiering.
        self.cached_by_tier = dict(
            cached_by_tier if cached_by_tier is not None
            else {"hbm": self.cached_tokens})
        self._released = False
        self._in_transit = False
        self._lock = threading.Lock()

    @property
    def released(self) -> bool:
        return self._released

    @property
    def in_transit(self) -> bool:
        return self._in_transit

    @property
    def resumable(self) -> bool:
        """True while the pages are still owned — the supervisor's
        requeue keeps decoded tokens (retry resumes) iff this holds."""
        return not self._released

    # -- cross-replica hand-off (serving/disagg) ------------------------------

    def detach(self) -> bool:
        """Mark the lease as crossing a replica boundary (pages being
        exported/streamed). The pages stay owned — a failed transfer
        must be able to ``reattach()`` and resume on the source side —
        but a detached lease refuses a second concurrent hand-off and
        refuses ``kv_attach`` until the transfer plane settles it one
        way or the other (the detach/ack pairing GL016 polices).

        Returns False when the lease is ALREADY RELEASED: the settle
        choke point can fire from the HTTP handler's thread at any
        time (the same race every release path tolerates by
        idempotency), so detach-of-released is a benign lost race —
        the caller must treat the request as settled, never hand it
        off. A DOUBLE detach still raises: two concurrent hand-offs
        means two owners, an ownership bug no disposition fixes."""
        with self._lock:
            if self._released:
                return False
            if self._in_transit:
                raise ValueError(
                    f"double detach of lease (owner {self.owner!r})")
            self._in_transit = True
            return True

    def reattach(self) -> None:
        """Ack the hand-off's FAILURE path: the transfer did not go
        through, ownership returns to the source pool (the request can
        requeue and resume there). Idempotent; the success path's ack
        is ``release()`` after the destination lease is attached."""
        with self._lock:
            self._in_transit = False

    def release(self, cache_hook=None) -> bool:
        """Idempotent: returns the pages exactly once, False on the
        second and later calls (every settle path may call it).
        `cache_hook(lease)`, when given by the WINNING caller, runs
        after the claim but before the allocator release — the owner
        refs are still held, so a prefix-cache insert inside it can
        never fork a freed block, and a concurrent settle-path release
        cannot race it (it lost the claim)."""
        with self._lock:
            if self._released:
                return False
            self._released = True
        if cache_hook is not None:
            try:
                cache_hook(self)
            except Exception:
                # Caching is opportunistic; the pages return regardless.
                log.exception("kv lease %s: prefix-cache insert failed",
                              self.owner)
        self.allocator.release(self.blocks, self.owner)
        return True

    def on_request_settled(self) -> None:
        """GenerateRequest.finish() hook — the one choke point that
        guarantees pages return on EVERY settle path (fail, shed,
        server stop, handler abandon), not only the happy retire."""
        self.release()

    def __repr__(self):
        return (f"KVLease(owner={self.owner!r}, blocks={self.blocks}, "
                f"cached={self.cached_tokens}, "
                f"released={self._released})")


class _Node:
    __slots__ = ("key", "parent", "tokens", "block", "children",
                 "last_used", "origin")

    def __init__(self, key: str, parent: str, tokens: Tuple[int, ...],
                 block: int, last_used: int, origin: str = "hbm"):
        self.key = key
        self.parent = parent
        self.tokens = tokens
        self.block = block
        self.children = 0
        self.last_used = last_used
        # Where this block's bytes came from, pending first credit:
        # "hbm" for locally computed KV, "remote" for a cross-replica
        # pull — the first match consumes the tag so the
        # pull is credited to the request it actually saved prefill
        # for, and every later hit counts as the HBM hit it is.
        self.origin = origin


_ROOT = "root"


class PrefixTree:
    """Block-granular prefix cache keyed on CHAINED token-id hashes:
    node key = H(parent_key, this block's token ids). The chain makes
    a block's identity its whole prefix, so two prompts sharing only a
    middle run never alias; token ids are stored on the node and
    re-verified on match, so even a hash collision cannot serve wrong
    KV. Eviction is LRU over LEAF nodes only (an interior block must
    outlive chains extending through it)."""

    def __init__(self, allocator: KVBlockAllocator):
        self.allocator = allocator
        self.block_size = allocator.block_size
        self._lock = threading.Lock()
        self._nodes: Dict[str, _Node] = {}
        self._clock = 0
        # Token-denominated hit accounting for the scrape-time
        # serving_kv_prefix_hit_frac gauge — split by WHERE the hit's
        # bytes came from: plain HBM residency, a host-tier
        # restore, or a cross-replica pull. ``hit_tokens`` (the sum)
        # keeps its historical meaning for existing callers.
        self.hit_tokens_by_tier: Dict[str, int] = {
            "hbm": 0, "host": 0, "remote": 0}
        self.lookup_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        # Evict-to-tier seam: when set, ``evict`` offers
        # each victim's (parent_key, tokens, key, block) here BEFORE
        # releasing the cache ref, still under the tree lock — the
        # lock is what resolves the spill-vs-match race (a concurrent
        # match_and_fork either sees the node and forks it live, or
        # runs after the spill completed and takes the restore path;
        # never a freed-block fork).
        self.spill_hook = None

    @property
    def hit_tokens(self) -> int:
        return sum(self.hit_tokens_by_tier.values())

    @staticmethod
    def _key(parent: str, tokens: Tuple[int, ...]) -> str:
        h = hashlib.sha1(
            f"{parent}|{','.join(map(str, tokens))}".encode())
        return h.hexdigest()

    def __len__(self) -> int:
        with self._lock:
            return len(self._nodes)

    def match_and_fork(self, tokens: Sequence[int], owner: str,
                       by_tier: Optional[Dict[str, int]] = None
                       ) -> Tuple[List[int], int]:
        """Longest cached full-block prefix of `tokens`, capped at
        ``len(tokens) - 1`` (the last prompt token always recomputes —
        it emits the first decode token). The matched blocks are
        forked to `owner` UNDER THE TREE LOCK, so eviction can never
        recycle them between lookup and ref. Returns (blocks,
        cached_token_count); when `by_tier` is given, per-tier hit
        token counts are added into it (remote-pulled blocks credit
        "remote" on their first serve, "hbm" after)."""
        bs = self.block_size
        with self._lock:
            self.lookup_tokens += len(tokens)
            limit = max(0, (len(tokens) - 1) // bs)
            node_key = _ROOT
            blocks: List[int] = []
            matched: List[_Node] = []
            for i in range(limit):
                chunk = tuple(int(t)
                              for t in tokens[i * bs:(i + 1) * bs])
                key = self._key(node_key, chunk)
                node = self._nodes.get(key)
                if node is None or node.tokens != chunk:
                    break
                self._clock += 1
                node.last_used = self._clock
                blocks.append(node.block)
                matched.append(node)
                node_key = key
            if blocks:
                self.allocator.fork(blocks, owner)
                for node in matched:
                    self.hit_tokens_by_tier[node.origin] += bs
                    if by_tier is not None:
                        by_tier[node.origin] = (
                            by_tier.get(node.origin, 0) + bs)
                    node.origin = "hbm"
            return blocks, len(blocks) * bs

    def insert(self, tokens: Sequence[int], blocks: Sequence[int],
               origin: str = "hbm") -> int:
        """Cache every full block of `tokens` (block i must be
        ``blocks[i]``). The TREE takes its own ref on each newly
        cached block; already-cached chunks keep their original block
        (first insert wins — both hold identical KV by construction).
        ``origin`` tags newly created nodes ("remote" for a
        cross-replica pull, so their first serve is credited to the
        pull that fetched them). Returns the number of blocks newly
        cached."""
        bs = self.block_size
        added = 0
        with self._lock:
            node_key = _ROOT
            for i in range(len(tokens) // bs):
                chunk = tuple(int(t)
                              for t in tokens[i * bs:(i + 1) * bs])
                key = self._key(node_key, chunk)
                node = self._nodes.get(key)
                if node is None:
                    self.allocator.fork([blocks[i]], CACHE_OWNER)
                    self._clock += 1
                    node = _Node(key, node_key, chunk, blocks[i],
                                 self._clock, origin=origin)
                    self._nodes[key] = node
                    parent = self._nodes.get(node_key)
                    if parent is not None:
                        parent.children += 1
                    self.inserted_blocks += 1
                    added += 1
                self._clock += 1
                node.last_used = self._clock
                node_key = key
        return added

    def attach_restored(self, parent_key: str, tokens: Sequence[int],
                        block: int, owner: str, tier: str = "host"
                        ) -> Tuple[int, bool]:
        """Publish ONE restored block (host-tier or remote-pulled
        bytes, already written into `block`) as the cache node for
        `tokens` under `parent_key`, and fork the winning block to
        `owner` — all under the tree lock. The caller must already
        hold an owner ref on `block` (its fresh acquire).

        Returns ``(block_to_use, created)``: when the chain node
        already exists (a concurrent request re-inserted the same
        chunk — first insert wins, same as ``insert``), the EXISTING
        node's block is forked instead and the caller must release its
        now-redundant copy. The hit is credited to `tier` only when
        this restore actually created the node; a lost race is the
        HBM hit it turned out to be."""
        chunk = tuple(int(t) for t in tokens)
        key = self._key(parent_key, chunk)
        with self._lock:
            self._clock += 1
            node = self._nodes.get(key)
            if node is not None and node.tokens == chunk:
                node.last_used = self._clock
                self.allocator.fork([node.block], owner)
                self.hit_tokens_by_tier[node.origin] += len(chunk)
                node.origin = "hbm"
                return node.block, False
            self.allocator.fork([block], CACHE_OWNER)
            node = _Node(key, parent_key, chunk, block, self._clock)
            self._nodes[key] = node
            parent = self._nodes.get(parent_key)
            if parent is not None:
                parent.children += 1
            self.inserted_blocks += 1
            self.hit_tokens_by_tier[tier] += len(chunk)
            return block, True

    def evict(self, want_free: int, spill: bool = True) -> int:
        """Drop LRU leaf entries until `want_free` blocks actually hit
        the free list (or no leaves remain). A victim still shared
        with a live request frees nothing — its cache entry goes, the
        pages live on with the request — so the loop keeps going until
        real capacity appears. With a ``spill_hook`` installed (and
        ``spill`` true), each victim's bytes are offered to the host
        tier BEFORE its ref is released — still under the tree lock,
        so a concurrent match can never fork the freed block (the
        spill-vs-fork contract). Spilling is opportunistic:
        a hook failure degrades to plain drop-on-evict. Returns blocks
        actually freed."""
        freed = 0
        hook = self.spill_hook if spill else None
        with self._lock:
            # One leaf scan, then an incrementally-maintained heap:
            # last_used is frozen while we hold the lock (match/insert
            # need it too), so heap order stays truthful and evicting
            # k of n blocks is O(n + k log n) — the old rescan-per-
            # victim loop was O(k*n) on the admission hot path.
            heap = [(n.last_used, n.key) for n in self._nodes.values()
                    if n.children == 0]
            heapq.heapify(heap)
            while freed < want_free and heap:
                _, key = heapq.heappop(heap)
                victim = self._nodes.pop(key)
                parent = self._nodes.get(victim.parent)
                if parent is not None:
                    parent.children -= 1
                    if parent.children == 0:
                        heapq.heappush(
                            heap, (parent.last_used, parent.key))
                if hook is not None:
                    try:
                        hook(victim.parent, victim.tokens, victim.key,
                             victim.block)
                    except Exception:
                        log.exception(
                            "prefix tree: spill hook failed for block "
                            "%d (dropping)", victim.block)
                freed += self.allocator.release([victim.block],
                                                CACHE_OWNER)
                self.evicted_blocks += 1
        return freed

    def flush(self) -> int:
        """Release every cached ref (teardown / tests) — no spill:
        flushing exists to FREE memory, parking the flushed bytes in
        host RAM would defeat it."""
        return self.evict(self.allocator.num_blocks, spill=False)

    def keys(self) -> List[str]:
        """Resident chain keys — the gossip publisher's HBM half
        (the router): membership is all the router needs, the
        chain construction already encodes each key's whole prefix."""
        with self._lock:
            return list(self._nodes)

    def hit_frac(self) -> float:
        return (self.hit_tokens / self.lookup_tokens
                if self.lookup_tokens else 0.0)
