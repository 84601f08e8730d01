"""Host-RAM KV tier under the paged allocator.

The HBM pool is the only place a block can be ATTENDED; this module
adds the place a cold block can be PARKED. When the PrefixTree's LRU
leaf scan would drop a cached block on the floor, the executor's spill
hook hands its bytes here instead (evict-to-tier), and a later prefix
hit restores them into a freshly acquired HBM block before prefill of
only the uncached suffix. Three properties make this safe enough to
sit under the allocator:

  * **Byte-exact by construction.** Spill/restore moves the pool's
    already-quantized int8 codes + per-block scales verbatim — the
    same representation ``kv_export`` ships across replicas — so a
    restored block is bit-identical to the block that was evicted.
    There is no re-quantization step to drift through.
  * **Chained-hash re-verification at every restore.** A tier entry
    is content-addressed by the PrefixTree's chained key (node key =
    H(parent_key, block token ids)), and ``verify_block_tokens`` —
    the one blessed helper, see GL019 — re-derives that key from the
    tokens the REQUEST brought before any restored bytes are
    published into the tree. A corrupted, recycled or colliding host
    entry therefore degrades to re-prefill; it can never serve wrong
    KV.
  * **The same leak discipline as the allocator.** Restores pin their
    entry under an owner-tagged tier lease (``checkout``/``checkin``)
    recorded in a ledger with ``leaked()``/``assert_clean()``
    mirroring ``KVBlockAllocator``'s — "both ledgers clean" is one
    teardown assertion away in every test.

Capacity is a HARD host-bytes budget: a spill that does not fit after
LRU-evicting unpinned tier entries falls back to today's behavior
(drop on evict, counted), so the tier can only ever add reuse, never
unbounded host growth.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .allocator import PrefixTree

__all__ = ["HostKVTier", "ParkedKV", "TierEntry",
           "verify_block_tokens"]


def verify_block_tokens(parent_key: str, tokens: Sequence[int],
                        key: str,
                        stored_tokens: Optional[Sequence[int]] = None
                        ) -> bool:
    """THE chained-hash token re-verification (GL019's blessed helper).

    Every path that publishes foreign bytes into the prefix tree — a
    host-tier restore, a cross-replica pull import — must pass the
    claimed chain key through here before insert: the key is re-derived
    from ``parent_key`` and the token ids the REQUEST (not the claimant)
    brought, and, when the claimant also carries its own token ids
    (``stored_tokens``), those must match too. A mismatch means the
    entry is stale, corrupted, or a hash collision — all of which must
    degrade to re-prefill, never to serving someone else's KV."""
    chunk = tuple(int(t) for t in tokens)
    if PrefixTree._key(parent_key, chunk) != key:
        return False
    if stored_tokens is not None:
        if tuple(int(t) for t in stored_tokens) != chunk:
            return False
    return True


class TierEntry:
    """One spilled block: the chain identity (key/parent/tokens) plus
    the verbatim plane bytes exactly as the backend exported them."""

    __slots__ = ("key", "parent", "tokens", "planes", "nbytes",
                 "last_used", "pins")

    def __init__(self, key: str, parent: str, tokens: Tuple[int, ...],
                 planes: list, nbytes: int, last_used: int):
        self.key = key
        self.parent = parent
        self.tokens = tokens
        self.planes = planes
        self.nbytes = nbytes
        self.last_used = last_used
        self.pins = 0


def _planes_nbytes(planes: list) -> int:
    total = 0
    for pair in planes:
        for arr in pair:
            total += int(np.asarray(arr).nbytes)
    return total


class HostKVTier:
    """LRU host-RAM store of spilled prefix blocks under a hard byte
    budget, with owner-tagged restore leases and a leak ledger."""

    def __init__(self, budget_bytes: int):
        if budget_bytes < 1:
            raise ValueError(
                f"tier budget must be >= 1 byte, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._entries: Dict[str, TierEntry] = {}
        self._clock = 0
        self.bytes_used = 0
        # Lifetime counters for kv_stats()/bench decomposition.
        self.spilled_blocks = 0
        self.spilled_bytes = 0
        self.restored_blocks = 0
        self.restored_bytes = 0
        self.dropped_blocks = 0   # budget overflow → drop-on-evict
        self.evicted_blocks = 0   # tier-LRU eviction to admit a spill
        self.corrupt_blocks = 0   # failed re-verification at restore
        # owner -> Counter(entry key -> pin count): the tier lease
        # ledger, same shape as KVBlockAllocator._owners.
        self._leases: Dict[str, Counter] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- spill side (called from the PrefixTree evict hook) -------------------

    def put(self, key: str, parent: str, tokens: Sequence[int],
            planes: list) -> bool:
        """Admit one spilled block. Evicts UNPINNED tier-LRU entries to
        fit; returns False (drop-on-evict, counted) when the block
        cannot fit even then — oversized block, or every resident byte
        is pinned by in-flight restores."""
        chunk = tuple(int(t) for t in tokens)
        nbytes = _planes_nbytes(planes)
        with self._lock:
            self._clock += 1
            prev = self._entries.get(key)
            if prev is not None:
                # Re-spill of a restored-then-re-evicted block: the
                # bytes are identical by construction, just refresh.
                prev.last_used = self._clock
                return True
            if nbytes > self.budget_bytes:
                self.dropped_blocks += 1
                return False
            while self.bytes_used + nbytes > self.budget_bytes:
                victim = min(
                    (e for e in self._entries.values() if e.pins == 0),
                    key=lambda e: e.last_used, default=None)
                if victim is None:
                    self.dropped_blocks += 1
                    return False
                del self._entries[victim.key]
                self.bytes_used -= victim.nbytes
                self.evicted_blocks += 1
            self._entries[key] = TierEntry(key, parent, chunk, planes,
                                           nbytes, self._clock)
            self.bytes_used += nbytes
            self.spilled_blocks += 1
            self.spilled_bytes += nbytes
            return True

    # -- restore side ---------------------------------------------------------

    def checkout(self, key: str, owner: str) -> Optional[TierEntry]:
        """Pin `key` for a restore under an owner-tagged tier lease.
        The pin keeps the entry out of tier-LRU eviction until the
        matching ``checkin`` — the restore window's use-after-free
        guard, recorded in the leak ledger."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            entry.pins += 1
            self._clock += 1
            entry.last_used = self._clock
            self._leases.setdefault(owner, Counter())[key] += 1
            return entry

    def checkin(self, key: str, owner: str, restored: bool = False,
                corrupt: bool = False) -> None:
        """Return a checkout. ``restored`` credits the restore
        counters; ``corrupt`` additionally DROPS the entry — a block
        that failed re-verification must never be served again.
        Checking in a lease the owner does not hold raises (the
        double-free discipline, same as the allocator's)."""
        with self._lock:
            held = self._leases.get(owner)
            if held is None or held[key] <= 0:
                raise ValueError(
                    f"tier checkin of {key[:12]!r} not held by "
                    f"{owner!r}")
            held[key] -= 1
            if held[key] <= 0:
                del held[key]
            if not held:
                del self._leases[owner]
            entry = self._entries.get(key)
            if entry is None:
                return
            entry.pins -= 1
            if restored:
                self.restored_blocks += 1
                self.restored_bytes += entry.nbytes
            if corrupt:
                self.corrupt_blocks += 1
                del self._entries[key]
                self.bytes_used -= entry.nbytes

    # -- accounting -----------------------------------------------------------

    def keys(self) -> List[str]:
        """Resident entry keys — the gossip publisher's host-tier half."""
        with self._lock:
            return list(self._entries)

    def leaked(self, ignore: Sequence[str] = ()) -> Dict[str, List[str]]:
        """Tier leases still pinned per owner. Empty means every
        checkout was checked back in."""
        with self._lock:
            return {o: sorted(c.elements())
                    for o, c in self._leases.items()
                    if o not in ignore and c}

    def assert_clean(self, ignore: Sequence[str] = ()) -> None:
        """Teardown contract: zero leaked tier leases (the second
        ledger in 'both leak ledgers clean')."""
        leaks = self.leaked(ignore)
        if leaks:
            raise AssertionError(f"leaked tier leases: {leaks}")

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries),
                    "bytes_used": self.bytes_used,
                    "budget_bytes": self.budget_bytes,
                    "spilled_blocks": self.spilled_blocks,
                    "spilled_bytes": self.spilled_bytes,
                    "restored_blocks": self.restored_blocks,
                    "restored_bytes": self.restored_bytes,
                    "dropped_blocks": self.dropped_blocks,
                    "evicted_blocks": self.evicted_blocks,
                    "corrupt_blocks": self.corrupt_blocks}

    def flush(self) -> int:
        """Drop every UNPINNED entry (teardown / tests)."""
        with self._lock:
            victims = [e for e in self._entries.values()
                       if e.pins == 0]
            for e in victims:
                del self._entries[e.key]
                self.bytes_used -= e.nbytes
            return len(victims)


class ParkedKV:
    """A preempted request's KV, parked in the host tier.

    When the batcher preempts a batch-class occupant, the executor
    spills its settled KV blocks into the HostKVTier and pins each
    chain entry under an owner-tagged ``checkout`` — then rides THIS
    object on ``req.kv_lease`` through the requeue. It duck-types
    ``KVLease`` for every consumer on that path:

      * the queue's requeue trace reads ``blocks`` (here: the pinned
        chain keys, in chain order);
      * ``resumable`` tells the resume path whether the pins are still
        held;
      * ``on_request_settled()`` — the ``finish()`` choke point —
        releases the pins exactly once, so a request that dies while
        parked (deadline, drain, server stop) can never leak a tier
        lease;
      * ``release()`` is idempotent, and ``HostKVTier.checkin`` is
        safe after a ``flush`` dropped the entry (the ledger, not the
        entry, is what must balance).

    The resume path (``kv_attach`` on the SAME executor) restores the
    pinned chain via the ordinary tier-hit machinery — chained-hash
    re-verification included — then releases this object; a foreign
    executor just releases it and re-prefills (deterministic decode
    makes the streams byte-identical either way).
    """

    def __init__(self, tier: "HostKVTier", exec_id: str, owner: str,
                 keys: Sequence[str], prompt: Sequence[int],
                 cached_tokens: int,
                 cached_by_tier: Optional[Dict[str, int]] = None):
        self.tier = tier
        self.exec_id = exec_id
        self.owner = owner
        self.keys: Tuple[str, ...] = tuple(keys)
        self.prompt: Tuple[int, ...] = tuple(int(t) for t in prompt)
        self.cached_tokens = int(cached_tokens)
        self.cached_by_tier: Dict[str, int] = dict(cached_by_tier or {})
        self.in_transit = False
        self._released = False
        self._lock = threading.Lock()

    @property
    def blocks(self) -> Tuple[str, ...]:
        """Duck-typed KVLease.blocks: the parked chain keys (len() is
        what the requeue trace and response body record)."""
        return self.keys

    @property
    def released(self) -> bool:
        return self._released

    @property
    def resumable(self) -> bool:
        return not self._released

    def release(self, cache_hook=None) -> None:
        """Unpin every parked chain entry, exactly once (idempotent —
        second and later calls no-op, like KVLease.release). The
        ``cache_hook`` parameter exists only for call-shape parity;
        parked blocks are already content-addressed tier residents."""
        with self._lock:
            if self._released:
                return
            self._released = True
        for key in self.keys:
            self.tier.checkin(key, self.owner)

    def on_request_settled(self) -> None:
        """GenerateRequest.finish() hook — same contract as KVLease."""
        self.release()
