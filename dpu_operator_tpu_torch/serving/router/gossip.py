"""Prefix-key gossip: how replicas tell the router what they hold.

Each replica periodically publishes its content-addressed prefix map —
every chain key resident in its PrefixTree (tier ``hbm``) or parked in
its host tier (tier ``host``) — to a shared ``GossipBoard``. The
publish cadence rides the existing metrics/health rhythm: callers
invoke ``maybe_publish()`` from paths that already run on that clock
(the server's derived-metrics scrape, the router's route loop) and the
publisher rate-limits itself to ``cadence_s``, so gossip adds no new
threads and no new timers.

The staleness contract (docs/serving.md): the board stores each
snapshot with its publish time and the ROUTER filters at read time —
a map older than ``max_age_s`` reads as empty, i.e. as a cache miss.
Staleness is therefore a pure performance event (a wasted pull, a
missed affinity); it can never be a correctness event, because every
byte a stale map causes to move is chained-hash re-verified on the
receiving side before it is published into a tree
(``tiering.verify_block_tokens``, the GL019 discipline).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

__all__ = ["GossipBoard", "ReplicaGossip"]


class GossipBoard:
    """The cluster-shared key map: replica name → (publish time,
    {chain key → tier}). In-process stand-in for a gossip fabric —
    replicas write snapshots, the router reads a merged, age-filtered
    view. Thread-safe; snapshots are replaced whole (a reader never
    sees a half-published map)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._maps: Dict[str, tuple] = {}

    def publish(self, replica: str, keymap: Dict[str, str],
                now: Optional[float] = None) -> None:
        t = time.monotonic() if now is None else now
        with self._lock:
            self._maps[replica] = (t, dict(keymap))

    def published_at(self, replica: str) -> Optional[float]:
        with self._lock:
            entry = self._maps.get(replica)
            return entry[0] if entry else None

    def snapshot(self, max_age_s: Optional[float] = None,
                 now: Optional[float] = None
                 ) -> Dict[str, Dict[str, str]]:
        """Merged view for scoring. With ``max_age_s``, maps older
        than that read as EMPTY — the staleness contract: a lagging
        replica simply stops attracting affinity until it gossips
        again."""
        t = time.monotonic() if now is None else now
        with self._lock:
            out = {}
            for name, (published, keymap) in self._maps.items():
                if max_age_s is not None and t - published > max_age_s:
                    out[name] = {}
                else:
                    out[name] = keymap
            return out


class ReplicaGossip:
    """One replica's publisher: collects {chain key → tier} from its
    executors (PrefixTree keys as ``hbm``, host-tier keys as ``host``
    — HBM wins when a block is resident in both) and publishes to the
    board, rate-limited to ``cadence_s``."""

    def __init__(self, board: GossipBoard, name: str, executors,
                 cadence_s: float = 0.25):
        self.board = board
        self.name = name
        self.executors = list(executors)
        self.cadence_s = float(cadence_s)
        self._lock = threading.Lock()
        self._last_publish = 0.0

    def collect(self) -> Dict[str, str]:
        keymap: Dict[str, str] = {}
        for ex in self.executors:
            tier = getattr(ex, "tier", None)
            if tier is not None:
                for key in tier.keys():
                    keymap[key] = "host"
            prefix = getattr(ex, "prefix", None)
            if prefix is not None:
                for key in prefix.keys():
                    keymap[key] = "hbm"
        return keymap

    def maybe_publish(self, force: bool = False) -> bool:
        """Publish if the cadence allows (or ``force``). Returns
        whether a publish happened — the router's scoring freshness
        depends only on this being CALLED often enough, the cadence
        bounds how often it actually walks the trees."""
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_publish < self.cadence_s:
                return False
            self._last_publish = now
        self.board.publish(self.name, self.collect(), now=now)
        return True


def chain_keys(tokens, block_size: int) -> List[str]:
    """The request's own chain, one key per FULL block, capped at
    ``len(tokens) - 1`` (match_and_fork's cap: the last prompt token
    always recomputes). Key i's chain construction encodes the whole
    prefix through block i, so membership of key i in a replica's map
    implies that replica once held the entire prefix."""
    from ..kvcache.allocator import _ROOT, PrefixTree

    bs = int(block_size)
    limit = max(0, (len(tokens) - 1) // bs)
    keys: List[str] = []
    parent = _ROOT
    for i in range(limit):
        chunk = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
        parent = PrefixTree._key(parent, chunk)
        keys.append(parent)
    return keys
