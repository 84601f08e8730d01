"""The one traffic generator: every mix is a JSON file of parameters.

A mix (``benchmark/traffic/<name>.json``) gives:

  * ``loop``: ``"closed"``, the one loop so far: each client sends its
    next request when its previous one has answered (the load generator
    keeps each request's due time beside its send time);
  * ``clients``: the number of concurrent clients (closed loop);
  * ``prompt_len``: the distribution of a prompt's length in tokens,
    ``{"dist": "uniform" | "loguniform" | "fixed", "lo", "hi"}``, whole
    numbers, both ends included; with ``shared_prefix`` it is the length
    of the unique suffix;
  * ``shared_prefix`` (optional): ``{"count", "len"}``: every prompt
    starts with one of ``count`` prefixes of ``len`` tokens, spread evenly;
  * ``max_tokens``: the distribution of the tokens asked for;
  * ``pool``: how many (length, max_tokens) pairs make one epoch;
  * ``deadline_ms``: the deadline each request carries.

Every seed gets the same set of sizes in another order: the pairs sit at
evenly spaced quantiles of the two distributions, paired by a fixed
permutation, and each epoch of ``pool`` requests is a permutation of them
drawn from the seed. The tokens themselves are drawn from the seed and the
request's index, so no two requests share a prompt except through a
declared shared prefix.

How a prompt is sent is the configuration's choice (``serving.prompt``):
``"tokens"`` sends ``prompt_tokens`` ids in ``[0, vocab)``; ``"text"``
sends a unique ``prompt`` string (the row plane encodes strings itself).

Imports numpy only: the load generator's child process uses it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

#: Salts that keep the seed's streams apart.
_ORDER, _TOKENS, _PREFIX = 1, 2, 3


def quantile(dist: dict, u: np.ndarray) -> np.ndarray:
    """Whole numbers at quantiles ``u`` in (0, 1) of ``dist``."""
    kind = dist["dist"]
    lo, hi = int(dist["lo"]), int(dist.get("hi", dist["lo"]))
    if kind == "fixed" or lo == hi:
        return np.full(u.shape, lo, np.int64)
    if kind == "uniform":
        v = lo + np.floor(u * (hi - lo + 1))
    elif kind == "loguniform":
        v = np.floor(np.exp(math.log(lo)
                            + u * (math.log(hi + 1) - math.log(lo))))
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(v, lo, hi).astype(np.int64)


@dataclass
class Request:
    prompt_len: int          # tokens of the whole prompt (0 for text)
    prefix: int              # shared prefix id, -1 for none
    max_tokens: int


class Traffic:
    """Request ``i`` of a run with ``seed``: its sizes, prompt and body."""

    def __init__(self, mix: dict, serving: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.prompt_kind = serving.get("prompt", "tokens")
        self.vocab = int(serving.get("vocab", 0))
        self.clients = int(mix["clients"])
        self.deadline_ms = float(mix.get("deadline_ms", 600000))
        n = int(mix.get("pool", 4096))
        u = (np.arange(n) + 0.5) / n
        shared = mix.get("shared_prefix")
        self.prefix_len = int(shared["len"]) if shared else 0
        self.prefix_count = int(shared["count"]) if shared else 0
        if self.prompt_kind == "tokens":
            suffix = quantile(mix["prompt_len"], u)
        else:
            suffix = np.zeros(n, np.int64)
        fixed = np.random.default_rng(0)
        max_tokens = quantile(mix["max_tokens"], u)[fixed.permutation(n)]
        prefix = (np.arange(n) % self.prefix_count)[fixed.permutation(n)] \
            if shared else np.full(n, -1)
        self._suffix, self._max, self._prefix = suffix, max_tokens, prefix
        self._n = n
        self._orders: dict = {}
        self._prefixes: dict = {}

    def _order(self, epoch: int) -> np.ndarray:
        got = self._orders.get(epoch)
        if got is None:
            got = np.random.default_rng(
                [self.seed, _ORDER, epoch]).permutation(self._n)
            self._orders[epoch] = got
        return got

    def request(self, i: int) -> Request:
        j = int(self._order(i // self._n)[i % self._n])
        pre = int(self._prefix[j])
        plen = int(self._suffix[j]) + (self.prefix_len if pre >= 0 else 0)
        return Request(plen, pre, int(self._max[j]))

    def prefix_tokens(self, k: int) -> np.ndarray:
        got = self._prefixes.get(k)
        if got is None:
            got = np.random.default_rng([self.seed, _PREFIX, k]).integers(
                0, self.vocab, self.prefix_len, dtype=np.int64)
            self._prefixes[k] = got
        return got

    def prompt(self, i: int):
        """Request ``i``'s prompt: a list of token ids, or a string."""
        r = self.request(i)
        if self.prompt_kind == "text":
            return f"bench-{self.seed}-{i}"
        n = r.prompt_len - (self.prefix_len if r.prefix >= 0 else 0)
        own = np.random.default_rng([self.seed, _TOKENS, i]).integers(
            0, self.vocab, n, dtype=np.int64)
        if r.prefix >= 0:
            own = np.concatenate([self.prefix_tokens(r.prefix), own])
        return [int(t) for t in own]

    def body(self, i: int) -> dict:
        r = self.request(i)
        p = self.prompt(i)
        key = "prompt" if isinstance(p, str) else "prompt_tokens"
        return {key: p, "max_tokens": r.max_tokens,
                "deadline_ms": self.deadline_ms}


def pool_sizes(mix: dict, serving: dict) -> List[tuple]:
    """The (prompt_len, max_tokens) pairs of one epoch, sorted: the same
    for every seed."""
    t = Traffic(mix, serving, 0)
    return sorted(zip(t._suffix.tolist(), t._max.tolist()))

