"""Token-level executors over the paged KV cache.

``KVExecutorBase`` is the host plane shared by every KV replica: it
owns the block allocator + prefix tree, the per-slot decode cursors,
and the per-step PLAN — which slots prefill how many prompt tokens
this step (bounded by the Sarathi-style ``prefill_budget``), which
slots decode one token, and whether each decode input chains from the
previous step's on-device output or is host-fed (fresh attach /
resume). Backends implement exactly two hooks — ``_dispatch(plan)``
and ``_materialize(raw)`` — so the scheduler-facing contract is one
class:

  * ``PagedKVExecutor`` — the real thing: kvcache/paged.py's
    AOT-compiled fused step over device-resident KV pools, decode
    recurrence chained on device (submit returns while the step runs).
  * ``SyntheticKVExecutor`` — the jax-free double: same allocator,
    same leases, same plans, but the "device" is a deterministic token
    function with a dialable step cost (optionally on a worker thread,
    the SyntheticExecutor pipelining idiom) — the knob that makes KV
    scheduler/chaos tests immune to CI-box noise.

Scheduling properties the plan enforces (the chunked-prefill
contract):

  * decode slots ALWAYS get their one token — the prefill budget only
    rations prefill, so a long prompt can never stall decode p99;
  * prefill is chunked to ``prefill_chunk`` tokens per slot and
    ``prefill_budget`` per step across slots, admitted round-robin
    from a rotating start so one long prompt cannot starve another;
  * every request's worst-case pages (``ceil((prompt + max_tokens) /
    block_size)``) are reserved at attach — KV OOM is an ADMISSION
    decision (shed with 503), never a mid-decode failure.

Crash-retry (the paged-KV headline): cursors are rebuilt from
``req.tokens`` at (re-)attach — see KVLease — so a seized request
re-attaches its pages and resumes from its last settled token. A
lease from a DIFFERENT executor is released and the request re-prefills
from the prompt (possibly through this replica's own prefix cache).

Thread-safety: all slot-state mutation happens under ``_slock`` with a
generation check, so a batcher thread abandoned mid-dispatch by a
supervisor seize can never advance cursors of a restarted session
(its stale ``gen`` turns the submit into a no-op).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import faults
from ..executor import Executor, _GuardedWorker, _Pending, _run_timed
# NO_TOKEN re-exported here for back-compat: the sentinel and the
# emit-masking idiom live in serving/spec.py (a cleanup) so the
# one-token and speculative collect paths share one definition.
from ..spec import (NO_TOKEN, SpecConfig, accept_tree, clamp_spec_k,
                    propose_full, synthetic_next_token)
from ..stepclock import CudaStepClock, StepClock
from .allocator import (_ROOT as _TREE_ROOT, KVBlockAllocator,
                        KVCacheOOM, KVLease, PrefixTree)
from .tiering import HostKVTier, ParkedKV, verify_block_tokens

log = logging.getLogger(__name__)


class _SlotState:
    __slots__ = ("req_id", "lease", "ctx", "prefill_pos", "last_token",
                 "chain_device", "pending_emit", "confirmed",
                 "max_total", "spec_ahead", "spec_epoch", "spec_ewma",
                 "repair")

    def __init__(self, req_id: str, lease: KVLease, ctx: int,
                 prefill_pos: int, last_token: Optional[int],
                 max_total: int = 0):
        self.req_id = req_id
        self.lease = lease
        self.ctx = int(ctx)
        self.prefill_pos = int(prefill_pos)
        self.last_token = last_token
        self.chain_device = False
        self.pending_emit = False
        # Pipelined speculation: the draft's own prediction
        # of the in-flight verify window's BONUS token — the seed for
        # planning window w+1 before window w collects. The true bonus
        # chains on DEVICE (the window's base row is use_host=False);
        # this host-side prediction only feeds the draft.
        self.spec_ahead: Optional[int] = None
        # Plan-ahead validity epoch: bumped by every rollback at
        # collect, recorded into each spec plan — a collected plan
        # whose epoch is stale was drafted from a provisional ctx a
        # rollback revoked, and settles NOTHING (a pure re-plan).
        self.spec_epoch = 0
        # Per-slot accept-rate EWMA, the adaptive draft-depth dial
        # (SpecConfig.k_for/width_for). Starts optimistic: a fresh
        # slot drafts at full depth until the target disagrees.
        self.spec_ewma = 1.0
        # Tree speculation: accepted tokens whose KV row was NOT
        # appended (a sibling path won — the trunk's append at that
        # position holds the rejected trunk token). The next window
        # re-feeds them as leading repair rows, closing the hole
        # before any later query can attend it.
        self.repair: List[int] = []
        # Positions whose KV writes a COLLECTED step has confirmed on
        # device. ctx advances at plan time — one step ahead in the
        # pipelined loop, and a full speculative window ahead in
        # verify steps — so anything derived from ctx alone (the
        # prefix-cache insert) would cover in-flight writes that a
        # failing step never lands, or rejected draft positions a
        # collect rolls back. Attach-time positions are genuinely
        # written: prefix-cache hits by the cache contract, re-attach
        # cursors by the settled tokens that imply their steps ran.
        self.confirmed = int(ctx)
        # prompt + max_tokens: the request's total position budget,
        # needed at plan time to clamp speculative proposals inside
        # the worst-case pages reserved at admission (spec.clamp_spec_k).
        self.max_total = int(max_total)


class _StepPlan:
    __slots__ = ("gen", "step_no", "host_tok", "use_host", "ctx",
                 "n_new", "tables", "emit", "owners", "spec_k",
                 "stale", "spec_off", "spec_w", "spec_epoch", "n_app",
                 "roff", "plim", "win")

    def __init__(self, gen, step_no, host_tok, use_host, ctx, n_new,
                 tables, emit, owners=None, spec_k=None, stale=False,
                 spec_off=None, spec_w=None, spec_epoch=None,
                 n_app=None, roff=None, plim=None, win=None):
        self.gen = gen
        self.step_no = step_no
        self.host_tok = host_tok
        self.use_host = use_host
        self.ctx = ctx
        self.n_new = n_new
        self.tables = tables
        self.emit = emit
        # Per-slot request id at PLAN time: collect() must attribute
        # an emit to the state that planned it — a retire + fresh
        # admit can rebind the slot between submit and collect.
        self.owners = owners
        # Speculative plans only: per-slot drafted-token count (>= 0
        # marks a verify slot; the drafts themselves are
        # host_tok[s, spec_off[s]+1 : spec_off[s]+1+spec_k[s]], so
        # collect can re-derive the acceptance comparison from the
        # plan alone).
        self.spec_k = spec_k
        self.stale = stale
        # Tree/pipelined speculation. Window row layout per
        # verify slot: [repair rows (spec_off), base row, trunk rows
        # (spec_k), sibling rows (spec_w)] — the first n_app rows
        # APPEND KV at positions ctx..ctx+n_app-1; sibling rows score
        # only. spec_epoch snapshots the slot's rollback epoch at plan
        # time (stale epoch at collect = invalidated plan-ahead).
        self.spec_off = spec_off
        self.spec_w = spec_w
        self.spec_epoch = spec_epoch
        self.n_app = n_app
        # Tree-step geometry (None unless tree_width > 1): per-row
        # position offset (pos = ctx + roff — siblings share the first
        # trunk position), per-row POOL attention limit (tpos < plim:
        # appended rows include their own scattered position,
        # score-only rows stop at their deepest appended ancestor),
        # and the in-window tree-causal mask win[s, i, j] (row i
        # attends row j's freshly computed K/V — our depth-1 sibling
        # topology only needs the sibling diagonal: a sibling's
        # ancestors are all appended, so only its SELF attention is
        # missing from the pool).
        self.roff = roff
        self.plim = plim
        self.win = win


class _KVHandle:
    __slots__ = ("plan", "raw")

    def __init__(self, plan: _StepPlan, raw):
        self.plan = plan
        self.raw = raw


class KVExecutorBase(Executor):
    kv = True
    #: no prompt_vec plane: KV replicas consume token ids.
    d = 0

    def __init__(self, slots: int, vocab: int = 64, block_size: int = 4,
                 num_blocks: int = 128, max_blocks_per_req: int = 16,
                 prefill_chunk: int = 8,
                 prefill_budget: Optional[int] = None,
                 prefix_cache: bool = True, pipelined: bool = True,
                 spec: Optional[SpecConfig] = None,
                 host_tier_bytes: Optional[int] = None):
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        self.slots = int(slots)
        self.vocab = int(vocab)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.max_blocks_per_req = int(max_blocks_per_req)
        self.max_context = self.max_blocks_per_req * self.block_size
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_budget = int(prefill_budget
                                  if prefill_budget is not None
                                  else prefill_chunk)
        if self.prefill_budget < 1:
            raise ValueError("prefill_budget must be >= 1")
        self.pipelined = bool(pipelined)
        self.allocator = KVBlockAllocator(self.num_blocks,
                                          self.block_size)
        self.prefix: Optional[PrefixTree] = (
            PrefixTree(self.allocator) if prefix_cache else None)
        # Host-RAM KV tier: opt-in via a byte budget. The
        # tree's LRU leaf eviction becomes evict-to-tier, and attach
        # extends a prefix hit past the HBM chain by restoring spilled
        # blocks (chained-hash re-verified, see tiering.py).
        self.tier: Optional[HostKVTier] = None
        if host_tier_bytes is not None and self.prefix is not None:
            self.tier = HostKVTier(host_tier_bytes)
            self.prefix.spill_hook = self._spill_block
        self._exec_id = f"kvexec-{id(self):x}"
        self._slock = threading.RLock()
        self._states: List[Optional[_SlotState]] = [None] * self.slots
        self._gen = 0
        self._rr = 0
        self._step_no = 0
        # Token-denominated counters for the serving_prefill/decode_
        # tokens_total series and the bench's prefill-stall fraction.
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.steps_decode = 0
        self.steps_mixed = 0
        self.resumed_total = 0
        # KV-aware preemption: victims parked / resumed.
        self.preempted_total = 0
        self.preempt_resumed_total = 0
        self.spec: Optional[SpecConfig] = None
        self._spec_inflight = 0  # spec windows submitted, uncollected
        if spec is not None:
            self._install_spec(spec)

    def _install_spec(self, spec: SpecConfig) -> None:
        """Arm speculative decoding. Must run before the first
        submit. Structural constraints, checked here once: the verify
        window rides the compiled chunk width (``k + 1 <=
        prefill_chunk``), with room for the sibling rows and one
        repair row when the draft is a tree.

        Speculation composes with BOTH loop shapes.
        The sync shape is the original verify loop: collect-before-plan, every
        window drafted from the previous step's accepted length. The
        pipelined shape drafts window w+1 while the device still
        verifies window w — from window w's PROPOSED tokens: under
        full acceptance every settled token except the bonus is
        host-known, the bonus chains on DEVICE (the plan-ahead
        window's base row is use_host=False), and the draft continues
        from its own prediction of it (spec.propose_full). A window
        drafted from a provisional ctx that a rollback later revokes
        is invalidated by the slot's epoch (recorded at plan, checked
        at collect) and settles nothing — the existing watermark
        rollback plus a re-plan, no new device state."""
        if spec.k + 1 > self.prefill_chunk:
            raise ValueError(
                f"spec k={spec.k} needs a verify window of k+1 <= "
                f"prefill_chunk={self.prefill_chunk}")
        if spec.tree_width + 1 > self.prefill_chunk:
            raise ValueError(
                f"tree_width={spec.tree_width} needs a verify window "
                f"of width+1 <= prefill_chunk={self.prefill_chunk}")
        self.spec = spec
        self.speculative = True
        self._spec_inflight = 0

    # -- attach / detach (called by the batcher under its settle lock) --------

    def kv_attach(self, slot: int, req) -> int:
        """Bind `req` to `slot`: re-attach its surviving lease (resume
        from the last settled token), or build a fresh one — prefix
        cache hit first, worst-case pages reserved up front. Returns
        the cached-token count (0 on resume/fresh-miss). Raises
        KVCacheOOM (shed) or ValueError (caller bug / over-long
        prompt). Atomic: on failure nothing stays bound or acquired."""
        tokens = getattr(req, "prompt_tokens", None)
        if not tokens:
            raise ValueError(
                f"kv executor needs prompt_tokens (request "
                f"{req.request_id})")
        plen = len(tokens)
        if plen + req.max_tokens > self.max_context:
            raise ValueError(
                f"prompt ({plen}) + max_tokens ({req.max_tokens}) "
                f"exceeds max context {self.max_context} (request "
                f"{req.request_id})")
        with self._slock:
            if self._states[slot] is not None:
                raise ValueError(f"slot {slot} already bound")
            lease = getattr(req, "kv_lease", None)
            if lease is not None and lease.in_transit:
                # The transfer plane owns a detached lease until it
                # acks (attach) or reattaches (failure) — a request
                # reaching admission mid-transfer means two owners.
                raise ValueError(
                    f"request {req.request_id}: lease is mid-transfer "
                    f"(detached, not yet acked)")
            if lease is not None and not lease.released:
                # The released check races the settle choke point
                # (finish() can release from the HTTP handler's thread
                # at ANY time, including right after this line) — and
                # that is fine, by the same argument that makes
                # release-while-bound safe mid-decode: a settled req
                # has req.done set, so _retire_kv evicts the binding at
                # the first retire; at most one in-flight plan scatters
                # into the freed blocks, and a stale write is always
                # overwritten by a block's next owner before it can be
                # attended (device steps execute in dispatch order, and
                # a position is appended by the step that processes it
                # before any later query's causal mask can reach it).
                # Shared prefix blocks are never scatter targets at
                # all — appends land at positions >= the block-aligned
                # cached prefix, in the request's own fresh blocks.
                if isinstance(lease, ParkedKV):
                    if (lease.exec_id == self._exec_id
                            and self.prefix is not None
                            and self.tier is not None):
                        return self._attach_parked(slot, req, lease)
                    # Parked on a different replica (or this one lost
                    # its tier): the pins mean nothing here — return
                    # them and re-prefill; deterministic decode makes
                    # the stream identical either way.
                    lease.release()
                    req.kv_lease = None
                    req.tokens.clear()
                    req.truncated = False
                elif lease.exec_id == self._exec_id:
                    return self._reattach(slot, req, lease)
                else:
                    # Foreign pages mean nothing in this pool: release
                    # them and restart the stream from the prompt (the
                    # deterministic recurrence makes the retried stream
                    # identical either way).
                    lease.release()
                    req.kv_lease = None
                    req.tokens.clear()
                    req.truncated = False
            owner = req.request_id
            cached_blocks: List[int] = []
            cached = 0
            cached_by_tier: dict = {}
            if self.prefix is not None:
                cached_blocks, cached = self.prefix.match_and_fork(
                    tokens, owner, by_tier=cached_by_tier)
                if self.tier is not None:
                    # Continue the hit past the HBM-resident chain:
                    # spilled blocks restore from the host tier
                    # (re-verified) before prefill of the suffix.
                    try:
                        cached = self._extend_from_tier(
                            tokens, owner, cached_blocks, cached,
                            cached_by_tier)
                    except Exception:
                        # Blocks restored before the failure are
                        # already appended to cached_blocks; drop the
                        # whole forked chain (the kv_match_prefix
                        # unwind) so a tier fault can't strand refs.
                        if cached_blocks:
                            self.allocator.release(cached_blocks, owner)
                        raise
            need_total = -(-(plen + req.max_tokens) // self.block_size)
            need = need_total - len(cached_blocks)
            try:
                fresh = self._acquire_with_evict(need, owner)
            except KVCacheOOM:
                if cached_blocks:
                    self.allocator.release(cached_blocks, owner)
                raise
            lease = KVLease(self.allocator, self._exec_id, owner,
                            cached_blocks + fresh, tuple(tokens),
                            cached, cached_by_tier=cached_by_tier)
            req.kv_lease = lease
            self._states[slot] = _SlotState(
                owner, lease, ctx=cached, prefill_pos=cached,
                last_token=None, max_total=plen + req.max_tokens)
            return cached

    def _attach_parked(self, slot: int, req, parked: ParkedKV) -> int:
        """Resume a preempted request from its host-parked KV (called
        under ``_slock`` from kv_attach). The parked chain covers
        prompt + settled tokens up to the preemption's confirmed
        extent, content-addressed exactly like any spilled prefix — so
        resume IS the tier-restore path: match the HBM tree first (the
        preemption's retire hook cached the prompt blocks), then
        restore the pinned suffix chain (chained-hash re-verified),
        then prefill only what neither covered. The final prefill
        position is seq[-1] — the last SETTLED token — whose step emits
        the next unsettled one: no duplicate, no gap, byte-identical to
        the unpreempted stream.

        The pins release only AFTER the fresh lease is built; a
        KVCacheOOM here leaves ``req.kv_lease`` as the ParkedKV, so the
        caller's fail() still settles the pins through finish()."""
        faults.fire("kvpreempt.resume")
        seq = list(parked.prompt) + [int(t) for t in req.tokens]
        plen = len(parked.prompt)
        owner = req.request_id
        cached_by_tier: dict = {}
        cached_blocks, cached = self.prefix.match_and_fork(
            seq, owner, by_tier=cached_by_tier)
        try:
            cached = self._extend_from_tier(
                seq, owner, cached_blocks, cached, cached_by_tier)
        except Exception:
            if cached_blocks:
                self.allocator.release(cached_blocks, owner)
            raise
        # Worst case from the ORIGINAL geometry: plen + max_tokens is
        # what admission reserved, and len(seq) + remaining budget
        # equals it exactly.
        need_total = -(-(plen + req.max_tokens) // self.block_size)
        need = need_total - len(cached_blocks)
        try:
            fresh = self._acquire_with_evict(need, owner)
        except KVCacheOOM:
            if cached_blocks:
                self.allocator.release(cached_blocks, owner)
            raise
        lease = KVLease(self.allocator, self._exec_id, owner,
                        cached_blocks + fresh, tuple(seq),
                        cached, cached_by_tier=cached_by_tier)
        req.kv_lease = lease
        parked.release()
        self._states[slot] = _SlotState(
            owner, lease, ctx=cached, prefill_pos=cached,
            last_token=None, max_total=plen + req.max_tokens)
        self.resumed_total += 1
        self.preempt_resumed_total += 1
        return cached

    def _reattach(self, slot: int, req, lease: KVLease) -> int:
        """Rebuild decode cursors from the request's SETTLED tokens —
        the durable truth a kill between dispatch and settle cannot
        skew. k settled tokens mean prompt + k-1 generated positions
        are (re)appendable; the next step feeds tokens[-1] and emits
        token k+1 — identical to the unfailed stream.

        ctx = plen + k - 1 deliberately treats the LAST settled
        token's own KV position as unwritten, which also covers tree
        speculation's one legal KV hole: a sibling-accepted token was
        verified on a score-only row (never appended) and normally
        healed by the next window's repair row — a kill between the
        sibling accept and that repair collect lands here, and
        re-feeding tokens[-1] re-appends exactly the missing
        position. Any pending st.repair dies with the old slot state;
        the rebuilt cursor needs none."""
        plen = len(lease.prompt)
        k = len(req.tokens)
        if k > 0:
            st = _SlotState(req.request_id, lease,
                            ctx=plen + k - 1, prefill_pos=plen,
                            last_token=int(req.tokens[-1]),
                            max_total=plen + req.max_tokens)
        else:
            # Killed mid-prefill: replay the prefill from the cached
            # prefix (pages already reserved — replay re-appends
            # identical values, overwrites are harmless).
            st = _SlotState(req.request_id, lease,
                            ctx=lease.cached_tokens,
                            prefill_pos=lease.cached_tokens,
                            last_token=None,
                            max_total=plen + req.max_tokens)
        self._states[slot] = st
        self.resumed_total += 1
        return 0

    def _acquire_with_evict(self, n: int, owner: str):
        """Page reservation with the admission eviction policy: on
        OOM, evict LRU prefix-cache leaves to make room; a second OOM
        is the real shed. ONE copy shared by kv_attach and kv_import
        so admission and transfer-import can never diverge on shed
        behavior. Callers own the blocks' way back (lease
        registration or the cached-blocks unwind) — the GL009 pairing
        lives at the call sites, which is why the acquires below are
        individually waived."""
        try:
            # graftlint: disable=GL009
            return self.allocator.acquire(n, owner)
        except KVCacheOOM:
            if self.prefix is None:
                raise
            # Under _slock BEFORE the tree lock: the evict-to-tier
            # spill hook exports pool bytes (which takes _slock on the
            # paged backend), and kv_attach already holds _slock when
            # it matches — one lock order everywhere, no deadlock.
            with self._slock:
                self.prefix.evict(n - self.allocator.free_count())
            # graftlint: disable=GL009
            return self.allocator.acquire(n, owner)

    # -- host tier --------------------------------------------------

    def _spill_block(self, parent_key: str, tokens, key: str,
                     block: int) -> None:
        """PrefixTree evict hook — runs UNDER the tree lock, before
        the victim's cache ref is released, so a concurrent match
        either forked the block live or finds it already parked. The
        bytes move verbatim (the kv_export representation), so a
        later restore is bit-identical to the block being dropped."""
        faults.fire("kvtier.spill")
        planes = self._tier_export_block(block, tokens)
        self.tier.put(key, parent_key, tokens, planes)

    def _extend_from_tier(self, tokens, owner: str,
                          blocks: List[int], cached: int,
                          by_tier: dict) -> int:
        """Walk the prompt's chain past the HBM-matched depth and
        restore each spilled block from the host tier: checkout under
        an owner-tagged tier lease, re-verify the chained hash against
        the tokens THIS request brought (GL019's discipline — a stale
        or corrupted entry degrades to re-prefill, never wrong KV),
        write the bytes into a freshly acquired HBM block, and publish
        it through ``attach_restored`` under the tree lock. Appends
        the restored blocks to `blocks` (owner refs held, same unwind
        as the matched chain) and returns the new cached-token count."""
        bs = self.block_size
        limit = max(0, (len(tokens) - 1) // bs)
        parent = _TREE_ROOT
        for i in range(cached // bs):
            parent = PrefixTree._key(
                parent,
                tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
        i = cached // bs
        while i < limit:
            chunk = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            key = PrefixTree._key(parent, chunk)
            entry = self.tier.checkout(key, owner)
            if entry is None:
                break
            restored = corrupt = advanced = False
            try:
                try:
                    faults.fire("kvtier.restore")
                except Exception:
                    # An injected restore fault degrades to prefilling
                    # the suffix — the tier is an optimization, never
                    # a failure domain.
                    break
                if not verify_block_tokens(parent, chunk, key,
                                           entry.tokens):
                    corrupt = True
                    break
                try:
                    fresh = self._acquire_with_evict(1, owner)
                except KVCacheOOM:
                    break  # no room to restore into; prefill covers it
                try:
                    self._tier_import_block(fresh[0], entry.planes,
                                            chunk)
                except Exception:
                    log.warning(
                        "host tier: restored content diverges for "
                        "block %s — dropping entry, re-prefilling",
                        key[:12], extra={"request_id": owner})
                    self.allocator.release(fresh, owner)
                    corrupt = True
                    break
                blk, created = self.prefix.attach_restored(
                    parent, chunk, fresh[0], owner, tier="host")
                if not created:
                    # Lost the publish race: the tree already serves
                    # this chunk — use its block, drop our copy.
                    self.allocator.release(fresh, owner)
                blocks.append(blk)
                cached += bs
                tname = "host" if created else "hbm"
                by_tier[tname] = by_tier.get(tname, 0) + bs
                restored = created
                advanced = True
            finally:
                self.tier.checkin(key, owner, restored=restored,
                                  corrupt=corrupt)
            if not advanced:
                break
            parent = key
            i += 1
        return cached

    def kv_match_prefix(self, tokens, owner: str
                        ) -> Tuple[List[int], int]:
        """Fork the longest cached prefix of `tokens` — the HBM chain
        plus host-tier restores — to `owner`, WITHOUT binding a slot:
        the router pull's source-side primitive. The caller
        owns releasing the forked refs (success and failure paths
        both). Returns (blocks, cached_token_count)."""
        if self.prefix is None:
            return [], 0
        with self._slock:
            by_tier: dict = {}
            blocks, cached = self.prefix.match_and_fork(
                tokens, owner, by_tier=by_tier)
            try:
                if self.tier is not None:
                    cached = self._extend_from_tier(
                        tokens, owner, blocks, cached, by_tier)
            except Exception:
                self.allocator.release(blocks, owner)
                raise
            return blocks, cached

    def _tier_export_block(self, block: int, tokens) -> list:
        raise NotImplementedError

    def _tier_import_block(self, block: int, planes: list,
                           tokens) -> None:
        raise NotImplementedError

    def kv_release_slot(self, slot: int, cache: bool = True) -> None:
        """Unbind `slot` and release its lease exactly once; when
        `cache`, the request's full prompt blocks are inserted into
        the prefix tree INSIDE the release (owner refs still held, so
        the cache fork can never race a concurrent settle-path
        release)."""
        with self._slock:
            st = self._states[slot]
            self._states[slot] = None
        if st is None:
            return
        st.lease.release(
            cache_hook=self.prefix_cache_hook(st.confirmed)
            if cache else None)

    def prefix_cache_hook(self, confirmed: int):
        """The release-time prefix-cache insert covering only
        COLLECT-CONFIRMED prompt positions (confirmed, NOT ctx: a
        mid-prefill truncation retires the slot while its latest
        chunk is dispatched but uncollected — if that step then fails,
        ctx-derived caching would publish blocks whose KV was never
        written, and match_and_fork would serve them as truth to
        every later same-prefix request). Shared by the retire path
        above and the disagg transfer plane's post-ack release."""
        if self.prefix is None:
            return None
        prefix_tree, bs = self.prefix, self.block_size
        confirmed = int(confirmed)

        def hook(lease):
            written = min(len(lease.prompt), confirmed)
            full = (written // bs) * bs
            if full > 0:
                prefix_tree.insert(lease.prompt[:full],
                                   lease.blocks[:full // bs])
        return hook

    # -- cross-replica page hand-off (serving/disagg) --------------------------

    @property
    def kv_spec(self):
        """The pool layout + model identity as a KVSpec — declared
        once here, and everything the transfer path does (wire bytes,
        segmentation, the receiver's parse, the hello check) derives
        from it. Lazy import: kvcache must stay importable without
        the disagg package (which imports kvcache back)."""
        from ..disagg.spec import KVSpec

        return KVSpec(**self._spec_fields())

    def _spec_fields(self) -> dict:
        raise NotImplementedError

    def kv_detach_slot(self, slot: int) -> Optional[dict]:
        """Unbind `slot` and DETACH its lease for a cross-replica
        hand-off: the pages stay owned (a failed transfer reattaches
        and resumes here), the slot frees for new admissions, and the
        returned descriptor carries everything the transfer plane
        needs — the lease, the collect-CONFIRMED written extent
        (export must never ship positions a failed step left
        unwritten), and this executor (the export source). The
        detach/ack pairing is the GL016 contract: every caller must
        visibly hand the result to the transfer plane or settle it.

        Returns None when the request settled concurrently (the
        handler-thread finish() released the lease between the
        caller's done-check and here — the race every settle path
        tolerates): the slot is unbound, the pages already returned
        through the choke point, and there is nothing to hand off."""
        with self._slock:
            st = self._states[slot]
            self._states[slot] = None
        if st is None:
            raise ValueError(f"slot {slot}: nothing bound to detach")
        if not st.lease.detach():
            return None
        return {"lease": st.lease, "confirmed": int(st.confirmed),
                "req_id": st.req_id, "executor": self}

    def kv_preempt_slot(self, slot: int, req) -> Optional[dict]:
        """Preempt `slot`'s occupant for a higher-priority arrival
        (QoS): park its CONFIRMED KV in the host tier and free the
        HBM pages, so the request can requeue carrying a ParkedKV and
        resume later with only its uncovered suffix re-prefilled —
        strictly fewer replayed steps than re-decoding from the prompt.

        Two-phase, all-or-nothing, called under the batcher's settle
        lock like every attach/detach:

          * **Park (fallible).** Export each full confirmed block
            verbatim into the tier under its chained content key and
            pin it (``checkout``) for the victim. Any failure here
            unwinds the pins and leaves the victim BOUND — a crash-only
            exit mid-park looks exactly like a replica fault, and the
            supervisor's seize→requeue→_reattach path already lands the
            lease exactly once.
          * **Commit.** ``detach()`` the HBM lease (False → the request
            settled concurrently: unwind, unbind, nothing to requeue),
            swap ``req.kv_lease`` to the ParkedKV, and release the HBM
            pages through the ordinary retire hook (confirmed prompt
            blocks go to the prefix cache, everything else frees).

        Without a tier — or when nothing confirmed fills one block —
        falls back to detach-and-reattach: the pages stay reserved (no
        HBM freed) but the SLOT frees, which is the resource the
        interactive arrival is actually queued on. Returns the hand-off
        descriptor, or None when the victim settled concurrently."""
        with self._slock:
            st = self._states[slot]
            if st is None:
                raise ValueError(
                    f"slot {slot}: nothing bound to preempt")
            lease = st.lease
            owner = st.req_id
            bs = self.block_size
            pins: List[str] = []
            parent = _TREE_ROOT
            if (self.tier is not None and self.prefix is not None
                    and not lease.released):
                seq = list(lease.prompt) + [int(t) for t in req.tokens]
                nspill = min(int(st.confirmed), len(seq)) // bs
                nspill = min(nspill, len(lease.blocks))
                try:
                    for i in range(nspill):
                        chunk = tuple(seq[i * bs:(i + 1) * bs])
                        key = PrefixTree._key(parent, chunk)
                        planes = self._tier_export_block(
                            lease.blocks[i], chunk)
                        faults.fire("kvpreempt.park")
                        if not self.tier.put(key, parent, chunk,
                                             planes):
                            break  # tier full: park the prefix we got
                        if self.tier.checkout(key, owner) is None:
                            break
                        pins.append(key)
                        parent = key
                except BaseException:
                    # Crash-only: unwind the pins, leave the victim
                    # bound — the supervisor's seize path owns it now.
                    for pinned in pins:
                        self.tier.checkin(pinned, owner)
                    raise
            if not pins:
                # Nothing parkable (no tier, cold victim, or tier
                # full): free the SLOT, keep the pages — resume rides
                # the ordinary _reattach path.
                if not lease.detach():
                    self._states[slot] = None
                    return None
                lease.reattach()
                self._states[slot] = None
                self.preempted_total += 1
                return {"lease": lease, "confirmed": int(st.confirmed),
                        "req_id": st.req_id, "executor": self,
                        "parked_blocks": 0}
            if not lease.detach():
                # Settled concurrently (handler-thread finish() between
                # the caller's done-check and here): the pages already
                # returned through the choke point — unpin and unbind.
                for key in pins:
                    self.tier.checkin(key, owner)
                self._states[slot] = None
                return None
            parked = ParkedKV(self.tier, self._exec_id, owner, pins,
                              lease.prompt,
                              cached_tokens=len(pins) * bs,
                              cached_by_tier={"host": len(pins) * bs})
            req.kv_lease = parked
            # Release the HBM pages through the ordinary retire hook:
            # confirmed prompt blocks feed the prefix cache, the rest
            # free for the arrival that triggered the preemption.
            lease.release(
                cache_hook=self.prefix_cache_hook(st.confirmed))
            self._states[slot] = None
            self.preempted_total += 1
            if req.done:
                # finish() raced the swap: it settled the OLD lease;
                # the pins are ours to return.
                parked.release()
                return None
            return {"lease": parked, "confirmed": int(st.confirmed),
                    "req_id": st.req_id, "executor": self,
                    "parked_blocks": len(pins)}

    def kv_export(self, req, detach: dict) -> Tuple[dict, list]:
        """Read the detached lease's WRITTEN pages out of this pool:
        ``(meta, planes)`` where meta is the wire-ready transfer
        header (self-contained: the importer rebuilds the lease from
        it alone, no shared objects across the boundary) and planes
        the pool-layout arrays ``[(payload, scales), ...]`` for the
        stream's codec stage."""
        lease = detach["lease"]
        n_tokens = int(detach["confirmed"])
        n_blocks = -(-n_tokens // self.block_size)
        blocks = lease.blocks[:n_blocks]
        planes = self._export_pages(blocks, req, n_tokens)
        meta = {"req": req.request_id, "tokens": n_tokens,
                "n_blocks": n_blocks, "cached": lease.cached_tokens,
                "prompt_tokens": list(lease.prompt),
                "settled": [int(t) for t in req.tokens],
                "max_tokens": int(req.max_tokens)}
        return meta, planes

    def kv_import(self, meta: dict, planes: list):
        """Build a LOCAL lease for a transferred request: reserve its
        worst-case pages from THIS pool (OOM here is the importer's
        nack — capacity pressure, the transfer plane's retry/requeue
        decision), write the shipped pages into the first blocks, and
        return the new KVLease (exec_id = this executor, so the
        decode-side kv_attach takes the _reattach resume path). The
        caller owns attaching it to the request — and releasing it if
        the hand-off dies between ack and attach."""
        prompt = [int(t) for t in meta["prompt_tokens"]]
        plen = len(prompt)
        if plen + int(meta["max_tokens"]) > self.max_context:
            raise ValueError(
                f"transferred request {meta.get('req')} needs "
                f"{plen} + {meta['max_tokens']} context; this pool "
                f"caps at {self.max_context}")
        owner = str(meta["req"])
        need = -(-(plen + int(meta["max_tokens"])) // self.block_size)
        n_blocks = int(meta["n_blocks"])
        if n_blocks > need:
            raise ValueError(
                f"transfer ships {n_blocks} block(s) but the lease "
                f"geometry derives {need}")
        fresh = self._acquire_with_evict(need, owner)
        try:
            self._import_pages(fresh[:n_blocks], planes, meta)
        except BaseException:
            self.allocator.release(fresh, owner)
            raise
        return KVLease(self.allocator, self._exec_id, owner, fresh,
                       tuple(prompt),
                       cached_tokens=int(meta.get("cached", 0)))

    def _export_pages(self, blocks, req, n_tokens: int) -> list:
        raise NotImplementedError

    def _import_pages(self, blocks, planes: list, meta: dict) -> None:
        raise NotImplementedError

    # -- the two-phase decode contract ----------------------------------------

    def kv_gen(self) -> int:
        return self._gen

    def reset(self) -> None:
        """New decode session: slot bindings and the step plan
        generation reset; the KV POOLS and the prefix cache survive —
        surviving pages are exactly what makes a post-restart
        re-attach worth anything. Leases are owned by their requests,
        never by the session."""
        with self._slock:
            self._gen += 1
            self._states = [None] * self.slots
            self._spec_inflight = 0
            self._backend_reset()

    def submit(self, updates: Sequence = (), step=None,
               request_ids=None, gen: Optional[int] = None,
               occupants=None):
        """Plan and dispatch one fused step. `updates` is unused (the
        KV plane assembles its own token window from slot state);
        `gen` (from kv_gen(), captured under the batcher's settle
        lock) turns a submit raced by a supervisor seize→reset into a
        no-op stale handle instead of corrupting the new session.

        _dispatch runs UNDER _slock, deliberately: plan+dispatch must
        be atomic against reset(), or an abandoned thread could
        dispatch a stale plan AFTER the new session re-acquired its
        freed blocks — a silent scatter into another request's KV
        (device execution order is dispatch order only per thread).
        The cost is that a dispatch wedged on the device holds the
        lock and a restart's reset() blocks behind it — but reset
        runs under the supervisor's watchdog clock, so that degrades loudly
        to breaker-parking the replica, which is the designed outcome
        for an unresponsive device. The realistic wedge point
        (materialize/block_until_ready) is in collect(), which takes
        _slock only AFTER materializing."""
        with self._slock:
            if gen is not None and gen != self._gen:
                plan = _StepPlan(gen, 0, None, None, None, None, None,
                                 np.zeros((self.slots,), bool),
                                 stale=True)
                return _KVHandle(plan, None)
            plan = self._plan_step()
            raw = self._dispatch(plan)
            return _KVHandle(plan, raw)

    def step_clock(self, handle) -> Optional[StepClock]:
        if handle.plan.stale:
            return None
        return self._raw_clock(handle.raw)

    def _plan_step(self) -> _StepPlan:
        S, C, B = self.slots, self.prefill_chunk, self.max_blocks_per_req
        host_tok = np.zeros((S, C), np.int32)
        use_host = np.zeros((S,), bool)
        ctx = np.zeros((S,), np.int32)
        n_new = np.zeros((S,), np.int32)
        tables = np.zeros((S, B), np.int32)
        emit = np.zeros((S,), bool)
        owners: List = [None] * S
        spec = self.spec
        spec_k = np.full((S,), -1, np.int32) if spec is not None \
            else None
        spec_slots: List[int] = []
        budget = self.prefill_budget
        step_prefill = 0
        step_decode = 0
        # Rotating start: with the budget shared across slots, a long
        # prompt in slot 0 must not permanently starve slot 1's.
        order = [(self._rr + j) % S for j in range(S)]
        self._rr = (self._rr + 1) % S
        for s in order:
            st = self._states[s]
            if st is None:
                continue
            plen = len(st.lease.prompt)
            owners[s] = st.req_id
            ctx[s] = st.ctx
            tables[s, :len(st.lease.blocks)] = st.lease.blocks
            if st.prefill_pos < plen:
                take = min(C, plen - st.prefill_pos, budget)
                st.pending_emit = False
                if take <= 0:
                    st.chain_device = False
                    continue  # budget spent: this prompt waits a step
                host_tok[s, :take] = st.lease.prompt[
                    st.prefill_pos:st.prefill_pos + take]
                use_host[s] = True
                n_new[s] = take
                budget -= take
                step_prefill += take
                finishes = st.prefill_pos + take >= plen
                emit[s] = finishes
                st.ctx += take
                st.prefill_pos += take
                # Speculative mode never chains on device: the next
                # plan drafts FROM the last accepted token, which must
                # be host-side (stamped at collect — the sync loop
                # shape guarantees collect precedes the next plan).
                st.chain_device = bool(finishes) and spec is None
                st.pending_emit = bool(finishes)
            elif spec is not None:
                if st.last_token is None and st.spec_ahead is None:
                    if not self.pipelined:
                        raise RuntimeError(
                            f"slot {s}: speculative decode with no "
                            f"prior token (request {st.req_id})")
                    # Pipelined prefill finish: the slot's first emit
                    # is still in flight and the draft has nothing to
                    # chain from — bubble ONE step (n_new stays 0)
                    # until collect stamps last_token. Once the chain
                    # starts, spec_ahead carries it forward and the
                    # bubble never recurs.
                    st.chain_device = False
                    continue
                # Speculative decode: defer to the batched draft call
                # below (one propose per step — a jitted draft wants
                # one fixed-shape dispatch, not a per-slot loop).
                spec_slots.append(s)
            else:
                # Decode: one token, NEVER budget-rationed (the
                # bounded-prefill contract protecting decode p99).
                n_new[s] = 1
                emit[s] = True
                step_decode += 1
                if st.chain_device:
                    use_host[s] = False  # input = previous step's
                    # on-device emit, still in flight
                else:
                    if st.last_token is None:
                        raise RuntimeError(
                            f"slot {s}: decode with no prior token "
                            f"(request {st.req_id})")
                    host_tok[s, 0] = st.last_token
                    use_host[s] = True
                st.ctx += 1
                st.chain_device = True
                st.pending_emit = True
        tree = spec is not None and spec.tree_width > 1
        spec_off = spec_w = spec_epoch = n_app_v = None
        roff = plim = win = None
        if spec is not None:
            spec_off = np.zeros((S,), np.int32)
            spec_w = np.zeros((S,), np.int32)
            spec_epoch = np.zeros((S,), np.int32)
            n_app_v = n_new  # rebound to a tree copy below
        if spec_slots:
            # One fixed-shape propose over ALL slots (idle/prefill
            # rows carry zeros and are ignored): the draft's AOT
            # executable compiles once, like every other step shape.
            last = np.zeros((S,), np.int32)
            base = np.zeros((S,), np.int32)
            ahead_v = [False] * S
            for s in spec_slots:
                st = self._states[s]
                # Plan-ahead seam: a device-chained slot's base row
                # takes the TRUE bonus from the in-flight window on
                # device; the draft chains from its host-side
                # PREDICTION of it. Repair rows force the host path
                # (they are row 0, and only row 0 can device-chain) —
                # and a rollback broke the chain anyway.
                ahead_v[s] = (self.pipelined and st.chain_device
                              and st.spec_ahead is not None
                              and not st.repair)
                last[s] = (st.spec_ahead if ahead_v[s]
                           else st.last_token)
                base[s] = st.ctx + len(st.repair)
            if self.pipelined:
                pf = propose_full(spec.draft, last, base)
                drafts = pf[:, :spec.k]
            else:
                pf = None
                drafts = np.asarray(spec.draft.propose(last, base),
                                    np.int32)
            sibs = (np.asarray(spec.draft.propose_sibs(last, base),
                               np.int32) if tree else None)
            for s in spec_slots:
                st = self._states[s]
                R = len(st.repair)
                w_want = spec.width_for(st.spec_ewma) - 1
                # Clamp inside the admission-time page reservation:
                # the max position a verify step writes equals the
                # one-token loop's max, so speculation never needs
                # slack pages (see spec.clamp_spec_k). Repair and
                # sibling rows ride the same chunk width.
                ks = clamp_spec_k(spec.k_for(st.spec_ewma),
                                  int(base[s]), st.max_total,
                                  C - R - w_want)
                w = w_want if ks >= 1 else 0
                n_app = R + 1 + ks
                for i, rt in enumerate(st.repair):
                    host_tok[s, i] = rt
                if ahead_v[s]:
                    use_host[s] = False
                else:
                    host_tok[s, R] = st.last_token
                    use_host[s] = True
                if ks:
                    host_tok[s, R + 1:R + 1 + ks] = drafts[s, :ks]
                if w:
                    host_tok[s, n_app:n_app + w] = sibs[s, :w]
                n_new[s] = n_app + w
                spec_k[s] = ks
                spec_off[s] = R
                spec_w[s] = w
                spec_epoch[s] = st.spec_epoch
                emit[s] = True
                step_decode += 1
                # Provisional FULL-ACCEPTANCE advance over the
                # APPENDED rows: collect rolls ctx back to the
                # accepted extent. The confirmed watermark never
                # moves here — that is exactly what makes rejection
                # a pure truncation.
                st.ctx += n_app
                st.repair = []
                st.chain_device = bool(self.pipelined)
                st.spec_ahead = int(pf[s, ks]) if pf is not None \
                    else None
                st.pending_emit = True
                spec.stats.proposed += ks + w
            self._spec_inflight += 1
            if self._spec_inflight > spec.stats.pipeline_peak:
                spec.stats.pipeline_peak = self._spec_inflight
        if tree:
            # Tree-step geometry for EVERY row (prefill chunks too —
            # a tree-armed executor routes all steps through the one
            # tree executable, so chain rows carry their degenerate
            # layout: roff = row index, all rows append, empty
            # in-window mask). Sibling rows share the first trunk
            # position and stop their pool attention BEFORE it (the
            # trunk's append there is a different branch).
            n_app_v = n_new - np.maximum(spec_w, 0)
            roff = np.tile(np.arange(C, dtype=np.int32), (S, 1))
            for s in spec_slots:
                if spec_w[s]:
                    na = int(n_app_v[s])
                    roff[s, na:na + int(spec_w[s])] = \
                        int(spec_off[s]) + 1
            rows = np.arange(C, dtype=np.int32)[None, :]
            pos = ctx[:, None] + roff
            app_row = rows < n_app_v[:, None]
            valid_row = rows < n_new[:, None]
            plim = np.where(valid_row, pos + app_row, 0
                            ).astype(np.int32)
            win = np.zeros((S, C, C), bool)
            for s in spec_slots:
                na, w = int(n_app_v[s]), int(spec_w[s])
                for i in range(na, na + w):
                    win[s, i, i] = True
        self._step_no += 1
        self.prefill_tokens += step_prefill
        if step_decode:
            self.steps_decode += 1
            if step_prefill:
                self.steps_mixed += 1
        return _StepPlan(self._gen, self._step_no, host_tok, use_host,
                         ctx, n_new, tables, emit, owners,
                         spec_k=spec_k, spec_off=spec_off,
                         spec_w=spec_w, spec_epoch=spec_epoch,
                         n_app=n_app_v, roff=roff, plim=plim, win=win)

    def collect(self, handle: _KVHandle) -> np.ndarray:
        """[slots] int32: the emitted token per slot, NO_TOKEN (-1)
        where this step emitted nothing (mid-prefill chunk, idle slot,
        stale handle). Speculative executors return [slots, chunk]
        instead — each row the step's ACCEPTED token run, NO_TOKEN-
        padded (see _collect_spec); the scheduler's retire normalizes
        both shapes through spec.token_run. Pure — no state mutation,
        so an abandoned batcher thread waking from a wedge cannot
        corrupt the restarted session by collecting."""
        if self.spec is not None:
            return self._collect_spec(handle)
        out = np.full((self.slots,), NO_TOKEN, np.int32)
        if handle.plan.stale:
            return out
        raw = np.asarray(self._materialize(handle.raw), np.int32)
        emit = handle.plan.emit
        out[emit] = raw[emit]
        # Record last emitted tokens host-side: a re-attach after THIS
        # generation dies feeds them back through the host path. The
        # owner check attributes each emit to the state that PLANNED
        # it: a retire + fresh admit can rebind the slot between
        # submit and collect, and the old request's phantom emit must
        # not overwrite the new state's last_token. The decode-token
        # counter lives on the same guard, NOT at plan time — the
        # pipelined loop plans one phantom step per retiring request
        # whose token is dropped, so plan-time counting inflates
        # decode throughput by ~1/max_tokens and diverges from sync
        # mode on identical streams. A surviving owned emit is a
        # settled token: both modes count exactly what clients
        # receive.
        with self._slock:
            if handle.plan.gen == self._gen:
                for s in range(self.slots):
                    st = self._states[s]
                    if st is None or st.req_id != handle.plan.owners[s]:
                        continue
                    if handle.plan.n_new[s]:
                        # This step's device writes are now real:
                        # advance the confirmed-KV watermark (mid-
                        # prefill chunks too — they write without
                        # emitting).
                        st.confirmed = max(
                            st.confirmed,
                            int(handle.plan.ctx[s]
                                + handle.plan.n_new[s]))
                    if emit[s] and st.pending_emit:
                        st.last_token = int(raw[s])
                        self.decode_tokens += 1
        return out

    def _collect_spec(self, handle: _KVHandle) -> np.ndarray:
        """The speculative collect path: [slots, chunk] int32, row s
        holding the step's accepted token run left-aligned (NO_TOKEN
        padding). Greedy-verify acceptance per decode slot: the
        target's per-position argmax ``t_0..t_ks`` against the plan's
        drafts — ``a`` leading matches accept ``t_0..t_a`` (a+1
        tokens, at least the bonus).

        REJECTION IS ROLLBACK, done entirely here under the same
        owner guard the one-token path uses: ``st.ctx`` (advanced by
        ks+1 at plan time) rolls back to ``plan_ctx + a + 1`` and the
        confirmed watermark advances ONLY to that accepted extent.
        No device-side unwind exists or is needed — KV at rejected
        positions sits beyond the watermark, so the prefix cache can
        never publish it (the confirmed-watermark contract), a re-attach
        rebuilds cursors from settled tokens below it, and the next
        verify step's append simply overwrites the dead rows (a
        position's K/V depends only on its own input embedding, so
        the overwrite equals what an unspeculated run writes).

        Mid-prefill chunks confirm their full n_new exactly like the
        one-token path; a prefill-finishing step emits its single
        token as a length-1 run. The owner guard + the ``n_new == 0``
        check keep the zero-work-slot no-op contract (a budget-
        starved slot raced by retire+re-admit between submit and
        collect must neither advance a watermark nor stamp a
        last_token) — the guard speculative rollback leans on.

        Speculation adds three cases, all inside the same guard:

        * EPOCH-STALE plan-ahead (pipelined): the plan was drafted
          from a provisional ctx a rollback has since revoked — it
          settles NOTHING and bumps nothing (the re-plan after the
          rollback already owns the slot's cursors); counted as a
          replan. Its device writes are dead bytes a later valid
          window overwrites, the standard watermark argument.
        * FULL acceptance under pipelining leaves ``st.ctx`` ALONE —
          the in-flight plan-ahead already advanced it past this
          window, and rolling it back here would replay positions the
          plan-ahead owns. Rollback (and the epoch bump invalidating
          in-flight plans) happens only when something was actually
          rejected.
        * TREE windows accept the longest matching root-to-leaf path
          (spec.accept_tree). A winning sibling settles its token
          WITHOUT an appended KV row (the trunk's append at that
          position holds the rejected trunk token), so confirmed
          stops before it and the token re-feeds as the next window's
          repair row — the hole closes before any later query can
          attend it."""
        C = self.prefill_chunk
        out = np.full((self.slots, C), NO_TOKEN, np.int32)
        if handle.plan.stale:
            return out
        raw = np.asarray(self._materialize(handle.raw), np.int32)
        plan = handle.plan
        spec = self.spec
        alpha = spec.ewma_alpha
        with self._slock:
            if plan.gen != self._gen:
                return out
            if plan.spec_k is not None and (plan.spec_k >= 0).any():
                self._spec_inflight = max(0, self._spec_inflight - 1)
            for s in range(self.slots):
                st = self._states[s]
                if st is None or st.req_id != plan.owners[s]:
                    continue
                n = int(plan.n_new[s])
                if n == 0:
                    continue
                base = int(plan.ctx[s])
                ks = int(plan.spec_k[s])
                if ks < 0:
                    # Prefill chunk: every planned position's KV is
                    # now real (chunks write without emitting); the
                    # finishing chunk emits one token.
                    st.confirmed = max(st.confirmed, base + n)
                    if plan.emit[s] and st.pending_emit:
                        t = int(raw[s, n - 1])
                        out[s, 0] = t
                        st.last_token = t
                        self.decode_tokens += 1
                    continue
                if not st.pending_emit:
                    continue
                if int(plan.spec_epoch[s]) != st.spec_epoch:
                    spec.stats.replans += 1
                    continue
                R = int(plan.spec_off[s])
                w = int(plan.spec_w[s])
                n_app = R + 1 + ks
                run, sib = accept_tree(
                    plan.host_tok[s, R + 1:R + 1 + ks],
                    plan.host_tok[s, n_app:n_app + w],
                    raw[s, R:R + ks + 1],
                    raw[s, n_app:n_app + w])
                a = len(run) - 1 if sib < 0 else 0
                out[s, :len(run)] = run
                if sib >= 0:
                    # Sibling path: t_0 is settled truth but the KV at
                    # its position holds the REJECTED trunk token —
                    # confirm up to the base row only and queue the
                    # repair re-append.
                    st.ctx = base + R + 1
                    st.confirmed = max(st.confirmed, base + R + 1)
                    st.repair = [int(run[0])]
                    st.spec_epoch += 1
                    st.chain_device = False
                    st.spec_ahead = None
                elif a < ks:
                    st.ctx = base + R + a + 1      # the rollback
                    st.confirmed = max(st.confirmed, base + R + a + 1)
                    st.spec_epoch += 1
                    st.chain_device = False
                    st.spec_ahead = None
                else:
                    # Full acceptance: the provisional advance stands
                    # (a pipelined plan-ahead may already sit past
                    # it); only the watermark catches up.
                    st.confirmed = max(st.confirmed, base + n_app)
                st.last_token = int(run[-1])
                self.decode_tokens += len(run)
                if ks > 0:
                    rate = (a if sib < 0 else 1) / ks
                    st.spec_ewma = ((1.0 - alpha) * st.spec_ewma
                                    + alpha * min(1.0, rate))
                spec.stats.record_run(accepted=len(run) - 1,
                                      path_len=len(run))
        return out

    def kv_stats(self) -> dict:
        """Scrape-time snapshot for /metrics and the bench."""
        stats = self.allocator.stats()
        out = {"blocks_used": stats["used"],
               "blocks_free": stats["free"],
               "blocks_shared": stats["shared"],
               "prefill_tokens": self.prefill_tokens,
               "decode_tokens": self.decode_tokens,
               "steps_decode": self.steps_decode,
               "steps_mixed": self.steps_mixed,
               "resumed": self.resumed_total,
               "preempted": self.preempted_total,
               "preempt_resumed": self.preempt_resumed_total,
               "prefix_hit_tokens": 0, "prefix_lookup_tokens": 0}
        if self.prefix is not None:
            out["prefix_hit_tokens"] = self.prefix.hit_tokens
            out["prefix_lookup_tokens"] = self.prefix.lookup_tokens
            for tname, v in self.prefix.hit_tokens_by_tier.items():
                out[f"prefix_hit_tokens_{tname}"] = v
        if self.tier is not None:
            for k, v in self.tier.stats().items():
                out[f"tier_{k}"] = v
        if self.spec is not None:
            st = self.spec.stats
            out["spec_proposed_tokens"] = st.proposed
            out["spec_accepted_tokens"] = st.accepted
            out["spec_verify_steps"] = st.runs
            out["spec_accept_rate"] = round(st.accept_rate(), 6)
            out["spec_tokens_per_step"] = round(st.tokens_per_step(),
                                                6)
            out["spec_replans"] = st.replans
            out["spec_pipeline_depth"] = self._spec_inflight
            out["spec_pipeline_peak"] = st.pipeline_peak
            out["spec_path_len"] = dict(st.path_len)
        return out

    # -- backend hooks --------------------------------------------------------

    def _backend_reset(self) -> None:
        raise NotImplementedError

    def _dispatch(self, plan: _StepPlan):
        raise NotImplementedError

    def _materialize(self, raw) -> np.ndarray:
        raise NotImplementedError

    def _raw_clock(self, raw) -> Optional[StepClock]:
        """The StepClock of a collected step's ``raw``; None without a
        device clock."""
        return None

    # step() has no meaning on the token plane.
    def step(self, x):  # pragma: no cover - contract guard
        raise NotImplementedError(
            "KV executors speak the two-phase token contract only")


class PagedKVExecutor(KVExecutorBase):
    """Device-resident paged-attention replica over the PyTorch step
    (kvcache/paged.py). ``mode="pipelined"`` (default) leaves submit()
    asynchronous: the step is queued on this executor's own CUDA stream
    and the decode recurrence chains on the device, so the scheduler
    plans step k+1 while step k runs. ``mode="sync"`` drives the same
    step through the scheduler's synchronous KV loop.
    ``mode="speculative"`` is the draft/verify mode: the step emits
    PER-POSITION argmax tokens (``per_pos=True``) and the executor plans
    k-token verify windows against ``draft`` (default: a
    spec.TruncatedDraft over this step's own embed/positional/output
    weights) in the sync loop shape; every chain verify window attends
    through the same fused call, the hand-written kernel on the card.
    ``mode="speculative-pipelined"`` overlaps the draft with the verify:
    window w+1 is planned from window w's proposed tokens while the
    device still verifies w, the true bonus chains on the device
    (``take_prev``), and a mis-speculation is the epoch-gated watermark
    rollback. ``spec_tree_width >= 2`` widens either speculative mode to
    a token tree (trunk chain + first-position siblings under a
    tree-causal mask); every step of a tree-armed executor then goes
    through ``PagedDecodeStep.tree_step``, the PyTorch composition,
    which launches no paged-attention kernel (the kernel's per-row
    causal mask cannot express the tree's).

    ``device=None`` means ``"cuda"``: the executor runs on the card
    unless the caller asks for the CPU, and with no CUDA device it
    raises rather than run on the CPU. ``kernel=None`` means the
    hand-written kernel (``"cuda"``) on a CUDA device and its plain
    version (``"torch"``) on the CPU; ``kernel="cuda"`` on the CPU
    raises. ``pool_dtype`` selects int8 codes + per-block scales
    (default) or fp32 rows.

    The pools are updated in place (the reference builds new arrays).
    Every read or write of them is queued on the executor's stream
    under ``_slock``, after every step dispatched before it and before
    every step dispatched after it. A rejected window's appended rows
    stay in the pool until a later window overwrites them: the planner
    never lets a step attend past ``ctx + n_app``."""

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
                 spec_tree_width: int = 1,
                 spec_adaptive: bool = False,
                 host_tier_bytes: Optional[int] = None, device=None):
        if mode not in ("pipelined", "sync", "speculative",
                        "speculative-pipelined"):
            raise ValueError(f"mode must be pipelined|sync|speculative"
                             f"|speculative-pipelined, got {mode!r}")
        speculative = mode in ("speculative", "speculative-pipelined")
        from ..spec import TruncatedDraft
        from .paged import PagedDecodeStep, resolve_device

        self.device = resolve_device(device, "PagedKVExecutor")
        super().__init__(slots, vocab=vocab, block_size=block_size,
                         num_blocks=num_blocks,
                         max_blocks_per_req=max_blocks_per_req,
                         prefill_chunk=prefill_chunk,
                         prefill_budget=prefill_budget,
                         prefix_cache=prefix_cache,
                         pipelined=mode in ("pipelined",
                                            "speculative-pipelined"),
                         host_tier_bytes=host_tier_bytes)
        # One stream per executor: steps, page imports/exports and pool
        # allocation all queue on it, in dispatch order.
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self._clock = (CudaStepClock() if self._stream is not None
                       else None)
        self._seed = int(seed)  # weight identity, in _spec_fields
        with self._on_stream():
            self._paged = PagedDecodeStep(
                slots=slots, vocab=vocab, d=d, heads=heads,
                block_size=block_size, num_blocks=num_blocks,
                max_blocks_per_req=max_blocks_per_req,
                chunk=prefill_chunk, seed=seed, kernel=kernel,
                pool_dtype=pool_dtype, device=self.device,
                per_pos=speculative,
                tree=speculative and spec_tree_width > 1)
            if speculative:
                if draft is None:
                    # Built on the step's stream: the draft's own stream
                    # starts after the weights it reads have landed.
                    draft = TruncatedDraft.from_paged(
                        self._paged, spec_k, tree_width=spec_tree_width)
                self._install_spec(SpecConfig(
                    draft, spec_k, tree_width=spec_tree_width,
                    adaptive=spec_adaptive))
            (self._kpool, self._kscale,
             self._vpool, self._vscale) = self._paged.init_pools()
            self._prev = self._paged.init_prev()
        if warmup:
            # One dispatched no-op step: first-launch costs (library
            # loads, the kernel build) are paid here, not under the
            # supervisor's watchdog. It also advances the planner's
            # rotating prefill start, as the reference's warmup does.
            self.collect(self.submit((), gen=self._gen))
            self.reset()

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _backend_reset(self) -> None:
        # Pools (codes AND scales) are kept: re-attach depends on
        # surviving pages; only the token recurrence restarts.
        with self._on_stream():
            self._prev = self._paged.init_prev()
        if self._clock is not None:
            self._clock.reset()

    def _spec_fields(self) -> dict:
        p = self._paged
        return dict(model="paged", block_size=p.block_size,
                    heads=p.heads, d_head=p.d_head, vocab=p.vocab,
                    max_blocks_per_req=p.max_blocks_per_req,
                    pool_dtype=p.pool_dtype, planes=2,
                    seed=self._seed)

    def _gather_blocks(self, blocks) -> list:
        """Device->host copy of whole blocks (codes + scales). Under
        _slock, queued on the step stream: it waits for every step
        dispatched before it, whose appends are then final."""
        with self._slock, self._on_stream():
            idx = torch.as_tensor(np.asarray(blocks, np.int64),
                                  device=self.device)
            return [(self._kpool[idx].cpu().numpy(),
                     self._kscale[idx].cpu().numpy()),
                    (self._vpool[idx].cpu().numpy(),
                     self._vscale[idx].cpu().numpy())]

    def _scatter_blocks(self, blocks, planes: list) -> None:
        """Host->device write of whole blocks, in place. The reference's
        ``.at[].set`` built new arrays, so an in-flight step kept its own
        buffers and the next dispatch saw the import. Here the write is
        queued on the step stream under _slock: every step dispatched
        before it runs to its end on the old contents first, and every
        step dispatched after it sees the whole import — the same
        visibility, and no step sees a half-written block."""
        (k, ksc), (v, vsc) = planes

        def dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=self.device, dtype=dtype, non_blocking=True)

        with self._slock, self._on_stream():
            idx = torch.as_tensor(np.asarray(blocks, np.int64),
                                  device=self.device)
            self._kpool[idx] = dev(k, self._kpool.dtype)
            self._kscale[idx] = dev(ksc, torch.float32)
            self._vpool[idx] = dev(v, self._vpool.dtype)
            self._vscale[idx] = dev(vsc, torch.float32)

    def _export_pages(self, blocks, req, n_tokens: int) -> list:
        """Gather the written blocks device->host (see _gather_blocks:
        a later in-flight step only appends beyond the export extent)."""
        return self._gather_blocks(blocks)

    def _import_pages(self, blocks, planes: list, meta: dict) -> None:
        """Write transferred pages at the freshly acquired block ids."""
        self._scatter_blocks(blocks, planes)

    def _tier_export_block(self, block: int, tokens) -> list:
        """One block to the host tier: int8 codes + scales move
        verbatim, so a restore is byte-exact."""
        return self._gather_blocks([block])

    def _tier_import_block(self, block: int, planes: list,
                           tokens) -> None:
        """One restored block back into the pools, in place."""
        self._scatter_blocks([block], planes)

    def _dispatch(self, plan: _StepPlan):
        """Queue one step; returns (out, step) without waiting for the
        device. ``out`` is the [slots] token recurrence, or the [slots,
        chunk] per-position tokens of a speculative step; ``step`` the
        step's events from the step clock (None on the CPU)."""
        def dev(a):
            return torch.from_numpy(a).to(self.device, non_blocking=True)

        with self._on_stream():
            st = (self._clock.start(self._stream)
                  if self._clock is not None else None)
            args = (self._kpool, self._kscale, self._vpool, self._vscale,
                    self._prev, dev(plan.host_tok), dev(plan.use_host),
                    dev(plan.ctx), dev(plan.n_new), dev(plan.tables))
            if st is not None:
                st.t_up = time.monotonic()
            if self.spec is not None and plan.roff is not None:
                (self._kpool, self._kscale, self._vpool, self._vscale,
                 out) = self._paged.tree_step(
                    *args, dev(plan.roff), dev(plan.n_app),
                    dev(plan.plim), dev(plan.win))
            else:
                (self._kpool, self._kscale, self._vpool, self._vscale,
                 out) = self._paged(*args)
            if self.spec is None:
                # out is the [slots] token recurrence the next
                # pipelined step may chain on device.
                self._prev = out
            elif self.pipelined:
                # Pipelined speculation: the NEXT window's base row
                # chains the TRUE bonus on the device, the trunk leaf's
                # per-position output (row n_app-1); rows with no work
                # keep their previous chain value. Sync speculation
                # never chains: every window is host-fed from the last
                # ACCEPTED token, so _prev stays the zeroed init.
                self._prev = self._paged.take_prev(
                    out, dev(plan.n_app), self._prev)
            if st is not None:
                self._clock.done(st, self._stream)
                self._clock.submitted(st)
        return out, st

    def _materialize(self, raw) -> np.ndarray:
        """The one place a step's tokens reach the host: wait for the
        step's event, then copy the ids."""
        out, st = raw
        if st is not None:
            self._clock.wait(st)
        return out.cpu().numpy()

    def _raw_clock(self, raw) -> Optional[StepClock]:
        st = raw[1]
        return self._clock.clock(st) if st is not None else None


class SyntheticKVExecutor(KVExecutorBase):
    """Jax-free KV replica: same allocator/lease/plan machinery, but
    the "device" is ``next = (31 * last_token + 7 * position + seed)
    % vocab`` (spec.synthetic_next_token) — deterministic AND
    position-dependent, so a resume that rewinds cursors wrong
    produces a visibly different stream. With ``pipelined=True``
    steps run FIFO on a worker thread with a dialable ``step_time_s``
    (the SyntheticExecutor overlap idiom); ``fault_site`` names the
    in-device chaos seam. ``spec=`` arms the draft/verify mode — the
    SpecConfig's draft is typically spec.OracleDraft, whose dialed
    acceptance rate is what the bench's controlled-speedup
    measurement turns; combined with ``pipelined=True``
    the executor plans window w+1 from window w's proposals while
    the worker thread still runs w — the overlap the pipelined-spec
    bench measures."""

    def __init__(self, slots: int = 4, vocab: int = 64,
                 block_size: int = 4, num_blocks: int = 128,
                 max_blocks_per_req: int = 16, prefill_chunk: int = 8,
                 prefill_budget: Optional[int] = None,
                 prefix_cache: bool = True, step_time_s: float = 0.0,
                 token_time_s: float = 0.0,
                 seed: int = 0, pipelined: bool = True,
                 fault_site: Optional[str] = None,
                 spec: Optional[SpecConfig] = None,
                 host_tier_bytes: Optional[int] = None):
        super().__init__(slots, vocab=vocab, block_size=block_size,
                         num_blocks=num_blocks,
                         max_blocks_per_req=max_blocks_per_req,
                         prefill_chunk=prefill_chunk,
                         prefill_budget=prefill_budget,
                         prefix_cache=prefix_cache, pipelined=pipelined,
                         spec=spec, host_tier_bytes=host_tier_bytes)
        self.step_time_s = float(step_time_s)
        # Per-PLANNED-TOKEN cost on top of the fixed floor: the knob
        # that makes prefill REAL in the cost model — a step co-running
        # an 8-token prefill chunk costs base + 8*token_time_s, and
        # every decode token in that batch pays it. Zero (the default)
        # keeps the original fixed-cost behavior; the disagg bench turns it
        # on to measure the cross-replica isolation claim (a prefill
        # flood CANNOT inflate a dedicated decode replica's steps).
        self.token_time_s = float(token_time_s)
        self.seed = int(seed)
        self.fault_site = fault_site
        self._dev_prev = np.zeros((self.slots,), np.int32)
        self._prev_t1: Optional[float] = None  # the inline steps' last end
        self._worker = _GuardedWorker(
            "synthetic-kv-step", step_fn=self._device_step,
            reset_fn=self._zero_dev_prev)

    def _zero_dev_prev(self) -> None:
        self._dev_prev = np.zeros((self.slots,), np.int32)

    # -- the "device" ---------------------------------------------------------

    def _device_step(self, plan: _StepPlan) -> np.ndarray:
        if self.fault_site is not None:
            faults.fire(f"{self.fault_site}.step")
        cost = self.step_time_s
        if self.token_time_s:
            # Per-PLANNED-token cost covers draft positions too: a
            # verify step really is wider than a one-token step, and
            # the spec bench's per-step-cost decomposition leans on
            # exactly this physics.
            cost += self.token_time_s * int(np.sum(plan.n_new))
        if cost:
            time.sleep(cost)
        if self.spec is not None:
            # Per-position outputs, the verify contract: out[s, j] is
            # the target's next token after consuming input j at its
            # row position (ctx + roff[j]; roff == j for chain rows —
            # tree siblings share the first trunk position). The
            # synthetic recurrence is Markov on (input, position), so
            # the per-position form IS the one-token recurrence
            # applied at each fed position. Row 0 alone may
            # device-chain (a pipelined plan-ahead's base row takes
            # the in-flight window's true bonus); rows >= 1 are
            # always host-fed drafts/siblings. The chain value
            # carries the trunk LEAF's output (row n_app-1) — the
            # bonus the next plan-ahead window chains from.
            C = self.prefill_chunk
            out = np.full((self.slots, C), NO_TOKEN, np.int32)
            prev = self._dev_prev.copy()
            for s in range(self.slots):
                n = int(plan.n_new[s])
                for j in range(n):
                    if j == 0:
                        tok_in = (int(plan.host_tok[s, 0])
                                  if plan.use_host[s]
                                  else int(prev[s]))
                    else:
                        tok_in = int(plan.host_tok[s, j])
                    ro = (int(plan.roff[s, j])
                          if plan.roff is not None else j)
                    out[s, j] = synthetic_next_token(
                        tok_in, int(plan.ctx[s]) + ro, self.seed,
                        self.vocab)
                if n > 0:
                    na = (int(plan.n_app[s])
                          if plan.n_app is not None else n)
                    prev[s] = out[s, na - 1]
            # Whole-attribute publish (copy-update-swap), never an
            # in-place mutation of the shared array: reset() and the
            # worker thread race only against an atomic swap.
            self._dev_prev = prev
            return out
        out = np.zeros((self.slots,), np.int32)
        for s in range(self.slots):
            n = int(plan.n_new[s])
            if n <= 0:
                out[s] = self._dev_prev[s]
                continue
            if plan.use_host[s]:
                last_in = int(plan.host_tok[s, n - 1])
            else:
                last_in = int(self._dev_prev[s])
            last_pos = int(plan.ctx[s]) + n - 1
            out[s] = synthetic_next_token(last_in, last_pos,
                                          self.seed, self.vocab)
        self._dev_prev = out
        return out

    def _backend_reset(self) -> None:
        # _GuardedWorker.reset serializes behind queued steps and
        # re-raises worker-side failures (the supervisor's discipline, shared
        # with the row-plane SyntheticExecutor).
        if not self.pipelined or not self._worker.started:
            self._zero_dev_prev()
            return
        self._worker.reset()

    def _dispatch(self, plan: _StepPlan):
        t_start = time.monotonic()  # planned: the dispatch begins
        if not self.pipelined:
            # Inline on the submitting thread: each step has ended
            # before the next is submitted, so every step is starved.
            pending = _Pending()
            self._prev_t1 = _run_timed(pending, self._device_step, plan,
                                       self._prev_t1)
        else:
            pending = self._worker.submit(plan)
        pending.t_start = t_start
        return pending

    def _materialize(self, raw) -> np.ndarray:
        if self.pipelined:
            raw.event.wait()
            if raw.error is not None:
                raise raw.error
        raw.t_waited = time.monotonic()
        return raw.tokens

    def _raw_clock(self, raw) -> Optional[StepClock]:
        return raw.clock()

    # -- cross-replica hand-off (the jax-free double) --------------------------

    def _spec_fields(self) -> dict:
        return dict(model="synthetic-kv", block_size=self.block_size,
                    heads=1, d_head=1, vocab=self.vocab,
                    max_blocks_per_req=self.max_blocks_per_req,
                    pool_dtype="fp32", planes=1, seed=self.seed)

    def _page_content(self, prompt, settled, n_tokens: int
                      ) -> np.ndarray:
        """The synthetic plane's KV truth for positions
        [0, n_tokens): position p's "KV" is the token the step that
        wrote it CONSUMED — prompt[p] through prefill, then the
        settled stream shifted by one (position plen+j holds
        settled[j], the previous emit fed back as input). Computable
        host-side from the request alone on BOTH ends, which turns
        the synthetic import into a true end-to-end transport
        integrity check: the importer recomputes and compares."""
        plen = len(prompt)
        vals = [float(prompt[p]) if p < plen
                else float(settled[p - plen])
                for p in range(int(n_tokens))]
        n_blocks = -(-int(n_tokens) // self.block_size)
        arr = np.zeros((n_blocks, self.block_size, 1, 1), np.float32)
        if vals:
            arr.reshape(-1)[:len(vals)] = vals
        return arr

    def _export_pages(self, blocks, req, n_tokens: int) -> list:
        content = self._page_content(req.prompt_tokens, req.tokens,
                                     n_tokens)
        return [(content, np.ones((content.shape[0],), np.float32))]

    def _import_pages(self, blocks, planes: list, meta: dict) -> None:
        """Verify, don't store: the synthetic recurrence is position-
        only, so the pool content is the TRANSPORT'S correctness
        proof, not decode state. Exact even through the int8 wire:
        token values are small ints (< vocab <= 127/scale margin), so
        scale/2 rounding error < 0.5 and rint recovers them."""
        (payload, _scales), = planes
        expect = self._page_content(meta["prompt_tokens"],
                                    meta["settled"], meta["tokens"])
        got = np.rint(np.asarray(payload, np.float32))
        if not np.array_equal(got, np.rint(expect)):
            raise ValueError(
                f"transferred page content diverges for request "
                f"{meta.get('req')} (transport corruption)")

    def _chunk_content(self, tokens) -> np.ndarray:
        """One cached prefix block's synthetic "KV": prefill position
        p consumed prompt[p], and a prefix-tree block covers prompt
        positions only — so the block's content IS its chunk's token
        ids (the _page_content rule restricted to one block)."""
        arr = np.zeros((1, self.block_size, 1, 1), np.float32)
        vals = [float(t) for t in tokens]
        arr.reshape(-1)[:len(vals)] = vals
        return arr

    def _tier_export_block(self, block: int, tokens) -> list:
        content = self._chunk_content(tokens)
        return [(content, np.ones((1,), np.float32))]

    def _tier_import_block(self, block: int, planes: list,
                           tokens) -> None:
        """Verify, don't store (the _import_pages idiom): restored
        content must equal the chunk the chain says this block holds —
        a corrupted host payload surfaces HERE, and the caller
        degrades to re-prefill."""
        (payload, _scales), = planes
        expect = self._chunk_content(tokens)
        got = np.rint(np.asarray(payload, np.float32))
        if not np.array_equal(got, np.rint(expect)):
            raise ValueError(
                "restored page content diverges (tier corruption)")

    def close(self) -> None:
        self._worker.close()
