"""Speculative decoding: the draft-model contract and acceptance math.

Speculation makes tokens-per-step the throughput lever: a cheap DRAFT
model proposes ``k`` tokens per decode slot, the target model verifies
all ``k + 1`` positions in ONE batched step (the chunked-prefill plan
machinery re-used: ``host_tok[s, :k+1]``, ``n_new[s] = k+1``), and
greedy argmax verification accepts the longest prefix on which the
draft matched the target — plus the target's one bonus token, so every
verify step emits at least the token the one-token baseline would
have.

The verify recurrence, 0-indexed over one slot's step window:

  * inputs fed:   ``[last, d_1, .., d_k]`` at positions
    ``ctx .. ctx+k`` (``last`` = the slot's last settled token);
  * target out:   ``t_j`` = the target's argmax after consuming input
    ``j`` (per-position logits — the speculative kernel change);
  * acceptance:   ``t_0`` always (it equals exactly the non-spec
    step's emit); ``t_j`` for ``j >= 1`` iff ``d_j == t_{j-1}`` and
    every earlier draft matched — i.e. ``a = accept_length(draft,
    target)`` leading matches accept ``t_0 .. t_a``: ``a + 1`` tokens.

Rejection is a WATERMARK TRUNCATION, not a device unwind: the plan
advanced ``st.ctx`` by ``k + 1`` assuming full acceptance, and collect
rolls it back to ``plan_ctx + a + 1`` while the collect-confirmed
watermark (built precisely so uncollected positions can never
poison the prefix cache) advances only to the accepted extent. KV
written at rejected positions is dead bytes the next append
overwrites — K/V at a position depends only on that position's input
embedding, so the re-append after a rollback writes exactly what an
unspeculated run would have.

This module is the jax-free plane of the contract (numpy only — the
scheduler imports it): the sentinel + emit-masking idiom shared by
both collect paths, the acceptance math, the bookkeeping, and the two
shipped drafts. ``TruncatedDraft`` imports torch in its methods
only.

Draft contract
--------------

``draft.propose(last[S] int32, ctx[S] int32) -> [S, k] int32`` —
called ONCE per planned step with fixed-shape full-slot arrays (rows
for slots not in decode regime carry zeros and are ignored), so a
jitted draft AOT-compiles one executable. ``k`` is fixed at draft
construction and must satisfy ``k + 1 <= prefill_chunk`` (the verify
window rides the prefill chunk's compiled width). Draft proposals
chain on the draft's OWN tokens (after a mispredict the tail is dead
anyway — it can never be accepted past the first mismatch).

Tree and pipelined speculation widen the contract two ways, both
optional:

* PIPELINED plan-ahead needs one proposal PAST the chain —
  ``propose_full`` wraps any chain draft and returns ``[S, k+1]``
  (two fixed-shape propose calls), so the planner can seed window
  ``w+1`` from window ``w``'s own predicted bonus token while the
  device still verifies window ``w``.
* TREE drafts branch at the FIRST draft position (where acceptance
  entropy concentrates — the Medusa/SpecInfer observation):
  ``draft.tree_width = W >= 2`` plus
  ``draft.propose_sibs(last[S], ctx[S]) -> [S, W-1] int32`` —
  alternative candidates for the trunk's first proposal. The verify
  window scores trunk AND siblings in one batched step under a
  tree-causal mask; ``accept_tree`` picks the longest matching
  root-to-leaf path (trunk wins ties), still exact greedy prefix
  match.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

#: collect() sentinel for "no token emitted at this position" — ONE
#: definition shared by the one-token collect path
#: (kvcache/executor.py), the speculative collect path, and the
#: scheduler's retire, so the two collect paths cannot drift.
NO_TOKEN = -1


def token_run(row) -> List[int]:
    """The per-slot emit-masking idiom, hoisted (a cleanup):
    the emitted-token run of one collect row — the leading prefix of
    valid (``>= 0``) tokens, stopped at the first NO_TOKEN pad. Both
    collect shapes normalize through it: a scalar/0-d entry is a run
    of length <= 1, a speculative row is the accepted run."""
    arr = np.atleast_1d(np.asarray(row))
    out: List[int] = []
    for t in arr:
        if int(t) < 0:
            break
        out.append(int(t))
    return out


def accept_length(draft, target) -> int:
    """Greedy-verify acceptance: the number ``a`` of leading draft
    positions where ``draft[j] == target[j]`` — the target tokens
    ``target[:a + 1]`` (matches plus the bonus) are the step's
    accepted run. Deterministic: greedy argmax on both sides means no
    sampling correction is needed (the Leviathan/Chen rejection-
    sampling machinery degenerates to exact prefix match)."""
    draft = np.asarray(draft).reshape(-1)
    target = np.asarray(target).reshape(-1)
    a = 0
    while a < len(draft) and a < len(target) \
            and int(draft[a]) == int(target[a]):
        a += 1
    return a


def synthetic_next_token(tok: int, pos: int, seed: int,
                         vocab: int) -> int:
    """The synthetic token plane's target recurrence — ONE definition
    shared by SyntheticKVExecutor's device and the OracleDraft that
    predicts it, so the oracle can never drift from the model it
    drafts for."""
    return (31 * int(tok) + 7 * int(pos) + int(seed)) % int(vocab)


class SpecStats:
    """Acceptance bookkeeping, mutated ONLY under the executor's
    collect owner-guard (proposed at plan time is the one exception —
    a proposal exists whether or not its step survives, and a stale
    step's proposals correctly depress the measured rate)."""

    __slots__ = ("proposed", "accepted", "runs", "replans",
                 "path_len", "pipeline_peak")

    def __init__(self):
        self.proposed = 0   # draft tokens fed to verify steps
        self.accepted = 0   # draft tokens the target confirmed
        self.runs = 0       # verify steps collected
        self.replans = 0    # plan-ahead windows invalidated by a
        #                     rollback (collected as epoch-stale no-ops)
        self.path_len: dict = {}  # accepted path length -> count
        #                     (root-to-leaf tokens settled per run)
        self.pipeline_peak = 0  # max spec windows in flight at once

    def record_run(self, accepted: int, path_len: int) -> None:
        """One collected verify step: ``accepted`` draft tokens
        confirmed, ``path_len`` tokens settled (accepted + bonus, or
        the sibling path's 2)."""
        self.runs += 1
        self.accepted += int(accepted)
        n = int(path_len)
        self.path_len[n] = self.path_len.get(n, 0) + 1

    def accept_rate(self) -> float:
        """Accepted fraction of proposed draft tokens (positions after
        a run's first mismatch count as rejected — this is the
        REALIZED rate, which is what the speedup math depends on, not
        the per-position oracle rate)."""
        return self.accepted / self.proposed if self.proposed else 0.0

    def tokens_per_step(self) -> float:
        """Emitted tokens per verify step: accepted drafts + the bonus
        token every step carries. 1.0 = the one-token baseline."""
        return ((self.accepted + self.runs) / self.runs
                if self.runs else 0.0)


class SpecConfig:
    """One executor's speculative-decoding configuration: the draft,
    the per-slot proposal depth ``k``, the tree width, the adaptive
    dial, and the acceptance stats. The executor validates
    ``k + 1 <= prefill_chunk`` (the verify window is the compiled
    chunk width). The config no longer forces the sync
    loop shape: a pipelined executor drafts window ``w+1`` from window
    ``w``'s PROPOSED tokens (provisional ctx, the same provisional-
    advance discipline the plan already uses) and a mis-speculation is
    the existing watermark rollback plus a re-plan.

    ``adaptive=True`` turns on the per-slot accept-rate EWMA dial: a
    slot whose realized rate decays stops paying full draft depth
    (``k`` shrinks toward ``k_min`` through ``clamp_spec_k``) and a
    hot slot climbs back; tree width drops to 1 while the trunk is
    hot (siblings only pay when the first position misses)."""

    def __init__(self, draft, k: int, tree_width: Optional[int] = None,
                 adaptive: bool = False, k_min: int = 1,
                 ewma_alpha: float = 0.3):
        if k < 1:
            raise ValueError(f"spec k must be >= 1, got {k}")
        draft_k = getattr(draft, "k", None)
        if draft_k is not None and int(draft_k) != int(k):
            raise ValueError(
                f"draft proposes k={draft_k} tokens but the config "
                f"asks for k={k}")
        if tree_width is None:
            tree_width = int(getattr(draft, "tree_width", 1) or 1)
        if tree_width < 1:
            raise ValueError(
                f"tree_width must be >= 1, got {tree_width}")
        if tree_width > 1 and not hasattr(draft, "propose_sibs"):
            raise ValueError(
                "tree_width > 1 needs a draft with propose_sibs()")
        if not 1 <= int(k_min) <= int(k):
            raise ValueError(
                f"k_min must be in [1, k={k}], got {k_min}")
        if not 0.0 < float(ewma_alpha) <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.draft = draft
        self.k = int(k)
        self.tree_width = int(tree_width)
        self.adaptive = bool(adaptive)
        self.k_min = int(k_min)
        self.ewma_alpha = float(ewma_alpha)
        self.stats = SpecStats()

    def k_for(self, ewma: float) -> int:
        """The adaptive dial: map a slot's accept-rate EWMA onto a
        draft depth in ``[k_min, k]`` (linear — the EWMA is already
        the realized fraction of drafts that paid off). Inert when
        ``adaptive=False``."""
        if not self.adaptive:
            return self.k
        r = min(1.0, max(0.0, float(ewma)))
        return self.k_min + int(round(r * (self.k - self.k_min)))

    def width_for(self, ewma: float) -> int:
        """Adaptive tree width: siblings only earn tokens when the
        trunk's FIRST position misses, so a hot slot (EWMA >= 0.9)
        drops back to a pure chain and stops paying the sibling
        verify rows."""
        if self.tree_width <= 1:
            return 1
        if self.adaptive and float(ewma) >= 0.9:
            return 1
        return self.tree_width


class OracleDraft:
    """Controlled-acceptance draft for the synthetic token plane: it
    KNOWS the target recurrence (synthetic_next_token) and corrupts
    each proposal with a deterministic hash of (token, position) so
    the per-position hit rate is ``accept_rate`` — the dial the bench
    and the equivalence tests turn. Pure function of (last, ctx):
    byte-identical streams across runs, loop shapes, and resumes."""

    def __init__(self, k: int, accept_rate: float = 0.7,
                 vocab: int = 64, target_seed: int = 0,
                 seed: int = 0, tree_width: int = 1,
                 sib_rate: float = 0.5):
        if not 0.0 <= accept_rate <= 1.0:
            raise ValueError(f"accept_rate must be in [0, 1], got "
                             f"{accept_rate}")
        if tree_width < 1:
            raise ValueError(f"tree_width must be >= 1, got "
                             f"{tree_width}")
        if not 0.0 <= sib_rate <= 1.0:
            raise ValueError(f"sib_rate must be in [0, 1], got "
                             f"{sib_rate}")
        self.k = int(k)
        self.accept_rate = float(accept_rate)
        self.vocab = int(vocab)
        self.target_seed = int(target_seed)
        self.seed = int(seed)
        self.tree_width = int(tree_width)
        self.sib_rate = float(sib_rate)  # P(some sibling recovers a
        #                                  trunk first-position miss)

    def _hit(self, tok: int, pos: int) -> bool:
        # LCG-style mix: deterministic, position- and token-sensitive,
        # cheap. The 23-bit hash compares against a threshold in the
        # SAME domain (no modulo fold — a `% 1e6` over 2^23 residues
        # would bias mid rates by ~1.4 points), so the per-position
        # rate is accept_rate to within 2^-23 and 0.0/1.0 are exact.
        h = (1103515245 * (tok * 131 + pos * 7919 + self.seed)
             + 12345) & 0x7FFFFFFF
        return (h >> 8) < int(round(self.accept_rate * (1 << 23)))

    def propose(self, last, ctx) -> np.ndarray:
        last = np.asarray(last, np.int64)
        ctx = np.asarray(ctx, np.int64)
        out = np.zeros((len(last), self.k), np.int32)
        for s in range(len(last)):
            t = int(last[s])
            for j in range(self.k):
                pos = int(ctx[s]) + j
                nxt = synthetic_next_token(t, pos, self.target_seed,
                                           self.vocab)
                if not self._hit(t, pos):
                    nxt = (nxt + 1) % self.vocab  # deliberate miss
                out[s, j] = nxt
                t = nxt  # chain on own proposal (dead past a miss)
        return out

    def _sib_hit(self, tok: int, pos: int) -> bool:
        # Second, independent mix (different multiplier/increment)
        # dialing the SIBLING recovery rate: given the trunk missed
        # at the first position, does some sibling carry the true
        # token? Independence from _hit keeps the two dials
        # orthogonal in the equivalence matrix.
        h = (1664525 * (tok * 131 + pos * 7919 + self.seed + 17)
             + 1013904223) & 0x7FFFFFFF
        return (h >> 8) < int(round(self.sib_rate * (1 << 23)))

    def propose_sibs(self, last, ctx) -> np.ndarray:
        """Alternative candidates for the FIRST draft position (the
        tree's branch point). Pure function of (last, ctx) like
        propose, so the plan-ahead / resume determinism arguments
        carry over. When the trunk's first proposal missed and the
        sib hash fires, sibling 0 carries the TRUE next token —
        the dial the tree-path tests and bench turn; the remaining
        siblings are deliberate distinct misses."""
        last = np.asarray(last, np.int64)
        ctx = np.asarray(ctx, np.int64)
        w = self.tree_width - 1
        out = np.zeros((len(last), max(w, 0)), np.int32)
        for s in range(len(last)):
            t = int(last[s])
            pos = int(ctx[s])
            true = synthetic_next_token(t, pos, self.target_seed,
                                        self.vocab)
            trunk_hit = self._hit(t, pos)
            recover = (not trunk_hit) and self._sib_hit(t, pos)
            for i in range(w):
                if i == 0 and recover:
                    out[s, i] = true
                else:
                    # distinct from the trunk's proposal AND the true
                    # token, so a non-recovering sibling never
                    # matches by accident
                    out[s, i] = (true + 2 + i) % self.vocab
        return out


class TruncatedDraft:
    """The serving step's cheap draft: a TRUNCATED-STAGE variant of the
    target PagedDecodeStep — the SAME embed/positional/output weights
    with the attention and MLP stages cut, so the draft is
    attention-free (no KV, no block tables, no gather) and one call
    proposes all k tokens for every slot:

        x_j = embed[t_j] + wpos[pos_j];  t_{j+1} = argmax(x_j @ wout)

    Acceptance against the full target is whatever the truncation
    earns — correctness never depends on it (a 0%-accept draft still
    yields byte-identical streams at one bonus token per step); the
    CONTROLLED-rate measurements use OracleDraft on the synthetic plane
    instead.

    The weights are tensors on the step's device, read only. On a CUDA
    device the draft runs on a stream of its own: its proposals end in
    a copy to the host, which on the executor's stream would wait for
    the verify window in flight and serialize pipelined speculation.
    ``argmax`` takes the first maximum and the sibling ranks come from
    a stable descending sort, so ties break toward the lower index on
    both."""

    def __init__(self, embed, wpos, wout, k: int, slots: int,
                 tree_width: int = 1):
        import torch

        self.k = int(k)
        self.tree_width = int(tree_width)
        self.embed, self.wpos, self.wout = embed, wpos, wout
        self.device = embed.device
        self._T = int(wpos.shape[0])
        self._stream = None
        if self.device.type == "cuda":
            # The weights may still be in flight on the stream that
            # made them: the draft's stream starts after it.
            self._stream = torch.cuda.Stream(device=self.device)
            self._stream.wait_stream(
                torch.cuda.current_stream(self.device))

    @classmethod
    def from_paged(cls, paged_step, k: int,
                   tree_width: int = 1) -> "TruncatedDraft":
        """Build from a kvcache/paged.PagedDecodeStep — the weights are
        the step's own buffers, so draft and target can never disagree
        on the token space."""
        embed, wpos, wout = paged_step.draft_params
        return cls(embed, wpos, wout, k, paged_step.slots,
                   tree_width=tree_width)

    def _run(self, fn, last, ctx) -> np.ndarray:
        import contextlib

        import torch

        ctxm = (torch.cuda.stream(self._stream) if self._stream
                is not None else contextlib.nullcontext())
        with ctxm:
            t = torch.from_numpy(np.asarray(last, np.int64)).to(
                self.device)
            c = torch.from_numpy(np.asarray(ctx, np.int64)).to(
                self.device)
            out = fn(t, c)
            return out.to(torch.int32).cpu().numpy()

    def propose(self, last, ctx) -> np.ndarray:
        import torch

        def chain(t, c):
            cols = []
            for j in range(self.k):
                pos = torch.clamp(c + j, 0, self._T - 1)
                x = self.embed[t] + self.wpos[pos]
                t = torch.argmax(x @ self.wout, dim=-1)
                cols.append(t)
            return torch.stack(cols, dim=1)

        return self._run(chain, last, ctx)

    def propose_sibs(self, last, ctx) -> np.ndarray:
        import torch

        W = self.tree_width
        if W <= 1:
            return np.zeros((len(np.asarray(last)), 0), np.int32)

        def sibs(t, c):
            # ranks 2..W of the first-position logits: the trunk
            # already carries rank 1, so siblings are the next most
            # probable alternatives at the branch point
            pos = torch.clamp(c, 0, self._T - 1)
            x = self.embed[t] + self.wpos[pos]
            _, idx = torch.sort(x @ self.wout, dim=-1, descending=True,
                                stable=True)
            return idx[:, 1:W]

        return self._run(sibs, last, ctx)


def propose_full(draft, last, ctx) -> np.ndarray:
    """``[S, k+1]`` proposals: the draft's k-chain PLUS one more
    chained step — the draft's own prediction of the verify window's
    BONUS token. The pipelined planner needs it to seed window
    ``w+1`` before window ``w``'s true bonus exists: under full
    acceptance the window settles ``[d_1 .. d_k, t_k]`` and every
    token except ``t_k`` is host-known, so the plan-ahead drafts from
    the PREDICTED ``t_k`` (= column ``ks`` here) while the device row
    chains the true one. Two fixed-shape propose calls, so a jitted
    draft stays AOT: column j of propose(last, ctx) is the draft's
    prediction for the target's output at position ``ctx + j``, and
    re-seeding at ``(p_k, ctx + k)`` continues the SAME chain.

    A draft may fuse the two calls by exposing its own
    ``propose_full(last, ctx) -> [S, k+1]`` (one batched invocation —
    what a real draft model does; also what lets a cost-modelled
    draft charge ONE window latency instead of two)."""
    fused = getattr(draft, "propose_full", None)
    if fused is not None:
        out = np.asarray(fused(last, ctx), np.int32)
        if out.shape[1] != draft.k + 1:
            raise ValueError(
                f"draft.propose_full returned width {out.shape[1]}, "
                f"wanted k+1 = {draft.k + 1}")
        return out
    p = np.asarray(draft.propose(last, ctx), np.int32)
    ctx = np.asarray(ctx, np.int64)
    q = np.asarray(draft.propose(p[:, -1], ctx + draft.k), np.int32)
    return np.concatenate([p, q[:, :1]], axis=1)


def accept_tree(drafts, sibs, target_trunk, target_sibs):
    """Longest matching root-to-leaf path through the verify window's
    token tree — still exact greedy prefix match, per branch.

    ``drafts[ks]`` = trunk proposals, ``sibs[w]`` = first-position
    siblings, ``target_trunk[ks+1]`` = target outputs of the base +
    trunk rows (``t_0 .. t_ks``), ``target_sibs[w]`` = target outputs
    of the sibling rows. Returns ``(run, sib_idx)``: the settled
    token run and which sibling won (-1 = trunk path). The trunk
    wins ties — its tokens are already APPENDED at their positions,
    so equal-length paths prefer the one needing no repair. A sibling
    path only beats the trunk when the trunk's FIRST position missed
    (trunk path length 1) and a sibling carries the true ``t_0``:
    then the sibling row's output is the target's next token after
    it — 2 tokens instead of 1."""
    a = accept_length(drafts, target_trunk)
    tt = np.atleast_1d(np.asarray(target_trunk))
    if a == 0 and len(np.atleast_1d(np.asarray(sibs))):
        t0 = int(tt[0])
        ts = np.atleast_1d(np.asarray(target_sibs))
        for i, sb in enumerate(np.atleast_1d(np.asarray(sibs))):
            if int(sb) == t0:
                return [t0, int(ts[i])], int(i)
    return [int(t) for t in tt[:a + 1]], -1


def clamp_spec_k(k: int, ctx: int, max_total: int, chunk: int) -> int:
    """Per-slot draft depth under the page-reservation bound. With
    ``r = max_total - ctx - 1`` tokens still owed (``max_total =
    plen + max_tokens``), drafting beyond ``r - 1`` can only propose
    tokens past the request's budget — and, critically, would append
    KV past the worst-case pages reserved at admission (the plan's
    clipped table gather would silently scatter into table entry
    B-1's block — another slot era's data). Clamped, the maximum
    position a verify step writes equals the one-token loop's
    maximum, so ADMISSION MATH IS UNCHANGED: no extra slack pages,
    no new OOM class. Also bounded by the compiled chunk width
    (``k + 1 <= chunk``)."""
    owed = int(max_total) - int(ctx) - 1
    return max(0, min(int(k), owed - 1, int(chunk) - 1))


__all__ = [
    "NO_TOKEN",
    "OracleDraft",
    "SpecConfig",
    "SpecStats",
    "TruncatedDraft",
    "accept_length",
    "accept_tree",
    "clamp_spec_k",
    "propose_full",
    "synthetic_next_token",
    "token_run",
]
